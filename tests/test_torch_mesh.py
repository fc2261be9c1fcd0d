"""The (data, model) mesh over 2 and 4 gloo ranks on the CPU, against the JAX
package's mesh steps on the same mesh shape and against the port's
one-process steps.

Each rank is a process of this file run as a script (`_rank_main`), brought
up on a `file://` store under the test's tmp dir; ranks 0 write what they
gathered to a pickle.  The model is criteo-kaggle/autoctr's best arch at 7
blocks over 963 rows (37 a slot, 38 in the last: odd, so model = 2 pads one
row), batch 16, 3 steps, JAX's weights transplanted, learning rates at which
this unnormalised arch does not blow up in 3 steps.  Cases: the sparse mesh
step (Adagrad) with the clip at 5.0, with no clip (a table gradient scaled by
the model size, as a summing backward of the lookup would give, fails it),
with microbatch = 2; the dense mesh step (Adam) with the clip and without.
World 2 is (data 1, model 2), world 4 (data 2, model 2); JAX's meshes are
`make_mesh(model=2, devices=jax.devices()[:world])`.

Tolerance: losses 1e-5 relative; parameters, the table and every optimizer
slot 1e-4, absolute and relative (f32 sums in another order across ranks; an
Adam element whose gradient is at rounding level moves by up to the learning
rate either way).  World 2
also runs: the sharded checkpoint (loaded by both packages), the supernet
workload over the mesh against one process, the search's fan-out against one
process, and the multi-process refusals.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
VOCAB = (37,) * 25 + (38,)
ROWS = sum(VOCAB)
BATCH, STEPS = 16, 3
CASES = {                           # optimizer, clip, microbatch, lr
    "sparse": ("adagrad", 5.0, 1, 3e-3),
    "sparse-noclip": ("adagrad", None, 1, 3e-3),
    "sparse-micro2": ("adagrad", 5.0, 2, 3e-3),
    "dense-adam": ("adam", 5.0, 1, 3e-4),
    "dense-adam-noclip": ("adam", None, 1, 3e-4),
}
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
WORLDS = (2, 4)


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(BATCH, 13).astype(np.float32),
             np.stack([rng.randint(0, v, size=BATCH) for v in VOCAB], 1).astype(np.int32),
             rng.randint(0, 2, size=(BATCH, 1)).astype(np.float32)) for _ in range(STEPS)]


def _port_plan():
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.configs import get_best_arch
    from nasrec_tpu_torch.models.fixed import build_fixed_plan

    return build_fixed_plan(get_best_arch("criteo-kaggle", "autoctr"), OPS_CONFIG_LIB["autoctr"],
                            7, 13, 26, VOCAB)


def _port_model(params_np):
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.models.transplant import from_jax_params

    plan = _port_plan()
    model = fixed_init(plan, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params_np, plan))
    return model


def _port_steps(case, params_np, mesh=None):
    """Run a case's steps in the port: over `mesh` (this rank's rows of each
    batch) or in one process.  Returns (losses, state)."""
    from nasrec_tpu_torch.parallel.sparse import make_parallel_sparse_train_step
    from nasrec_tpu_torch.parallel.train import make_parallel_train_step, shard_train_state
    from nasrec_tpu_torch.train.loop import init_train_state, make_train_step
    from nasrec_tpu_torch.train.optim import make_optimizer
    from nasrec_tpu_torch.train.sparse_embedding import make_sparse_embedding_train_step

    name, clip, micro, lr = CASES[case]
    sched = lambda s: lr
    model = _port_model(params_np)
    opt = make_optimizer(name)
    state = init_train_state(model, opt)
    sparse = case.startswith("sparse")
    if mesh is None:
        step = (make_sparse_embedding_train_step(sched, grad_clip=clip, microbatch=micro)
                if sparse else make_train_step(opt, sched, grad_clip=clip))
    else:
        state = shard_train_state(state, mesh)
        step = (make_parallel_sparse_train_step(sched, mesh, grad_clip=clip, microbatch=micro)
                if sparse else make_parallel_train_step(opt, sched, mesh, grad_clip=clip))
    losses = []
    for d, c, y in _batches():
        if mesh is not None:
            per = BATCH // mesh.data
            rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
            d, c, y = d[rows], c[rows], y[rows]
        state, m = step(state, torch.from_numpy(d), torch.from_numpy(c), torch.from_numpy(y))
        losses.append(float(m["loss"]))
    return losses, state


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------


def _rank_lookup(mesh):
    """Sharded lookup and its table gradient on a random table."""
    from nasrec_tpu_torch.parallel.embedding import (
        pad_table_for_sharding,
        shard_rows,
        sharded_lookup,
    )

    gen = torch.Generator().manual_seed(1)
    table = torch.randn(ROWS, 16, generator=gen)
    idx = torch.randint(0, ROWS, (8, 26), generator=gen, dtype=torch.int32)
    local = shard_rows(pad_table_for_sharding(table, mesh.model), mesh).requires_grad_(True)
    stem = sharded_lookup(local, idx, mesh)
    torch.sum(stem * stem).backward()
    return {"table": table.numpy(), "idx": idx.numpy(), "stem": stem.detach().numpy(),
            "grad": mesh.gather_rows(local.grad)[:ROWS].numpy()}


def _rank_world2_extras(workdir, params_np, mesh):
    """The checks only world 2 runs; returns what rank 0 reports."""
    from nasrec_tpu_torch.parallel.distributed import save_sharded_checkpoint
    from nasrec_tpu_torch.search.evolution import SearchConfig, Searcher
    from nasrec_tpu_torch.search.tokenizer import Tokenizer
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.workloads import train_fixed_subnet

    out = {}
    losses, state = _port_steps("sparse", params_np, mesh)
    save_sharded_checkpoint(str(workdir / "sharded"), state, mesh, extra={"case": "sparse"})
    out["sharded_table"] = mesh.gather_rows(state.model.embedding.table.detach()).numpy()
    out["sharded_acc"] = mesh.gather_rows(state.opt_state["embedding.table"]).numpy()

    # Both ranks share one logging dir: rank 0 alone writes to it.
    sn = _supernet_run(mesh_model=2, logging_dir=str(workdir / "logs"))
    out["supernet_logs"] = sn["logs"][0]

    searcher = Searcher(_fake_eval, Tokenizer(3, OPS_CONFIG_LIB["autoctr"], seed=3),
                        SearchConfig(group_size=2, seed=3, distribute=True), log_fn=lambda s: None)
    out["search"] = searcher.regularized_evolution_from_supernet(
        n_generations=2, n_childs=2, init_population=6, sample_size=2, top_k=1)
    out["search_all"] = searcher.all_results
    out["search_evaluated"] = _fake_eval.calls

    refusals = {}
    for what, kw in (("no_mesh", {}), ("orbax", dict(mesh_model=2, ckpt_backend="orbax"))):
        try:
            train_fixed_subnet({**_autoctr_choice(), "config": "autoctr", "num_blocks": 7},
                               _tiny_data(), _tiny_train(**kw), log_fn=lambda s: None)
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    out["refusals"] = refusals
    return out


def _autoctr_choice():
    from nasrec_tpu_torch.configs import get_best_arch

    return get_best_arch("criteo-kaggle", "autoctr")


def _tiny_data():
    from nasrec_tpu_torch.workloads import DataOptions

    return DataOptions(data_source="synthetic", train_batch_size=32, test_batch_size=64,
                       synthetic_train_examples=256, synthetic_test_examples=128,
                       synthetic_vocab=50)


def _tiny_train(**kw):
    from nasrec_tpu_torch.workloads import TrainOptions

    return TrainOptions(learning_rate=0.05, display_interval=1, test_interval=3,
                        max_train_steps=3, max_eval_steps=1, device="cpu", **kw)


def _supernet_run(**kw):
    from nasrec_tpu_torch.workloads import SupernetOptions, train_supernet

    sn = SupernetOptions(config="autoctr", num_blocks=2, supernet_training_steps=2)
    return train_supernet(sn, _tiny_data(), _tiny_train(**kw), log_fn=lambda s: None)


def _fake_eval(choices):
    """Metrics from each choice's contents (the same in every process); no
    latency field, which the exchange carries as NaN."""
    out = []
    for c in choices:
        h = sum(len(str(v)) * (i + 1) for i, v in enumerate(c["micro"]))
        out.append({"choice": c, "test_loss": 0.4 + (h % 97) / 1000.0,
                    "test_acc": 0.5 + (h % 13) / 100.0, "test_auroc": 0.6 + (h % 7) / 100.0})
    _fake_eval.calls += len(choices)
    return out


_fake_eval.calls = 0


def _rank_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--workdir")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from nasrec_tpu_torch.parallel import distributed
    from nasrec_tpu_torch.parallel.mesh import make_mesh
    from nasrec_tpu_torch.workloads import _saved_state

    workdir = Path(args.workdir)
    distributed.start(f"file://{workdir / 'store'}", args.world, args.rank, "cpu")
    with open(workdir / "params.pkl", "rb") as f:
        params_np = pickle.load(f)
    mesh = make_mesh(model=2)
    out = {"mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index),
           "lookup": _rank_lookup(mesh), "cases": {},
           "fetched": distributed.fetch_pytree(
               {"x": torch.full((2, 3), float(mesh.data_index)),
                "l": [torch.arange(2) + 10 * mesh.data_index]}, mesh.data_group)}
    for case in CASES:
        losses, state = _port_steps(case, params_np, mesh)
        params, opt = _saved_state(state, ROWS, mesh)
        out["cases"][case] = {"losses": losses, "params": params, "opt": opt}
    if args.world == 2:
        out.update(_rank_world2_extras(workdir, params_np, mesh))
    if args.rank == 0:
        with open(workdir / "rank0.pkl", "wb") as f:
            pickle.dump(out, f)
    del mesh
    distributed.shutdown(barrier=True)


# ---------------------------------------------------------------------------
# The tests (the parent process: JAX and the port's one-process runs)
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_trees(got, want, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w))[:5])
    for k in w:
        gk, wk = g[k], w[k]
        if k.endswith("embedding.table") and wk.shape[0] != gk.shape[0]:
            wk = wk[:gk.shape[0]]          # the JAX mesh state keeps its pad rows
        np.testing.assert_allclose(gk, wk, err_msg=f"{what}: {k}", **TOL)


@pytest.fixture(scope="module")
def params_np():
    import jax

    from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
    from nasrec_tpu.configs import get_best_arch as jax_best_arch
    from nasrec_tpu.models import build_fixed_plan as jax_build_plan
    from nasrec_tpu.models import fixed_init as jax_fixed_init

    jplan = jax_build_plan(jax_best_arch("criteo-kaggle", "autoctr"), JAX_OPS["autoctr"], 7,
                           13, 26, VOCAB, attention_impl="xla")
    return jplan, jax.device_get(jax_fixed_init(jax.random.PRNGKey(0), jplan))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params_np):
    """Both worlds' ranks, started at once; {world: rank 0's pickle}."""
    _, params = params_np
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    procs, dirs = [], {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        with open(d / "params.pkl", "wb") as f:
            pickle.dump(params, f)
        dirs[world] = d
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world", str(world),
                 "--workdir", str(d)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
    results = {}
    for world, d in dirs.items():
        with open(d / "rank0.pkl", "rb") as f:
            results[world] = pickle.load(f)
        results[world]["dir"] = d
    return results


@pytest.fixture(scope="module")
def jax_runs(params_np):
    """JAX's mesh steps for each case on each world's mesh shape."""
    import jax
    import jax.numpy as jnp

    from nasrec_tpu.models import fixed_apply as jax_fixed_apply
    from nasrec_tpu.models.embedding import table_offsets as jax_offsets
    from nasrec_tpu.models.fixed import fixed_apply_embedded as jax_apply_embedded
    from nasrec_tpu.parallel import (
        make_mesh,
        make_parallel_sparse_train_step,
        make_parallel_train_step,
        make_sharded_stem_lookup,
        pad_table_for_sharding,
        shard_train_state,
    )
    from nasrec_tpu.train import make_optimizer
    from nasrec_tpu.train.loop import init_train_state

    jplan, params = params_np
    out = {}
    for world in WORLDS:
        mesh = make_mesh(model=2, devices=jax.devices()[:world])
        lookup = make_sharded_stem_lookup(mesh)
        for case, (name, clip, micro, lr) in CASES.items():
            opt = make_optimizer(name)
            sched = lambda s, lr=lr: jnp.asarray(lr)
            psh = dict(params)
            psh["embedding"] = pad_table_for_sharding(params["embedding"], 2)
            state = shard_train_state(init_train_state(psh, opt), mesh)
            if case.startswith("sparse"):
                step = make_parallel_sparse_train_step(
                    lambda p, d, s: jax_apply_embedded(jplan, p, d, s), opt, sched, mesh,
                    jax_offsets(VOCAB), grad_clip=clip, microbatch=micro, donate=False)
            else:
                step = make_parallel_train_step(
                    lambda p, d, c: jax_fixed_apply(jplan, p, d, c, stem_lookup=lookup),
                    opt, sched, mesh, grad_clip=clip, donate=False)
            losses = []
            for d, c, y in _batches():
                state, m = step(state, d, c, y)
                losses.append(float(m["loss"]))
            out[(world, case)] = (losses, jax.device_get(state.params),
                                  jax.device_get(state.opt_state))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_coordinates(ranks, world):
    assert ranks[world]["mesh"] == (world // 2, 2, 0, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_fetch_pytree_gathers_every_data_rank_in_order(ranks, world):
    got = ranks[world]["fetched"]
    data = world // 2
    np.testing.assert_array_equal(got["x"], np.repeat(np.arange(data, dtype=np.float32), 2)
                                  [:, None].repeat(3, 1))
    np.testing.assert_array_equal(got["l"][0], np.concatenate([np.arange(2) + 10 * d
                                                               for d in range(data)]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lookup_and_gradient_match_the_dense_lookup(ranks, world):
    lk = ranks[world]["lookup"]
    table = torch.from_numpy(lk["table"]).requires_grad_(True)
    stem = table.index_select(0, torch.from_numpy(lk["idx"]).long().reshape(-1))
    torch.sum(stem * stem).backward()
    np.testing.assert_array_equal(lk["stem"], stem.detach().numpy().reshape(8, -1))
    np.testing.assert_allclose(lk["grad"], table.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_step_matches_jax_mesh_step(ranks, jax_runs, world, case):
    got = ranks[world]["cases"][case]
    losses, jparams, jopt = jax_runs[(world, case)]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _assert_trees(got["params"], jparams, "params")
    _assert_trees(got["opt"], jopt, "optimizer state")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_step_matches_the_ports_one_process_step(ranks, params_np, world, case):
    from nasrec_tpu_torch.models.transplant import to_jax_opt_state, to_jax_params

    got = ranks[world]["cases"][case]
    losses, state = _port_steps(case, params_np[1])
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _assert_trees(got["params"], to_jax_params(state.model), "params")
    _assert_trees(got["opt"], to_jax_opt_state(state.model, state.opt_state),
                  "optimizer state")


def test_sharded_checkpoint_loads_in_both_packages(ranks):
    from nasrec_tpu.parallel.distributed import load_sharded_checkpoint as jax_load

    from nasrec_tpu_torch.parallel.distributed import load_sharded_checkpoint

    r = ranks[2]
    path = str(r["dir"] / "sharded")
    assert sorted(os.listdir(path)) == ["replicated.pkl", "table-shard-0.pkl",
                                       "table-shard-1.pkl"]
    want = r["cases"]["sparse"]
    for ck in (jax_load(path), load_sharded_checkpoint(path)):
        assert ck["step"] == STEPS and ck["extra"] == {"case": "sparse"}
        np.testing.assert_array_equal(ck["params"]["embedding"]["table"], r["sharded_table"])
        np.testing.assert_array_equal(ck["opt_state"]["embedding"]["table"], r["sharded_acc"])
        rest = {k: v for k, v in want["params"].items() if k != "embedding"}
        _assert_trees({k: v for k, v in ck["params"].items() if k != "embedding"}, rest,
                      "replicated params")


def test_jax_sharded_checkpoint_loads_in_the_port(tmp_path, params_np):
    import jax
    import jax.numpy as jnp

    from nasrec_tpu.models.embedding import table_offsets as jax_offsets
    from nasrec_tpu.models.fixed import fixed_apply_embedded as jax_apply_embedded
    from nasrec_tpu.parallel.distributed import save_sharded_checkpoint as jax_save
    from nasrec_tpu.train import make_optimizer
    from nasrec_tpu.train.loop import init_train_state
    from nasrec_tpu.train.sparse_embedding import make_sparse_embedding_train_step

    from nasrec_tpu_torch.parallel.distributed import load_sharded_checkpoint

    jplan, params = params_np
    opt = make_optimizer("adagrad")
    state = init_train_state(params, opt)
    step = make_sparse_embedding_train_step(
        lambda p, d, s: jax_apply_embedded(jplan, p, d, s), opt, lambda s: jnp.asarray(0.1),
        jax_offsets(VOCAB), donate=False)
    d, c, y = _batches()[0]
    state, _ = step(state, d, c, y)
    jax_save(str(tmp_path), state, extra={"from": "jax"})
    ck = load_sharded_checkpoint(str(tmp_path))
    assert ck["step"] == 1 and ck["extra"] == {"from": "jax"}
    _assert_trees(ck["params"], jax.device_get(state.params), "params")
    _assert_trees(ck["opt_state"], jax.device_get(state.opt_state), "accumulators")


def test_supernet_over_the_mesh_matches_one_process(ranks):
    torch.set_num_threads(2)
    got = ranks[2]["supernet_logs"]
    want = _supernet_run()["logs"][0]
    assert len(got["train_loss"]) == len(want["train_loss"]) == 3
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=LOSS_RTOL)


def test_one_rank_writes_the_shared_logging_dir(ranks):
    logs = ranks[2]["dir"] / "logs"
    with open(logs / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    keys = [(x["tag"], x["step"]) for x in lines]
    # 3 train steps shown (4 tags each) and 2 tests (3 tags each), once.
    assert len(keys) == len(set(keys)) == 3 * 4 + 2 * 3
    assert (logs / "supernet_checkpoint.pkl").exists()


def test_search_fanout_matches_one_process(ranks):
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.search.evolution import SearchConfig, Searcher
    from nasrec_tpu_torch.search.tokenizer import Tokenizer

    r = ranks[2]
    _fake_eval.calls = 0
    searcher = Searcher(_fake_eval, Tokenizer(3, OPS_CONFIG_LIB["autoctr"], seed=3),
                        SearchConfig(group_size=2, seed=3), log_fn=lambda s: None)
    history = searcher.regularized_evolution_from_supernet(
        n_generations=2, n_childs=2, init_population=6, sample_size=2, top_k=1)
    assert [h["choice"] for h in r["search"]] == [h["choice"] for h in history]
    assert [a["choice"] for a in r["search_all"]] == [a["choice"] for a in searcher.all_results]
    for a, b in zip(r["search_all"], searcher.all_results):
        assert "latency" not in a     # missing on every rank: NaN in the exchange
        for f in ("test_loss", "test_acc", "test_auroc"):
            assert a[f] == b[f]
    # Rank 0 evaluated its own groups only (the even-numbered ones): 2 of
    # the 3 initial groups and each generation's one group, 8 of 10.
    assert (r["search_evaluated"], _fake_eval.calls) == (8, 10)


@pytest.mark.parametrize("what,needle", [("no_mesh", "requires --mesh_model > 0"),
                                         ("orbax", "ckpt_backend='orbax' is not supported")])
def test_multi_process_refusals(ranks, what, needle):
    msg = ranks[2]["refusals"][what]
    assert msg is not None and needle in msg


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
