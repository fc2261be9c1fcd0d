"""Supernet training in the port against the JAX package: two masked
sparse-embedding train steps from transplanted weights; checkpoints written by
either package loaded by the other, for the supernet and for a fixed subnet;
and the port's `train_supernet` and `main_train` CLIs on the CPU, with their
logs, `metrics.jsonl`, checkpoints in the JAX package's layout, and resume.

Tolerance (f32): train steps rtol 1e-4 / atol 1e-5 on the losses, logits,
parameters, embedding table and Adagrad accumulators; logits through a loaded
checkpoint rtol 1e-4 / atol 1e-5.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu import choices as jax_choices
from nasrec_tpu import sampling as jax_sampling
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import build_fixed_plan as jax_build_plan
from nasrec_tpu.models import fixed_apply as jax_fixed_apply
from nasrec_tpu.models import fixed_init as jax_fixed_init
from nasrec_tpu.models.embedding import table_offsets as jax_table_offsets
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_apply as jax_supernet_apply
from nasrec_tpu.models.supernet import supernet_apply_embedded as jax_supernet_embedded
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.train import make_optimizer
from nasrec_tpu.train.checkpoint import load_any_checkpoint as jax_load_checkpoint
from nasrec_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from nasrec_tpu.train.loop import init_train_state
from nasrec_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from nasrec_tpu.train.sparse_embedding import (
    make_sparse_embedding_train_step as jax_sparse_step,
)

from nasrec_tpu_torch import choices
from nasrec_tpu_torch.cli import main_train, train_supernet
from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_apply, fixed_init
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_apply, supernet_init
from nasrec_tpu_torch.models.transplant import (
    from_jax_opt_state,
    from_jax_params,
    to_jax_opt_state,
    to_jax_params,
)
from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint, save_checkpoint
from nasrec_tpu_torch.train.optim import make_lr_schedule
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)
from nasrec_tpu_torch.workloads import DataOptions, SupernetOptions, TrainOptions
from nasrec_tpu_torch.workloads import train_supernet as train_supernet_fn

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def _supernet_cfgs(space, num_blocks, vocab, use_layernorm=True):
    kw = dict(num_blocks=num_blocks, num_dense=13, num_sparse=26, vocab_sizes=vocab,
              use_layernorm=use_layernorm)
    return (JaxSuperNetConfig(space=JAX_OPS[space], attention_impl="xla", **kw),
            SuperNetConfig(space=OPS_CONFIG_LIB[space], **kw))


def _batch(b, vocab, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 13).astype(np.float32),
            np.stack([rng.randint(0, v, size=b) for v in vocab], 1).astype(np.int32),
            rng.randint(0, 2, size=(b, 1)).astype(np.float32))


def _assert_state_matches(model, opt_state, jparams, jopt, spec):
    want_p = from_jax_params(jparams, spec)
    want_a = from_jax_opt_state(jopt, spec)
    got_p = model.state_dict()
    assert set(got_p) == set(want_p) == set(opt_state)
    for name in want_p:
        np.testing.assert_allclose(got_p[name].numpy(), want_p[name].numpy(),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(opt_state[name].numpy(), want_a[name].numpy(),
                                   err_msg=name, **TOL)


# clip 0.05: the clip scales every step.
@pytest.mark.parametrize("space,clip", [("xlarge", 5.0), ("xlarge-zeros", 0.05)])
def test_two_masked_sparse_steps_match_jax(space, clip):
    """Two steps with different sampled subnets; the second step's masks come
    as the mask buffer's (buffer, idx) pair."""
    vocab = (40,) * 26                                  # heavy duplicates
    jcfg, tcfg = _supernet_cfgs(space, 2, vocab)
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(5), jcfg))
    batches = [_batch(16, vocab, seed) for seed in (0, 1)]
    sampler = jax_sampling.ChoiceSampler(JAX_OPS[space], 2, strategy="any-path", seed=8)
    picks = [sampler(), sampler()]
    assert picks[0] != picks[1]

    opt = make_optimizer("adagrad")
    jstate = init_train_state(params, opt)
    jstep = jax_sparse_step(
        lambda p, d, s, m: jax_supernet_embedded(jcfg, p, d, s, m), opt,
        jax_lr_schedule("cosine", 0.12, 10, 1), jax_table_offsets(vocab),
        grad_clip=clip, has_masks=True, donate=False, table_update="scatter")
    for (d, c, y), choice in zip(batches, picks):
        jstate, jm = jstep(jstate, d, c, y,
                           jax_choices.choice_to_masks(choice, JAX_OPS[space], 2))

    model = supernet_init(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    tstate = init_sparse_train_state(model)
    tstep = make_sparse_embedding_train_step(make_lr_schedule("cosine", 0.12, 10, 1),
                                             grad_clip=clip, has_masks=True)
    stacked = choices.ChoiceMasks.stack(
        [choices.choice_to_masks(c, OPS_CONFIG_LIB[space], 2) for c in picks]).to("cpu")
    for k, (d, c, y) in enumerate(batches):
        masks = stacked.select(0) if k == 0 else (stacked, 1)
        tstate, tm = tstep(tstate, *(torch.from_numpy(x) for x in (d, c, y)), masks)

    assert tstate.step == int(jstate.step) == 2
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["logits"].numpy(), np.asarray(jm["logits"]), **TOL)
    _assert_state_matches(model, tstate.opt_state, jax.device_get(jstate.params),
                          jax.device_get(jstate.opt_state), tcfg)
    # The inverse transplant gives the JAX pytrees back.
    for got, want in ((to_jax_params(model), jstate.params),
                      (to_jax_opt_state(model, tstate.opt_state), jstate.opt_state)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)


def test_masked_step_needs_masks():
    _, tcfg = _supernet_cfgs("autoctr", 2, (10,) * 26)
    step = make_sparse_embedding_train_step(lambda s: 0.1, has_masks=True)
    state = init_sparse_train_state(supernet_init(tcfg, 0, "cpu"))
    with pytest.raises(ValueError, match="pass masks"):
        step(state, *(torch.from_numpy(x) for x in _batch(4, (10,) * 26)))


def test_jax_supernet_checkpoint_loads_into_the_port(tmp_path):
    vocab = (30,) * 26
    jcfg, tcfg = _supernet_cfgs("xlarge", 2, vocab)
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(6), jcfg))
    opt_state = jax.tree_util.tree_map(lambda x: np.full_like(x, 0.25), params)
    path = str(tmp_path / "supernet_checkpoint.pkl")
    jax_save_checkpoint(path, {"params": params, "opt_state": opt_state, "step": 7,
                               "supernet": {"config": "xlarge"}})

    ckpt = load_any_checkpoint(path)
    assert int(ckpt["step"]) == 7
    model = supernet_init(tcfg, seed=1, device="cpu")
    model.load_state_dict(from_jax_params(ckpt["params"], tcfg))
    acc = from_jax_opt_state(ckpt["opt_state"], tcfg)
    assert set(acc) == set(model.state_dict()) and all(bool((a == 0.25).all())
                                                        for a in acc.values())
    dense, cat, _ = _batch(8, vocab, seed=2)
    choice = jax_sampling.ChoiceSampler(JAX_OPS["xlarge"], 2, seed=3)()
    want = jax_supernet_apply(jcfg, params, dense, cat,
                              jax_choices.choice_to_masks(choice, JAX_OPS["xlarge"], 2))
    got = supernet_apply(model, torch.from_numpy(dense), torch.from_numpy(cat),
                         choices.choice_to_masks(choice, OPS_CONFIG_LIB["xlarge"], 2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _fixed_plans(vocab):
    space = "xlarge"
    jplan = jax_build_plan(jax_best_arch("criteo-kaggle", space), JAX_OPS[space],
                           7, 13, 26, vocab)
    tplan = build_fixed_plan(get_best_arch("criteo-kaggle", space),
                             OPS_CONFIG_LIB[space], 7, 13, 26, vocab)
    return jplan, tplan


def test_fixed_subnet_checkpoints_load_across_packages(tmp_path):
    """Both ways: a JAX-written checkpoint into the port, a port-written one
    into the JAX apply; the same logits either way."""
    vocab = (30,) * 26
    jplan, tplan = _fixed_plans(vocab)
    dense, cat, _ = _batch(8, vocab, seed=4)

    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(7), jplan))
    jax_save_checkpoint(str(tmp_path / "jax.pkl"), {"params": params, "step": 3})
    model = fixed_init(tplan, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(load_any_checkpoint(str(tmp_path / "jax.pkl"))
                                          ["params"], tplan))
    np.testing.assert_allclose(
        fixed_apply(model, torch.from_numpy(dense), torch.from_numpy(cat)).detach().numpy(),
        np.asarray(jax_fixed_apply(jplan, params, dense, cat)), **TOL)

    mine = fixed_init(tplan, seed=9, device="cpu")
    save_checkpoint(str(tmp_path / "port.pkl"), {"params": to_jax_params(mine), "step": 2})
    loaded = jax_load_checkpoint(str(tmp_path / "port.pkl"))
    assert jax.tree_util.tree_structure(loaded["params"]) == \
        jax.tree_util.tree_structure(params)
    np.testing.assert_allclose(
        np.asarray(jax_fixed_apply(jplan, loaded["params"], dense, cat)),
        fixed_apply(mine, torch.from_numpy(dense), torch.from_numpy(cat)).detach().numpy(),
        **TOL)


def _metric_tags(path):
    with open(path) as f:
        return {json.loads(line)["tag"] for line in f}


def test_main_train_writes_metrics_and_a_jax_checkpoint(tmp_path):
    """The fixed-subnet CLI's checkpoint.pkl loads with the JAX package's
    loader and gives the port's logits through the JAX apply."""
    out = main_train.main([
        "--arch", "criteo-kaggle/xlarge", "--data_source", "synthetic", "--device", "cpu",
        "--max_train_steps", "2", "--max_eval_steps", "1", "--train_batch_size", "32",
        "--test_batch_size", "64", "--display_interval", "1", "--test_interval", "2",
        "--logging_dir", str(tmp_path)])
    tags = _metric_tags(tmp_path / "metrics.jsonl")
    assert {"Loss/train/epoch0", "lr/epoch0", "AUROC/test/epoch0"} <= tags
    ckpt = jax_load_checkpoint(str(tmp_path / "checkpoint.pkl"))
    assert int(ckpt["step"]) == 2
    vocab = out["plan"].vocab_sizes
    jplan, _ = _fixed_plans(vocab)
    dense, cat, _ = _batch(8, vocab, seed=5)
    want = fixed_apply(out["state"].model, torch.from_numpy(dense),
                       torch.from_numpy(cat)).detach().numpy()
    np.testing.assert_allclose(np.asarray(jax_fixed_apply(jplan, ckpt["params"], dense, cat)),
                               want, **TOL)


CLI_BASE = ["--data_source", "synthetic", "--device", "cpu", "--config", "xlarge",
            "--num_blocks", "2", "--train_batch_size", "16", "--test_batch_size", "32",
            "--max_eval_steps", "1", "--display_interval", "1",
            "--supernet_training_steps", "3"]


def test_train_supernet_cli_writes_logs_and_resumes(tmp_path):
    first, second = tmp_path / "a", tmp_path / "b"
    out = train_supernet.main(CLI_BASE + ["--max_train_steps", "4", "--test_interval", "4",
                                          "--logging_dir", str(first)])
    logs = out["logs"][0]
    assert len(logs["train_loss"]) == 4 and np.all(np.isfinite(logs["train_loss"]))
    assert np.isfinite(logs["test_loss"][-1]) and out["state"].step == 4
    for name in ("configs_args.json", "train_test_logs.json", "train_test_logs.pickle",
                 "metrics.jsonl", "supernet_checkpoint.pkl"):
        assert (first / name).exists(), name
    assert json.loads((first / "configs_args.json").read_text())["supernet"]["num_blocks"] == 2
    with open(first / "train_test_logs.pickle", "rb") as f:
        assert pickle.load(f)[0]["train_loss"] == logs["train_loss"]
    assert {"Loss/train/epoch0", "Loss/test/epoch0"} <= _metric_tags(first / "metrics.jsonl")

    # The checkpoint is the JAX package's: its loader and apply give the
    # port's eval logits.
    ckpt = jax_load_checkpoint(str(first / "supernet_checkpoint.pkl"))
    assert int(ckpt["step"]) == 4
    cfg = out["cfg"]
    jcfg, _ = _supernet_cfgs("xlarge", 2, cfg.vocab_sizes)
    dense, cat, _ = _batch(8, cfg.vocab_sizes, seed=6)
    choice = jax_choices.full_path_choice(JAX_OPS["xlarge"], 2)
    want = supernet_apply(out["state"].model, torch.from_numpy(dense), torch.from_numpy(cat),
                          choices.choice_to_masks(choice, OPS_CONFIG_LIB["xlarge"], 2))
    np.testing.assert_allclose(
        np.asarray(jax_supernet_apply(jcfg, ckpt["params"], dense, cat,
                                      jax_choices.choice_to_masks(choice, JAX_OPS["xlarge"], 2))),
        want.detach().numpy(), **TOL)

    again = train_supernet.main(CLI_BASE + [
        "--max_train_steps", "2", "--test_interval", "2", "--logging_dir", str(second),
        "--checkpoint_path", str(first / "supernet_checkpoint.pkl"),
        "--eval_path", "full-path"])
    assert again["state"].step == 6
    assert int(load_any_checkpoint(str(second / "supernet_checkpoint.pkl"))["step"]) == 6
    assert np.all(np.isfinite(again["logs"][0]["train_loss"]))


def test_train_supernet_options(tmp_path):
    """evo-2shot candidates and a pretrained table; the multi-device branches
    (a mesh of one process, the host-RAM table, the directory checkpoint)
    train, a mesh that the processes do not fill raises, and so does the
    TPU's table layout."""
    donor = tmp_path / "donor.pkl"
    sn = SupernetOptions(config="autoctr", num_blocks=2, supernet_training_steps=0)
    data = DataOptions(data_source="synthetic", train_batch_size=16, test_batch_size=32,
                       synthetic_vocab=50)
    train = TrainOptions(max_train_steps=1, max_eval_steps=1, test_interval=1,
                         device="cpu", seed=3)
    table = np.random.RandomState(0).randn(50 * 26, 16).astype(np.float32)
    save_checkpoint(str(donor), {"params": {"embedding": {"table": table}}, "step": 0})
    cands = [jax_sampling.ChoiceSampler(JAX_OPS["autoctr"], 2, seed=s)() for s in (1, 2)]
    cand_path = tmp_path / "cands.pkl"
    with open(cand_path, "wb") as f:
        pickle.dump([{"choice": c, "score": 0.1} for c in cands], f)
    said = []
    sn_evo = SupernetOptions(**{**sn.__dict__, "strategy": "evo-2shot-path",
                                "evo_2shot_candidates_path": str(cand_path),
                                "pretrained_emb_path": str(donor)})
    out = train_supernet_fn(sn_evo, data, train, log_fn=said.append)
    assert any("seeded embedding table" in s for s in said)
    assert any("loaded 2 evo-2shot candidates" in s for s in said)
    # One step moves only the rows it touched away from the donor's table.
    moved = (out["state"].model.embedding.table.detach().numpy() != table).any(1)
    assert 0 < moved.sum() <= 16 * 26

    with pytest.raises(ValueError, match="scatter"):
        train_supernet_fn(sn, data, TrainOptions(**{**train.__dict__, "table_update": "sweep"}))
    with pytest.raises(ValueError, match="not divisible by model=2"):
        train_supernet_fn(sn, data, TrainOptions(**{**train.__dict__, "mesh_model": 2}))
    for field, value in (("mesh_model", 1), ("place_embedding_on_cpu", True),
                         ("ckpt_backend", "orbax")):
        run = train_supernet_fn(sn, data, TrainOptions(**{**train.__dict__, field: value,
                                                          "logging_dir": str(tmp_path / field)}),
                                log_fn=lambda s: None)
        assert run["state"].step == 1 and np.isfinite(run["logs"][0]["train_loss"]).all()
    assert (tmp_path / "ckpt_backend" / "supernet_checkpoint.orbax" / "sidecar.json").is_file()
    # bf16 compute trains: the step is taken, the parameters stay float32.
    bf16 = train_supernet_fn(sn, data, TrainOptions(**{**train.__dict__,
                                                       "compute_dtype": "bfloat16"}),
                             log_fn=lambda s: None)
    assert bf16["state"].step == 1 and np.isfinite(bf16["logs"][0]["train_loss"]).all()
    assert all(p.dtype == torch.float32 for p in bf16["state"].model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        train_supernet_fn(sn, data, TrainOptions(**{**train.__dict__, "compute_dtype": "fp16"}))


def test_train_supernet_micro_batches_train_as_one_slice():
    """micro_batches = 2 trains the supernet (the table's touched rows and
    every other parameter move) and ends where micro_batches = 1 ends."""
    sn = SupernetOptions(config="autoctr", num_blocks=2, supernet_training_steps=0)
    data = DataOptions(data_source="synthetic", train_batch_size=32, test_batch_size=32,
                       synthetic_vocab=50)
    runs = [train_supernet_fn(sn, data, TrainOptions(max_train_steps=2, max_eval_steps=1,
                                                     test_interval=2, device="cpu",
                                                     micro_batches=m), log_fn=lambda s: None)
            for m in (1, 2)]
    fresh = supernet_init(runs[0]["cfg"], seed=0, device="cpu").state_dict()
    one, two = (r["state"].model.state_dict() for r in runs)
    assert any(not torch.equal(two[k], fresh[k]) for k in two if k.startswith("blocks."))
    assert not torch.equal(two["final.weight"], fresh["final.weight"])
    assert (two["embedding.table"] != fresh["embedding.table"]).any(1).sum() > 0
    for name in one:
        np.testing.assert_allclose(two[name].numpy(), one[name].numpy(), err_msg=name, **TOL)

