"""Host-RAM table offload (parallel/host_embedding.py) against the port's
on-device sparse step and against the JAX package's offload step, its two
workload branches, and the refusals it shares with the JAX package.

Model: criteo-kaggle/autoctr's best arch, 7 blocks, 64 rows a slot, 4 batches
of 32 synthetic rows (duplicate indices in every batch), lr 0.1, Adagrad, the
clip at 5.0 and at 0.05 (where it scales every step), as
tests/test_host_embedding.py.  Tolerance: losses 1e-4 relative, the table,
its accumulator and the dense parameters rtol 1e-4 / atol 1e-5 (as
tests/test_torch_dense_step.py holds the port to JAX).
"""

import pickle

import numpy as np
import pytest
import torch

from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.data.synthetic import SyntheticSpec, synthetic_arrays
from nasrec_tpu_torch.models.embedding import table_offsets
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
from nasrec_tpu_torch.models.transplant import from_jax_params
from nasrec_tpu_torch.parallel.host_embedding import (
    HostEmbedding,
    detach_table,
    make_host_offload_train_step,
)
from nasrec_tpu_torch.train.loop import init_train_state
from nasrec_tpu_torch.train.optim import make_optimizer
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
    table_accumulator,
)
from nasrec_tpu_torch.workloads import (
    DataOptions,
    SupernetOptions,
    TrainOptions,
    train_fixed_subnet,
    train_supernet,
)

torch.set_num_threads(2)
VOCAB = (64,) * 26
TOL = dict(rtol=1e-4, atol=1e-5)
CLIPS = (5.0, 0.05)


def _plan():
    return build_fixed_plan(get_best_arch("criteo-kaggle", "autoctr"), OPS_CONFIG_LIB["autoctr"],
                            7, 13, 26, VOCAB, use_layernorm=False)


def _batches():
    dense, cat, y = synthetic_arrays(4 * 32, SyntheticSpec(vocab=64), seed=0)
    return [(torch.from_numpy(dense[i:i + 32]), torch.from_numpy(cat[i:i + 32]),
             torch.from_numpy(y[i:i + 32])) for i in range(0, 128, 32)]


def _model(params_np=None):
    plan = _plan()
    model = fixed_init(plan, seed=0, device="cpu")
    if params_np is not None:
        model.load_state_dict(from_jax_params(params_np, plan))
    return model


def _offload_run(clip, model, l2_reg=0.0, timings=None):
    host = HostEmbedding(detach_table(model), table_offsets(VOCAB))
    opt = make_optimizer("adagrad")
    state = init_train_state(model, opt)
    step = make_host_offload_train_step(opt, lambda s: 0.1, host, grad_clip=clip,
                                        l2_reg=l2_reg, timings=timings)
    metrics = []
    for batch in _batches():
        state, m = step(state, *batch)
        metrics.append(m)
    return state, host, metrics


@pytest.mark.parametrize("clip", CLIPS)
def test_offload_step_matches_the_on_device_sparse_step(clip):
    dev_model = _model()
    off_model = _model()
    state = init_sparse_train_state(dev_model)
    step = make_sparse_embedding_train_step(lambda s: 0.1, grad_clip=clip)
    for batch in _batches():
        state, m_dev = step(state, *batch)
    _, host, m_off = _offload_run(clip, off_model)
    np.testing.assert_allclose(float(m_off[-1]["loss"]), float(m_dev["loss"]), rtol=1e-4)
    np.testing.assert_allclose(host.table, dev_model.embedding.table.numpy(), **TOL)
    np.testing.assert_allclose(host.acc, table_accumulator(state.opt_state).numpy(), **TOL)
    np.testing.assert_allclose(off_model.final.weight.detach().numpy(),
                               dev_model.final.weight.detach().numpy(), **TOL)
    assert tuple(off_model.embedding.table.shape) == (0, 16)


@pytest.mark.parametrize("clip", CLIPS)
def test_offload_step_matches_jax_offload_step(clip):
    import jax
    import jax.numpy as jnp

    from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
    from nasrec_tpu.configs import get_best_arch as jax_best_arch
    from nasrec_tpu.models import build_fixed_plan as jax_build_plan
    from nasrec_tpu.models import fixed_init as jax_fixed_init
    from nasrec_tpu.models.embedding import table_offsets as jax_offsets
    from nasrec_tpu.models.fixed import fixed_apply_embedded as jax_apply_embedded
    from nasrec_tpu.parallel.host_embedding import HostEmbedding as JaxHostEmbedding
    from nasrec_tpu.parallel.host_embedding import make_host_offload_train_step as jax_step
    from nasrec_tpu.train import make_optimizer as jax_make_optimizer
    from nasrec_tpu.train.loop import init_train_state as jax_init_state

    jplan = jax_build_plan(jax_best_arch("criteo-kaggle", "autoctr"), JAX_OPS["autoctr"], 7,
                           13, 26, VOCAB, use_layernorm=False, attention_impl="xla")
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(0), jplan))
    jhost = JaxHostEmbedding(np.asarray(params["embedding"]["table"]), jax_offsets(VOCAB))
    jopt = jax_make_optimizer("adagrad")
    jstate = jax_init_state({k: v for k, v in params.items() if k != "embedding"}, jopt)
    jstep = jax_step(lambda p, d, s: jax_apply_embedded(jplan, p, d, s), jopt,
                     lambda s: jnp.asarray(0.1), jhost, grad_clip=clip)
    for d, c, y in _batches():
        jstate, jm = jstep(jstate, d.numpy(), c.numpy(), y.numpy())

    model = _model(params)
    _, host, m = _offload_run(clip, model)
    np.testing.assert_allclose(float(m[-1]["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(host.table, jhost.table, **TOL)
    np.testing.assert_allclose(host.acc, jhost.acc, **TOL)
    np.testing.assert_allclose(model.final.weight.detach().numpy(),
                               np.asarray(jstate.params["final"]["w"]).T, **TOL)


def test_grad_rows_sums_duplicates_before_squaring():
    from nasrec_tpu.parallel.host_embedding import HostEmbedding as JaxHostEmbedding

    rng = np.random.RandomState(2)
    table = rng.randn(sum(VOCAB), 16).astype(np.float32)
    cat = rng.randint(0, 4, size=(32, 26)).astype(np.int32)     # many duplicates
    g = rng.randn(32, 26, 16).astype(np.float32)
    ours = HostEmbedding(table, table_offsets(VOCAB)).grad_rows(cat, g)
    theirs = JaxHostEmbedding(table, table_offsets(VOCAB)).grad_rows(cat, g)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2]
    assert len(ours[0]) < cat.size


def test_offload_l2_term_covers_the_device_parameters_only():
    from nasrec_tpu_torch.train.optim import l2_penalty

    model = _model()
    named = [(n, p.detach().clone()) for n, p in model.named_parameters()
             if n != "embedding.table"]
    _, _, m = _offload_run(5.0, model, l2_reg=1e-3)
    np.testing.assert_allclose(float(m[0]["l2"]), float(l2_penalty(named, 1e-3)), rtol=1e-5)
    assert float(m[0]["loss"]) > 0.0


def test_offload_step_reports_its_split():
    timings = {}
    _offload_run(5.0, _model(), timings=timings)
    assert set(timings) == {"lookup", "to_device", "device", "to_host", "update"}
    assert all(v >= 0.0 for v in timings.values())


def _data():
    return DataOptions(data_source="synthetic", train_batch_size=64, test_batch_size=128,
                       synthetic_train_examples=1024, synthetic_test_examples=256,
                       synthetic_vocab=100)


def _train(**kw):
    return TrainOptions(learning_rate=0.02, display_interval=1, test_interval=4,
                        max_train_steps=4, max_eval_steps=1, device="cpu", **kw)


def test_train_fixed_subnet_offload_matches_on_device(tmp_path):
    payload = {**get_best_arch("criteo-kaggle", "autoctr"), "config": "autoctr",
               "num_blocks": 7}
    on = train_fixed_subnet(payload, _data(), _train(), log_fn=lambda s: None)
    off = train_fixed_subnet(payload, _data(),
                             _train(place_embedding_on_cpu=True, logging_dir=str(tmp_path)),
                             log_fn=lambda s: None)
    a, b = on["logs"][0], off["logs"][0]
    np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(b["test_loss"], a["test_loss"], rtol=1e-4)
    with open(tmp_path / "checkpoint.pkl", "rb") as f:
        ckpt = pickle.load(f)
    table = ckpt["params"]["embedding"]["table"]
    assert table.shape == (26 * 100, 16)       # the host table, saved back
    np.testing.assert_array_equal(table, off["host_embedding"].table)
    np.testing.assert_allclose(table, on["state"].model.embedding.table.numpy(), **TOL)


def test_train_supernet_offload_matches_on_device(tmp_path):
    sn = SupernetOptions(config="autoctr", num_blocks=2, supernet_training_steps=2)
    on = train_supernet(sn, _data(), _train(), log_fn=lambda s: None)
    off = train_supernet(sn, _data(),
                         _train(place_embedding_on_cpu=True, logging_dir=str(tmp_path)),
                         log_fn=lambda s: None)
    a, b = on["logs"][0], off["logs"][0]
    np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(b["test_loss"], a["test_loss"], rtol=1e-4)
    with open(tmp_path / "supernet_checkpoint.pkl", "rb") as f:
        ckpt = pickle.load(f)
    host = off["host_embedding"]
    np.testing.assert_array_equal(ckpt["params"]["embedding"]["table"], host.table)
    np.testing.assert_array_equal(ckpt["opt_state"]["embedding"]["table"], host.acc)
    np.testing.assert_allclose(host.acc, table_accumulator(on["state"].opt_state).numpy(),
                               **TOL)
    assert int(ckpt["step"]) == 4


REFUSALS = {
    "mesh": (dict(place_embedding_on_cpu=True, mesh_model=2), "mutually exclusive"),
    "micro_batches": (dict(place_embedding_on_cpu=True, micro_batches=2),
                      "micro_batches > 1 is not supported with place_embedding_on_cpu"),
    "optimizer": (dict(place_embedding_on_cpu=True, optimizer="sgd"),
                  "trains the host table with Adagrad"),
    "wd": (dict(place_embedding_on_cpu=True, wd=1e-4), "use wd=0 with offload"),
    "sweep": (dict(place_embedding_on_cpu=True, table_update="sweep"),
              "table_update='sweep' is a device-table path"),
    "mesh_micro_dense": (dict(mesh_model=1, micro_batches=2, optimizer="adam"),
                         "the dense mesh step has no gradient-accumulation support"),
}


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_the_jax_package(name):
    kw, needle = REFUSALS[name]
    payload = {**get_best_arch("criteo-kaggle", "autoctr"), "config": "autoctr",
               "num_blocks": 7}
    with pytest.raises(ValueError, match=needle):
        train_fixed_subnet(payload, _data(), _train(**kw), log_fn=lambda s: None)


def test_orbax_is_refused_under_several_processes(monkeypatch):
    import nasrec_tpu_torch.workloads as workloads

    monkeypatch.setattr(workloads, "host_info", lambda: (0, 2))
    with pytest.raises(ValueError, match="not supported under multi-process runs"):
        workloads._validate_train_options(_train(ckpt_backend="orbax"))
    monkeypatch.setattr(workloads, "host_info", lambda: (0, 1))
    workloads._validate_train_options(_train(ckpt_backend="orbax"))
