"""Two sparse-embedding train steps of the criteo-kaggle/autoctr and
criteo-kaggle/xlarge subnets in the port against the JAX step
(table_update="scatter"; attention_impl="xla" for autoctr, which has no
transformer node, and "pallas" in interpret mode for xlarge), from the same
transplanted weights on the same batches; then runs of the port's
fixed-subnet workload through its CLI on the CPU.  The step harness
(`run_both_steps`, `assert_state_matches`, `check_two_sparse_steps`) also
holds the other datasets' archs (tests/test_torch_datasets*.py).

Tolerance (f32, after train steps): rtol 1e-4 / atol 1e-5 on the losses,
logits, parameters, embedding table and Adagrad accumulators.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import build_fixed_plan as jax_build_plan
from nasrec_tpu.models import fixed_init as jax_fixed_init
from nasrec_tpu.models.embedding import table_offsets as jax_table_offsets
from nasrec_tpu.models.fixed import fixed_apply_embedded as jax_apply_embedded
from nasrec_tpu.train import make_optimizer
from nasrec_tpu.train.loop import init_train_state
from nasrec_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from nasrec_tpu.train.sparse_embedding import (
    make_sparse_embedding_train_step as jax_sparse_step,
)

from nasrec_tpu_torch.cli import main_train
from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
from nasrec_tpu_torch.models.transplant import from_jax_opt_state, from_jax_params
from nasrec_tpu_torch.train.optim import make_lr_schedule
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


VOCAB_CAP = 50


def capped_vocab(dataset):
    """The dataset's slots capped at VOCAB_CAP rows, so a batch repeats rows."""
    return tuple(min(v, VOCAB_CAP) for v in DATASETS[dataset].raw_vocab_sizes)


def step_batches(dataset, vocab, b, n=2, seed=0):
    """n batches of b examples: N(0, 1) dense, uniform indices, 0/1 labels."""
    spec = DATASETS[dataset]
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, spec.num_dense).astype(np.float32),
             np.stack([rng.randint(0, v, size=b) for v in vocab], 1).astype(np.int32),
             rng.randint(0, 2, size=(b, 1)).astype(np.float32)) for _ in range(n)]


def fixed_pair(dataset, space, attention_impl, compute_dtype=None):
    """The published best arch of <dataset>/<space> at 7 blocks over the
    capped vocab: the JAX apply (computing in `compute_dtype`), the port's
    plan, the port's model holding the JAX initialisation, and that
    initialisation."""
    spec, vocab = DATASETS[dataset], capped_vocab(dataset)
    jplan = jax_build_plan(jax_best_arch(dataset, space), JAX_OPS[space], 7, spec.num_dense,
                           spec.num_sparse, vocab, attention_impl=attention_impl)
    tplan = build_fixed_plan(get_best_arch(dataset, space), OPS_CONFIG_LIB[space], 7,
                             spec.num_dense, spec.num_sparse, vocab)
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(3), jplan))
    model = fixed_init(tplan, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tplan))
    return lambda p, d, s: jax_apply_embedded(jplan, p, d, s, **kw), tplan, model, params


def run_both_steps(japply, model, tspec, params, batches, lr, clip=5.0, masks=(None, None),
                   compute_dtype=torch.float32):
    """The JAX sparse-embedding step (Adagrad, cosine schedule from `lr`,
    table_update="scatter") from `params` and the port's step from `model`,
    which holds the same weights, over `batches` (with the JAX and the port's
    masks of each batch where `masks` has them); returns (JAX state, JAX
    metrics, port state, port metrics)."""
    vocab = tspec.vocab_sizes
    has_masks = masks[0] is not None
    opt = make_optimizer("adagrad")
    jstate = init_train_state(params, opt)
    jstep = jax_sparse_step(japply, opt, jax_lr_schedule("cosine", lr, 10, 1),
                            jax_table_offsets(vocab), grad_clip=clip, has_masks=has_masks,
                            donate=False, table_update="scatter")
    for batch, m in zip(batches, masks[0] or [None] * len(batches)):
        jstate, jm = jstep(jstate, *batch, *(() if m is None else (m,)))

    tstate = init_sparse_train_state(model)
    tstep = make_sparse_embedding_train_step(make_lr_schedule("cosine", lr, 10, 1),
                                             grad_clip=clip, has_masks=has_masks,
                                             compute_dtype=compute_dtype)
    for batch, m in zip(batches, masks[1] or [None] * len(batches)):
        tstate, tm = tstep(tstate, *(torch.from_numpy(x) for x in batch),
                           *(() if m is None else (m,)))
    assert tstate.step == int(jstate.step) == len(batches)
    return jstate, jm, tstate, tm


def jax_state_dicts(jstate, tspec):
    """The JAX state's parameters and Adagrad accumulators under the port's
    state_dict names."""
    return (from_jax_params(jax.device_get(jstate.params), tspec),
            from_jax_opt_state(jax.device_get(jstate.opt_state), tspec))


def assert_state_matches(tstate, jstate, tspec, tol):
    """Parameters (the table included) and accumulators, all float32, against
    the JAX state's within `tol`."""
    want_p, want_a = jax_state_dicts(jstate, tspec)
    got_p = tstate.model.state_dict()
    assert set(got_p) == set(want_p) == set(tstate.opt_state)
    for name in want_p:
        assert got_p[name].dtype == tstate.opt_state[name].dtype == torch.float32, name
        np.testing.assert_allclose(got_p[name].numpy(), want_p[name].numpy(),
                                   err_msg=name, **tol)
        np.testing.assert_allclose(tstate.opt_state[name].numpy(), want_a[name].numpy(),
                                   err_msg=name, **tol)


def check_two_sparse_steps(dataset, space, attention_impl, b, clip=5.0):
    """Two steps of <dataset>/<space> at batch b, port against JAX: loss,
    logits, parameters, table and accumulators within TOL."""
    japply, tplan, model, params = fixed_pair(dataset, space, attention_impl)
    batches = step_batches(dataset, tplan.vocab_sizes, b)
    jstate, jm, tstate, tm = run_both_steps(japply, model, tplan, params, batches, 0.16, clip)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["logits"].numpy(), np.asarray(jm["logits"]), **TOL)
    assert_state_matches(tstate, jstate, tplan, TOL)


# clip 0.05: the clip scales every step.  The xlarge arch runs the JAX fused
# transformer body, whose backward needs a batch that its lane tile divides.
@pytest.mark.parametrize("space,clip,b", [("autoctr", 5.0, 64), ("autoctr", 0.05, 64),
                                          ("xlarge", 5.0, 128)],
                         ids=["5.0", "0.05", "xlarge-5.0"])
def test_two_sparse_steps_match_jax(space, clip, b):
    check_two_sparse_steps("criteo-kaggle", space,
                           "xla" if space == "autoctr" else "pallas", b, clip)


def _run_cli_on_cpu(arch, tmp_path):
    out = main_train.main([
        "--arch", arch, "--data_source", "synthetic",
        "--device", "cpu", "--max_train_steps", "3", "--max_eval_steps", "1",
        "--train_batch_size", "64", "--test_batch_size", "128",
        "--display_interval", "1", "--test_interval", "3",
        "--logging_dir", str(tmp_path),
    ])
    logs = out["logs"][0]
    assert len(logs["train_loss"]) == 3 and np.all(np.isfinite(logs["train_loss"]))
    assert len(logs["test_loss"]) == 2 and np.isfinite(logs["test_loss"][-1])
    assert 0.0 <= logs["test_AUROC"][-1] <= 1.0
    assert out["state"].step == 3
    assert (tmp_path / "train_test_logs.json").exists()
    assert (tmp_path / "metrics.jsonl").exists()
    with open(tmp_path / "checkpoint.pkl", "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["step"] == 3
    # The JAX package's layout: numpy arrays, the table as [vocab, 16].
    np.testing.assert_array_equal(ckpt["params"]["embedding"]["table"],
                                  out["state"].model.embedding.table.detach().numpy())
    return out


def test_train_fixed_subnet_cli_on_cpu(tmp_path):
    _run_cli_on_cpu("criteo-kaggle/autoctr", tmp_path)


def test_train_fixed_subnet_cli_on_cpu_xlarge(tmp_path):
    out = _run_cli_on_cpu("criteo-kaggle/xlarge", tmp_path)
    nodes = [m for m in out["state"].model.modules() if type(m).__name__ == "Transformer"]
    assert len(nodes) == 3 and all(n.fused for n in nodes)


def test_unported_branches_raise():
    """The branches once refused as unported run from the CLI; a mesh that
    the processes do not fill raises before any work."""
    base = ["--arch", "criteo-kaggle/autoctr", "--data_source", "synthetic",
            "--device", "cpu", "--max_train_steps", "2", "--max_eval_steps", "1",
            "--train_batch_size", "32", "--test_batch_size", "64"]
    with pytest.raises(ValueError, match="not divisible by model=2"):
        main_train.main(base + ["--mesh_model", "2"])
    for extra in (["--mesh_model", "1"], ["--place_embedding_on_cpu", "1"],
                  ["--ckpt_backend", "orbax"]):
        out = main_train.main(base + extra)
        assert out["state"].step == 2 and np.all(np.isfinite(out["logs"][0]["train_loss"]))


def test_cli_wd_trains_through_the_dense_step():
    """--wd > 0 takes the dense-gradient step, whose L2 term reaches every
    parameter of two or more dimensions, the table's untouched rows too."""
    out = main_train.main(["--arch", "criteo-kaggle/autoctr", "--data_source", "synthetic",
                           "--device", "cpu", "--wd", "0.1", "--max_train_steps", "2",
                           "--max_eval_steps", "1", "--train_batch_size", "32",
                           "--test_batch_size", "64", "--synthetic_vocab", "2000"])
    state = out["state"]
    assert state.step == 2 and np.all(np.isfinite(out["logs"][0]["train_loss"]))
    assert out["logs"][0]["train_loss"] and all(np.isfinite(out["logs"][0]["test_loss"]))
    fresh = fixed_init(out["plan"], seed=0, device="cpu").state_dict()
    for name, value in state.model.state_dict().items():
        # Weights of blocks that nothing reads move by the L2 term alone.
        if value.dim() >= 2 or name.startswith("final"):
            assert not torch.equal(value, fresh[name]), name
    table = state.model.embedding.table.detach()
    assert bool((table != fresh["embedding.table"]).any(1).all())


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_train.main(["--arch", "criteo-kaggle/autoctr", "--data_source", "synthetic"])
