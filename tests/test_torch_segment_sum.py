"""The duplicate-row segment-sum (ops/kernels/segment_sum.py) on the CPU: the
plain version against the JAX package's `rowwise_segment_sum_slotwise` and
against float64 sums; the wrapper's routing ("auto" takes the plain version
for CPU tensors, impl="kernel" raises there, bad inputs raise before any
launch); the source's registration in build.py and its kernels' names; and
the sparse step's one segment-sum a step, with micro-batches too, through a
counted stand-in of the launch function.  The CUDA kernel runs on the card
only (tests/test_torch_cuda.py).

Tolerance (f32): the plain version is the JAX composite in PyTorch, so rows
and is_end are equal; seg is a difference of prefix sums over B positions,
each rounded once an addition, so within (2 B + 1) 2^-24 of the column's sum
of |g| from the float64 sums, and JAX's (whose cumsum adds in another order)
within twice that of the port's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu.train.sparse_embedding import rowwise_segment_sum_slotwise as jax_segsum

from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.embedding import table_offsets
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
from nasrec_tpu_torch.ops.kernels import build, segment_sum as ss, table_update
from nasrec_tpu_torch.train.optim import make_lr_schedule
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
    rowwise_segment_sum_slotwise,
)

torch.set_num_threads(2)


def _case(b, vocab, seed=0):
    """idx2d [b, len(vocab)] fused rows (slot s uniform over its vocab rows)
    and g [b * len(vocab), 16]."""
    rng = np.random.RandomState(seed)
    offsets = np.asarray(table_offsets(vocab), np.int32)
    cat = np.stack([rng.randint(0, v, size=b) for v in vocab], 1).astype(np.int32)
    return cat + offsets[None, :], rng.randn(b * len(vocab), 16).astype(np.float32)


def float64_sums(idx2d, g):
    """Each position's run sum in float64 at the run's last position of the
    sorted column, zeros elsewhere, in the output's slot-major order; and the
    column's sum of |g| a position."""
    b, c = idx2d.shape
    g3 = g.reshape(b, c, 16).astype(np.float64)
    out, scale = np.zeros((c, b, 16)), np.zeros((c, b, 1))
    for col in range(c):
        order = np.argsort(idx2d[:, col], kind="stable")
        rows = idx2d[order, col]
        vals = g3[order, col]
        ends = np.append(rows[1:] != rows[:-1], True)
        start = 0
        for j in np.flatnonzero(ends):
            out[col, j] = vals[start:j + 1].sum(axis=0)
            start = j + 1
        scale[col] = np.abs(vals).sum()
    return out.reshape(c * b, 16), scale.reshape(c * b, 1)


# (b, vocab): duplicates in every column; a column of one row; a column of
# distinct rows; one position a column.
SHAPES = [(64, (7, 3, 11, 2, 9)), (37, (1, 500, 4, 37)), (1, (5, 3)), (257, (1, 10 ** 6))]


@pytest.mark.parametrize("b,vocab", SHAPES)
def test_plain_matches_jax_and_float64(b, vocab):
    idx2d, g = _case(b, vocab)
    rows, seg, is_end = rowwise_segment_sum_slotwise(torch.from_numpy(idx2d), torch.from_numpy(g))
    jr, js, je = (np.asarray(a) for a in jax_segsum(jnp.asarray(idx2d), jnp.asarray(g)))
    np.testing.assert_array_equal(rows.numpy(), jr)
    np.testing.assert_array_equal(is_end.numpy(), je)
    want, scale = float64_sums(idx2d, g)
    tol = (2 * b + 1) * 2.0 ** -24 * scale
    seg = seg.numpy()
    assert not seg[~je].any()
    assert np.all(np.abs(seg - want) <= tol)
    assert np.all(np.abs(seg - js) <= 2 * tol)
    assert je.sum() == sum(len(np.unique(idx2d[:, c])) for c in range(len(vocab)))


def test_auto_on_cpu_takes_the_plain_version():
    idx2d, g = (torch.from_numpy(a) for a in _case(64, (7, 3, 11)))
    before = dict(ss.LAUNCHES)
    got = ss.segment_sum(idx2d, g)
    want = ss.segment_sum_plain(idx2d, g)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert dict(ss.LAUNCHES) == before


def test_kernel_on_cpu_raises():
    idx2d, g = (torch.from_numpy(a) for a in _case(8, (3, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.segment_sum(idx2d, g, impl="kernel")
    assert sum(ss.LAUNCHES.values()) == 0


# Inputs the kernel does not take, each made from a good (idx2d, g) pair; on
# the CPU, even good ones.
BAD_INPUTS = {
    "int64_rows": lambda idx2d, g: (idx2d.long(), g),
    "strided_rows": lambda idx2d, g: (idx2d.t().contiguous().t(), g),
    "float64_g": lambda idx2d, g: (idx2d, g.double()),
    "short_g": lambda idx2d, g: (idx2d, g[:-1]),
    "wide_g": lambda idx2d, g: (idx2d, g.repeat(1, 2)),
    "strided_g": lambda idx2d, g: (idx2d, g.t().contiguous().t()),
    "cpu": lambda idx2d, g: (idx2d, g),
}


@pytest.mark.parametrize("which", list(BAD_INPUTS))
def test_kernel_rejects_bad_inputs_before_any_launch(monkeypatch, which):
    def no_build(name):
        raise AssertionError(f"{name} was built before the inputs were checked")

    monkeypatch.setattr(build, "load_library", no_build)
    idx2d, g = (torch.from_numpy(a) for a in _case(16, (3, 4, 5)))
    before = dict(ss.LAUNCHES)
    with pytest.raises(ValueError):
        ss.segment_sum_kernel(*BAD_INPUTS[which](idx2d, g))
    assert dict(ss.LAUNCHES) == before


def test_kernel_source_is_registered():
    assert "segment_sum" in build.KERNEL_SOURCES
    assert list(build.SIGNATURES["segment_sum"]) == ["nasrec_segment_sum",
                                                     "nasrec_segment_sum128"]
    text = (build.CSRC_DIR / "segment_sum.cu").read_text()
    assert 'extern "C" int nasrec_segment_sum(' in text
    assert 'extern "C" int nasrec_segment_sum128(' in text
    # Its __global__ functions are named segsum_*, apart from the other
    # kernels' names, which a device trace is searched for; the 128-wide
    # instance's names hold "128".
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", text)
    assert names == ["segsum_tile_kernel", "segsum_tile128_kernel", "segsum_carry_kernel",
                     "segsum_walk128_kernel"]


def _counted(plain, module, key):
    def standin(*args, **kw):
        module.LAUNCHES[key] += 1
        return plain(*args, **kw)

    return standin


@pytest.mark.parametrize("microbatch", [1, 2])
def test_sparse_step_runs_one_segment_sum_a_step(monkeypatch, microbatch):
    """Through the kernel route (a counted stand-in of the launch function
    that computes the plain version), the sparse step launches the
    segment-sum once a step, micro-batched or not, and its state is the
    plain route's bit for bit; the table's impl picks the route."""
    dataset, b, steps = "criteo-kaggle", 32, 2
    spec = DATASETS[dataset]
    vocab = tuple(min(v, 40) for v in spec.raw_vocab_sizes)
    plan = build_fixed_plan(get_best_arch(dataset, "autoctr"), OPS_CONFIG_LIB["autoctr"], 7,
                            spec.num_dense, spec.num_sparse, vocab)
    rng = np.random.RandomState(1)
    batches = [(torch.from_numpy(rng.randn(b, spec.num_dense).astype(np.float32)),
                torch.from_numpy(np.stack([rng.randint(0, v, size=b) for v in vocab], 1)
                                 .astype(np.int32)),
                torch.from_numpy(rng.randint(0, 2, size=(b, 1)).astype(np.float32)))
               for _ in range(steps)]
    monkeypatch.setattr(build, "resolve_impl",
                        lambda impl, x: "plain" if impl == "plain" else "kernel")
    monkeypatch.setattr(ss, "segment_sum_kernel",
                        _counted(ss.segment_sum_plain, ss, "segment_sum"))
    monkeypatch.setattr(table_update, "table_update_kernel",
                        _counted(table_update.table_update_plain, table_update, "table_update"))
    ss.LAUNCHES.clear()
    table_update.LAUNCHES.clear()

    states = []
    for table_impl in ("auto", "plain"):
        state = init_sparse_train_state(fixed_init(plan, seed=0, device="cpu"))
        step = make_sparse_embedding_train_step(make_lr_schedule("cosine", 0.1, 10, 1),
                                                impl="plain", table_impl=table_impl,
                                                microbatch=microbatch)
        for batch in batches:
            state, _ = step(state, *batch)
        states.append(state)
        if table_impl == "auto":
            assert dict(ss.LAUNCHES) == {"segment_sum": steps}
            assert dict(table_update.LAUNCHES) == {"table_update": steps}
    assert dict(ss.LAUNCHES) == {"segment_sum": steps}
    got, want = (s.model.state_dict() for s in states)
    assert all(torch.equal(got[k], want[k]) for k in want)
    ss.LAUNCHES.clear()
    table_update.LAUNCHES.clear()
