"""Touched-row Adagrad table update: the port's plain version against the JAX
`sparse_adagrad_table_update` (scatter) and against the Pallas sweep kernel
`sweep_adagrad_update` in interpret mode on a packed-then-unpacked table.
Covers duplicates, a hot row, sentinel rows, row_offset shards, and that
untouched rows stay bit-exact.  The CUDA kernel runs on the card only
(tests/test_torch_cuda.py holds it against this plain version).

Tolerance (f32): rtol 1e-5 / atol 1e-6 on touched rows (the sweep kernel may
contract to fused multiply-adds); untouched rows exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu.ops.kernels import table_sweep_pallas as tsp
from nasrec_tpu.train.sparse_embedding import (
    rowwise_segment_sum,
    sparse_adagrad_table_update as jax_update,
)

from nasrec_tpu_torch.ops.kernels import table_update as tu

torch.set_num_threads(2)

LR, EPS = 0.12, 1e-2


def _case(idx, vocab, seed=0, sentinels=0):
    """Sorted rows + segment sums (zero off segment ends) for vocab rows idx,
    with `sentinels` trailing rows >= vocab."""
    rng = np.random.RandomState(seed)
    g = rng.randn(len(idx), 16).astype(np.float32)
    rows, seg, is_end = (np.array(a) for a in rowwise_segment_sum(
        jnp.asarray(idx, jnp.int32), jnp.asarray(g)))
    if sentinels:
        rows = np.concatenate([rows, np.full(sentinels, vocab + 7, np.int32)])
        seg = np.concatenate([seg, rng.randn(sentinels, 16).astype(np.float32)])
        is_end = np.concatenate([is_end, np.zeros(sentinels, bool)])
    table = rng.randn(vocab, 16).astype(np.float32)
    acc = np.abs(rng.randn(vocab, 16)).astype(np.float32)
    return rows, seg, is_end, table, acc


def _plain(table, acc, rows, seg, row_offset=0):
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    tu.table_update(t, a, torch.from_numpy(rows), torch.from_numpy(seg), LR, EPS,
                    row_offset)
    return t.numpy(), a.numpy()


def _assert_update(got, want, table, acc, touched):
    (gt, ga), (wt, wa) = got, want
    np.testing.assert_array_equal(gt[~touched], table[~touched])
    np.testing.assert_array_equal(ga[~touched], acc[~touched])
    np.testing.assert_allclose(gt[touched], wt[touched], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga[touched], wa[touched], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "hot_row"])
def test_plain_matches_jax_scatter(kind):
    rng = np.random.RandomState(1)
    vocab = 3000
    idx = rng.randint(0, vocab, size=2500)
    if kind == "hot_row":
        idx[::3] = 17   # one row at a third of the positions
    rows, seg, is_end, table, acc = _case(idx, vocab)
    jt, ja = jax_update(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows),
                        jnp.asarray(seg), LR, EPS, 1.0, jnp.asarray(is_end))
    touched = np.zeros(vocab, bool)
    touched[np.unique(idx)] = True
    _assert_update(_plain(table, acc, rows, seg), (np.asarray(jt), np.asarray(ja)),
                   table, acc, touched)


def test_plain_matches_sweep_interpret_with_sentinels():
    rng = np.random.RandomState(2)
    vocab = tsp.ROWS_PER_TILE + 500          # two sweep tiles
    idx = rng.randint(0, vocab, size=1500)
    idx[:200] = 3                             # duplicates of a hot row
    rows, seg, _, table, acc = _case(idx, vocab, sentinels=5)
    new_tp, new_ap = tsp.sweep_adagrad_update(
        tsp.pack_rows(jnp.asarray(table)), tsp.pack_rows(jnp.asarray(acc)),
        jnp.asarray(rows), jnp.asarray(seg), LR, eps=EPS, interpret=True)
    want = (np.asarray(tsp.unpack_rows(new_tp, vocab)),
            np.asarray(tsp.unpack_rows(new_ap, vocab)))
    touched = np.zeros(vocab, bool)
    touched[np.unique(idx)] = True
    _assert_update(_plain(table, acc, rows, seg), want, table, acc, touched)


def test_row_offset_shards_compose_to_whole_table():
    """Two row shards, each updated with the GLOBAL rows and its row_offset,
    equal the unsharded update; positions of the other shard are skipped."""
    rng = np.random.RandomState(3)
    vocab, half = 2000, 1000
    idx = rng.randint(0, vocab, size=1800)
    rows, seg, _, table, acc = _case(idx, vocab, sentinels=3)
    whole = _plain(table, acc, rows, seg)
    lo = _plain(table[:half], acc[:half], rows, seg, row_offset=0)
    hi = _plain(table[half:], acc[half:], rows, seg, row_offset=half)
    # CPU index_add_ very rarely rounds a row differently between two
    # identical calls, so the composition is held to 1e-6, not bit equality.
    np.testing.assert_allclose(np.concatenate([lo[0], hi[0]]), whole[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([lo[1], hi[1]]), whole[1], rtol=1e-6, atol=1e-7)
    # The other shard's rows are left exactly as they were.
    assert np.array_equal(lo[0][np.setdiff1d(np.arange(half), idx)],
                          table[:half][np.setdiff1d(np.arange(half), idx)])


def test_zero_rows_and_sentinels_leave_table_bit_exact():
    vocab = 64
    table = np.random.RandomState(4).randn(vocab, 16).astype(np.float32)
    acc = np.ones((vocab, 16), np.float32)
    rows = np.array([5, 5, 9, vocab, vocab + 3], np.int32)
    seg = np.zeros((5, 16), np.float32)
    seg[3:] = 1.0                              # sentinels carry nonzero updates
    t, a = _plain(table, acc, rows, seg)
    np.testing.assert_array_equal(t, table)
    np.testing.assert_array_equal(a, acc)


def test_kernel_on_cpu_raises():
    t = torch.zeros(8, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tu.table_update(t, t.clone(), torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 16), LR, impl="kernel")
    assert sum(tu.LAUNCHES.values()) == 0
