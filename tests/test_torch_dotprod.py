"""Pairwise dot-product scores: the port's plain version, on the operands the
DotProduct node holds (x [B, 16], yt [B, 16, m]), against the JAX Pallas
kernel `dot_scores_tril_bmajor` run in interpret mode, forward and VJP, with
the [E, n, B] layout change; and the CUDA kernel's index walks (the forward's
table of register blocks, the backward's incremental walk of the triangle,
the multiply that stands for a division in the staging loop), rendered in plain Python and
held against `torch.tril_indices`.  The CUDA kernel itself runs on the card
only (tests/test_torch_cuda.py holds it against the plain version).

Tolerance (f32): rtol 1e-5 / atol 1e-6 forward; atol 1e-5 on the gradients,
which sum up to 45 products in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu.ops.kernels.dotprod_pallas import dot_scores_tril_bmajor

from nasrec_tpu_torch.ops.kernels import dotprod

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [2, 3, 17, 46])
def test_plain_matches_pallas_interpret(n):
    rng = np.random.RandomState(n)
    e, b, m = 16, 24, n - 1
    x_be = rng.randn(b, e).astype(np.float32)
    yt_bem = rng.randn(b, e, m).astype(np.float32)
    co = rng.randn(b, dotprod.tril_size(n)).astype(np.float32)

    # The TPU kernel's operand t[E, n, B]: row 0 the dense row, row 1 + k slot k.
    t_enb = np.concatenate([x_be.T[:, None, :], yt_bem.transpose(1, 2, 0)], axis=1)
    z_j, vjp = jax.vjp(lambda t: dot_scores_tril_bmajor(t, True), jnp.asarray(t_enb))
    dt_j = np.asarray(vjp(jnp.asarray(co.T))[0])

    x = torch.from_numpy(x_be).requires_grad_(True)
    yt = torch.from_numpy(yt_bem).requires_grad_(True)
    z = dotprod.dot_scores_tril(x, yt)          # CPU tensors -> the plain version
    z.backward(torch.from_numpy(co))

    assert z.shape == (b, dotprod.tril_size(n))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), dt_j[:, 0, :].T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), dt_j[:, 1:, :].transpose(2, 0, 1),
                               rtol=1e-5, atol=1e-5)


def test_triangle_order_is_row_major():
    # z[p(i, j)] with p = i(i-1)/2 + j: for n = 4 the pairs are
    # (1,0) (2,0) (2,1) (3,0) (3,1) (3,2); row 0 is x, rows 1.. the slots.
    x = torch.zeros(1, 16)
    yt = torch.zeros(1, 16, 3)
    x[0, 0] = 1.0
    yt[0, 0, :] = torch.tensor([2.0, 3.0, 5.0])
    z = dotprod.dot_scores_tril_plain(x, yt)[0].tolist()
    assert z == [2.0, 3.0, 6.0, 5.0, 10.0, 15.0]


def _tril_pairs(n):
    return [tuple(p) for p in torch.tril_indices(n, n, -1).T.tolist()]


def _forward_walk(n):
    """The pair (i, j) the forward kernel writes at each position p of a z
    row: every 4 x 4 register block of the table, masked as dot_fwd_kernel
    masks it."""
    ld = -(-n // 4) * 4
    written = {}
    for i0, j0 in dotprod.tile_table(n):
        # 16-byte loads of 4 values inside a feature's run of ld floats.
        assert i0 % 4 == 0 and j0 % 4 == 0 and i0 + 4 <= ld and j0 + 4 <= ld
        for a in range(4):
            i = i0 + a
            if i < n:
                base = i * (i - 1) // 2
                for b in range(4):
                    if j0 + b < i:
                        assert base + j0 + b not in written
                        written[base + j0 + b] = (i, j0 + b)
    return [written[p] for p in range(dotprod.tril_size(n))]


def _backward_walk(n):
    """For each operand row i, the (j, position of dz) pairs in the order
    dot_bwd_kernel adds them (operand rows j four at a time), and the largest
    position any thread reads."""
    out, top = {}, 0
    for i0 in range(0, n, 4):
        base = [min(i0 + a, n - 1) * (min(i0 + a, n - 1) - 1) // 2 for a in range(4)]
        walk = [[] for _ in range(4)]
        for jb in range(0, i0, 4):                        # below the block
            for jj in range(4):
                for a in range(4):
                    walk[a].append((jb + jj, base[a] + jb + jj))
        for jj in range(4):                               # inside the block
            j = i0 + jj
            if j < n:
                bj = j * (j - 1) // 2
                for a in range(4):
                    if a != jj:
                        walk[a].append((j, bj + i0 + a if a < jj else base[a] + j))
        bj = (i0 + 4) * (i0 + 3) // 2 + i0
        for jb in range(i0 + 4, n, 4):                    # above the block
            for jj in range(4):
                j = jb + jj
                if j < n:
                    for a in range(4):
                        walk[a].append((j, bj + a))
                    bj += j
        for a in range(4):
            top = max([top] + [p for _, p in walk[a]])
            if i0 + a < n:
                out[i0 + a] = walk[a]
    return out, top


@pytest.mark.parametrize("n", range(2, 49))
def test_kernel_index_walks_match_tril_indices(n):
    pairs = _tril_pairs(n)
    assert _forward_walk(n) == pairs
    position = {pair: p for p, pair in enumerate(pairs)}
    walk, top = _backward_walk(n)
    for i in range(n):
        assert [j for j, _ in walk[i]] == [j for j in range(n) if j != i]
        assert all(p == position[(max(i, j), min(i, j))] for j, p in walk[i])
    # Rows past n - 1 in the last block of four read at most one float past the z row.
    assert top <= dotprod.tril_size(n)
    # The staging loop's division by m as one multiply: q = (idx * magic) >> 32,
    # over a tile of up to 32 batch rows of 16 features.
    m = n - 1
    if m > 1:
        magic = ((1 << 32) + m - 1) // m
        idx = np.arange(32 * 16 * m, dtype=np.uint64)
        assert np.array_equal((idx * np.uint64(magic)) >> np.uint64(32), idx // np.uint64(m))


def test_launch_shapes_fit_the_card():
    for n in (2, 9, 17, 40, 46, 64):
        tb, threads = dotprod.fwd_config(n)
        assert dotprod.fwd_smem_bytes(n, tb) <= dotprod.SMEM_MAX and tb >= 1
        te, tb, threads_b = dotprod.bwd_config(n)
        assert dotprod.bwd_smem_bytes(n, tb) <= dotprod.SMEM_MAX and tb >= 1
        assert threads % 32 == 0 and threads_b % 32 == 0 and te in (4, 8)
    with pytest.raises(ValueError, match="shared memory"):
        dotprod.bwd_config(400)


def test_kernel_on_cpu_raises():
    x, yt = torch.zeros(2, 16), torch.zeros(2, 16, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        dotprod.dot_scores_tril(x, yt, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        dotprod.dot_scores_tril_fwd_kernel(x, yt)
    with pytest.raises(ValueError, match="CUDA"):
        dotprod.dot_scores_tril_bwd_kernel(x, yt, torch.zeros(2, 10))
    assert sum(dotprod.LAUNCHES.values()) == 0
