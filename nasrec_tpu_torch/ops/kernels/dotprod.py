"""Pairwise dot-product scores, strict lower triangle: the CUDA kernel
(`csrc/dotprod.cu`) and its plain PyTorch version.

Replaces nasrec_tpu/ops/kernels/dotprod_pallas.py :: dot_scores_tril_bmajor.
The TPU kernel takes batch-on-lanes t[E, n, B].  This one takes the operands
as the DotProduct node holds them, the projected dense row x [B, 16] and the
projected slots yt [B, 16, m] (feature-major, slot-minor), and writes z [B, P]
(P = n(n-1)/2, n = m + 1, row-major triangle order, ref modules.py:366-383),
the layout the out-projection consumes.  Row 0 of the triangle's operand is
x, row 1 + k is slot k.  The backward is a kernel too: it computes dx and dyt
straight from dz, in the operands' own layouts (see the .cu file).  x, yt, z,
dz, dx and dyt are float32 or bfloat16 (one dtype for all); a bf16 kernel sums
in f32 and rounds each output once, and so does the plain version.  Under
`torch.func.vmap` over K candidates the kernels launch once at batch K B
(`ops/kernels/candidates.py`): there are no weights, so the candidates'
rows are just more rows.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, Tuple

import torch

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.ops.kernels import build, candidates
from nasrec_tpu_torch.ops.kernels.attention import check_activation_dtype, dtype_suffix

EMB = 16
SMEM_MAX = 232_448       # bytes of shared memory a block can use on an H100

# Launches of each kernel, keyed "fwd_n<n>" / "bwd_n<n>" (with "_bf16" added
# for a bf16 launch); added to where a kernel is launched and nowhere else.
LAUNCHES: Counter = Counter()

# Launch shapes that replace the defaults of `fwd_config` / `bwd_config`,
# keyed ("fwd" or "bwd", n); `tools/dotprod_tune.py` fills it to compare shapes.
TUNE: Dict[Tuple[str, int], tuple] = {}

_TILE_TABLES: Dict[tuple, torch.Tensor] = {}


def tril_size(n: int) -> int:
    return n * (n - 1) // 2


def matmul_flops(b: int, n: int) -> int:
    """Matmul FLOPs of one forward at batch b and n = m + 1 rows, as the
    dispatcher counts the plain version's product (the full [n, n] scores a
    batch row, 2·n·n·16, of which the kernel keeps the lower triangle; the
    JAX package's einsum counts the same).  A backward counts twice this:
    the product's two input gradients."""
    return 2 * b * n * n * EMB


def _tril_flat_index(n: int, device) -> torch.Tensor:
    r, c = torch.tril_indices(n, n, -1, device=device)  # row-major order
    return r * n + c


def dot_scores_tril_plain(x: torch.Tensor, yt: torch.Tensor) -> torch.Tensor:
    """Plain version: x [B, E], yt [B, E, m] -> z [B, n(n-1)/2], n = m + 1
    (concat, einsum and a gather of the triangle).  bf16 operands are summed
    in f32 and z rounded once, as the kernel does."""
    if x.dtype != torch.float32:
        return dot_scores_tril_plain(x.float(), yt.float()).to(x.dtype)
    t = torch.cat([x[:, None, :], yt.transpose(1, 2)], dim=1)     # [B, n, E]
    b, n, _ = t.shape
    z = torch.einsum("bne,bme->bnm", t, t)
    return z.reshape(b, n * n)[:, _tril_flat_index(n, t.device)]


BLOCK = 4                # the forward kernel's register block: 4 x 4 pairs a thread


def tile_table(n: int) -> list:
    """(i0, j0) of every 4 x 4 register block of the forward kernel that holds
    a pair j < i < n, column by column: the threads of a warp then share the
    j side of a block, and their stores into the staged z rows fall into
    different banks."""
    return [(i0, j0) for j0 in range(0, n, BLOCK) for i0 in range(0, n, BLOCK)
            if j0 < min(i0 + BLOCK, n) - 1]


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def _staged(count: int) -> int:
    return _round_up(count + 3, 4) + 8


def _operand_floats(n: int, tb: int) -> int:
    """Both buffers of a staged operand tile: features `ld` floats apart, a
    multiple of 4, batch rows 16 * ld + 4."""
    return 2 * (tb * (EMB * _round_up(n, 4) + 4) + 8)


def fwd_smem_bytes(n: int, tb: int) -> int:
    """Dynamic shared memory of the forward kernel (as `launch_fwd` sizes it)."""
    return 4 * (_operand_floats(n, tb) + _staged(tb * tril_size(n))) + 8 * len(tile_table(n))


def bwd_smem_bytes(n: int, tb: int) -> int:
    """Dynamic shared memory of the backward kernel (as `launch_bwd` sizes it)."""
    return 4 * (_operand_floats(n, tb) + 2 * _staged(tb * tril_size(n))
                + _staged(tb * EMB * (n - 1)) + _staged(tb * EMB))


def _rows_per_tile(bytes_at, budget: int, what: str, n: int) -> int:
    """The most batch rows (up to 32) whose tile fits `budget` bytes."""
    if bytes_at(1) > SMEM_MAX:
        raise ValueError(f"{what}: n = {n} needs {bytes_at(1)} bytes of shared memory "
                         f"for one batch row, more than the {SMEM_MAX} a block can use")
    tb = 1
    while tb < 32 and bytes_at(tb + 1) <= budget:
        tb += 1
    return tb


@functools.lru_cache(maxsize=None)
def _default_fwd_config(n: int) -> tuple:
    tb = _rows_per_tile(lambda r: fwd_smem_bytes(n, r), 44 * 1024, "dot_scores_tril", n)
    return tb, 256 if tb * len(tile_table(n)) >= 256 else 128


@functools.lru_cache(maxsize=None)
def _default_bwd_config(n: int) -> tuple:
    # From the sweep of `tools/dotprod_tune.py` at n = 46, 40, 17, 9: tiles of 4
    # batch rows and 4 features a thread for a wide operand, 8 and 8 for a narrow.
    te, most = (8, 8) if n <= 32 else (4, 4)
    tb = min(most, _rows_per_tile(lambda r: bwd_smem_bytes(n, r), 100 * 1024,
                                  "dot_scores_tril backward", n))
    tasks = tb * _round_up(n, 4) // 4 * (EMB // te)
    return te, tb, min(256, _round_up(tasks, 32))


def fwd_config(n: int) -> tuple:
    """(tb, threads) of the forward launch: batch rows a tile, threads a block."""
    return TUNE.get(("fwd", n)) or _default_fwd_config(n)


def bwd_config(n: int) -> tuple:
    """(te, tb, threads) of the backward launch: features a thread (4 or 8),
    batch rows a tile, threads a block."""
    return TUNE.get(("bwd", n)) or _default_bwd_config(n)


def _check(t: torch.Tensor, what: str, shape: tuple, dtype: torch.dtype) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")


def _check_operands(x: torch.Tensor, yt: torch.Tensor) -> Tuple[int, int]:
    if x.dim() != 2 or yt.dim() != 3 or yt.shape[2] < 1:
        raise ValueError(f"dot_scores_tril: x must be [B, {EMB}] and yt [B, {EMB}, m >= 1], "
                         f"got {tuple(x.shape)} and {tuple(yt.shape)}")
    b, m = x.shape[0], yt.shape[2]
    dtype = check_activation_dtype(x, "dot_scores_tril (x)")
    _check(x, "dot_scores_tril (x)", (b, EMB), dtype)
    _check(yt, "dot_scores_tril (yt)", (b, EMB, m), dtype)
    if yt.device != x.device:
        raise ValueError("dot_scores_tril: x and yt lie on different devices")
    if dtype == torch.bfloat16 and (x.data_ptr() % 16 or yt.data_ptr() % 16):
        raise ValueError("dot_scores_tril: the bf16 kernels load x and yt 16 bytes at a "
                         "time and need each tensor's first element aligned to 16 bytes")
    return b, m + 1


def dot_scores_tril_fwd_kernel(x: torch.Tensor, yt: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: x [B, 16], yt [B, 16, m] -> z [B, P]."""
    b, n = _check_operands(x, yt)
    tb, threads = fwd_config(n)
    tiles = _TILE_TABLES.get((n, x.device))
    if tiles is None:
        tiles = _TILE_TABLES[(n, x.device)] = torch.tensor(tile_table(n), dtype=torch.int32,
                                                           device=x.device)
    z = torch.empty((b, tril_size(n)), device=x.device, dtype=x.dtype)
    lib = build.load_library("dotprod")
    sfx = dtype_suffix(x.dtype)
    build.check(getattr(lib, f"nasrec_dotprod_fwd{sfx}")(
        x.data_ptr(), yt.data_ptr(), z.data_ptr(), tiles.data_ptr(), tiles.shape[0], b, n,
        tb, threads, build.current_stream()), "dotprod fwd")
    LAUNCHES[f"fwd_n{n}{sfx}"] += 1
    profiling.report_matmul_flops(matmul_flops(b, n))
    return z


def dot_scores_tril_bwd_kernel(x: torch.Tensor, yt: torch.Tensor, dz: torch.Tensor):
    """Launch the backward kernel: (x [B, 16], yt [B, 16, m], dz [B, P]) ->
    (dx [B, 16], dyt [B, 16, m])."""
    b, n = _check_operands(x, yt)
    _check(dz, "dot_scores_tril backward (dz)", (b, tril_size(n)), x.dtype)
    te, tb, threads = bwd_config(n)
    dx, dyt = torch.empty_like(x), torch.empty_like(yt)
    lib = build.load_library("dotprod")
    sfx = dtype_suffix(x.dtype)
    build.check(getattr(lib, f"nasrec_dotprod_bwd{sfx}")(
        x.data_ptr(), yt.data_ptr(), dz.data_ptr(), dx.data_ptr(), dyt.data_ptr(), b, n, te,
        tb, threads, build.current_stream()), "dotprod bwd")
    LAUNCHES[f"bwd_n{n}{sfx}"] += 1
    profiling.report_matmul_flops(2 * matmul_flops(b, n))
    return dx, dyt


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where it is bf16 and its first element is off a
    16-byte boundary (a view into a larger tensor): the bf16 kernels load x
    and yt 16 bytes at a time, the f32 ones 4."""
    return t.clone() if t.dtype == torch.bfloat16 and t.data_ptr() % 16 else t


class _DotScoresTril(torch.autograd.Function):
    # forward gets plain tensors, whether the wrapper or the vmap rule calls
    # it: it lays the operands out for the kernels and returns them (as
    # views, which setup_context may save) beside z, so that backward reads
    # the same copies.
    @staticmethod
    def forward(x, yt):
        x, yt = _aligned(x.contiguous()), _aligned(yt.contiguous())
        return dot_scores_tril_fwd_kernel(x, yt), x.view_as(x), yt.view_as(yt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, x, yt = output
        ctx.mark_non_differentiable(x, yt)
        ctx.save_for_backward(x, yt)

    @staticmethod
    def backward(ctx, dz, _dx, _dyt):
        x, yt = ctx.saved_tensors
        return dot_scores_tril_bwd_kernel(x, yt, dz.contiguous())

    @staticmethod
    def vmap(info, in_dims, x, yt):
        # K candidates: one launch at batch K B, forward and backward.
        k = info.batch_size
        out = _DotScoresTril.apply(candidates.fold(x, in_dims[0], k),
                                   candidates.fold(yt, in_dims[1], k))
        return tuple(candidates.unfold(t, k) for t in out), (0, 0, 0)


def dot_scores_tril(x: torch.Tensor, yt: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """z[b, p(i,j)] = <t[b,i], t[b,j]> for j < i, where t[b,0] = x[b] and
    t[b,1+k] = yt[b,:,k]; x [B, 16], yt [B, 16, m] -> [B, (m+1)m/2].

    CUDA tensors go through the kernel (forward and backward); CPU tensors
    through the plain version.  impl='plain' names the plain version."""
    if build.resolve_impl(impl, x) == "plain":
        return dot_scores_tril_plain(x, yt)
    return _DotScoresTril.apply(x, yt)[0]
