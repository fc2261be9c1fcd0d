"""Duplicate-row segment-sum of the sparse step's stem gradient: the CUDA
kernel (`csrc/segment_sum.cu`) and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package computes it with XLA's sort,
cumsum and cummax (nasrec_tpu/train/sparse_embedding.py ::
rowwise_segment_sum_slotwise), and the plain version is that composite in
PyTorch.  Both versions take `idx2d` [B, C] fused-table rows and `g`
[B*C, 16] in (b, c) row-major order and return (rows [C*B] sorted within each
column, column after column; seg [C*B, 16] with each run of equal rows' sum at
its last position and exact zeros elsewhere; is_end [C*B] bool marking those
positions).  The sort is PyTorch's (stable) in both; the kernel sums each run
directly, the plain version as a difference of prefix sums.
"""

from __future__ import annotations

from collections import Counter

import torch

from nasrec_tpu_torch.ops.kernels import build

EMB = 16
TILE = 256          # positions a block of the kernel (csrc/segment_sum.cu: kTile)

# Launches of the kernel, one a call (its tile pass and, where a column spans
# tiles, its carry pass); added to where it is launched and nowhere else.
LAUNCHES: Counter = Counter()


def _validate(idx2d, g):
    if idx2d.dim() != 2 or g.dim() != 2 or tuple(g.shape) != (idx2d.numel(), EMB):
        raise ValueError(f"idx2d [B, C] and g [B*C, {EMB}] expected, got "
                         f"{tuple(idx2d.shape)} / {tuple(g.shape)}")


def segment_sum_plain(idx2d: torch.Tensor, g: torch.Tensor):
    """Plain version: sort, cumsum over each column, each run's sum as the
    cumsum at its end less the cumsum before its start (a cummax of start
    positions finds it)."""
    b, s = idx2d.shape
    e = g.shape[-1]
    rows_bs, order_b = torch.sort(idx2d, dim=0, stable=True)
    g_sorted = torch.take_along_dim(g.reshape(b, s, e), order_b[:, :, None], dim=0)
    cs = torch.cumsum(g_sorted, dim=0)                                 # [B, S, E]
    change = rows_bs[1:] != rows_bs[:-1]
    ones = torch.ones((1, s), dtype=torch.bool, device=idx2d.device)
    is_end = torch.cat([change, ones], dim=0)                          # [B, S]
    is_start = torch.cat([ones, change], dim=0)
    iota = torch.arange(b, device=idx2d.device)[:, None].expand(b, s)
    # Each position's segment start: running maximum of start positions.
    start_idx = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    # base = cumsum one row above the segment start (zero for row-0 starts).
    base = torch.take_along_dim(cs, (start_idx - 1).clamp(min=0)[:, :, None], dim=0)
    base = torch.where((start_idx > 0)[:, :, None], base, 0.0)
    seg_col = torch.where(is_end[:, :, None], cs - base, 0.0)
    rows = rows_bs.t().reshape(-1)
    seg = seg_col.transpose(0, 1).reshape(b * s, e)
    return rows, seg, is_end.t().reshape(-1)


def segment_sum_kernel(idx2d: torch.Tensor, g: torch.Tensor):
    """Sort each column of idx2d (PyTorch's stable sort, on the [C, B]
    transpose, so the sorted rows are already in the output's order), then
    launch the kernel."""
    _validate(idx2d, g)
    for x, dt, what in ((idx2d, torch.int32, "idx2d"), (g, torch.float32, "g")):
        if x.dtype != dt or not x.is_contiguous() or not x.is_cuda:
            raise ValueError(f"segment_sum: {what} must be a contiguous {dt} CUDA tensor, "
                             f"got a {'' if x.is_contiguous() else 'non-contiguous '}"
                             f"{x.dtype} tensor on {x.device}")
    if g.data_ptr() % 16:
        raise ValueError("segment_sum: g must start on a 16-byte boundary (the kernel "
                         "moves a row in 16-byte pieces)")
    b, c = idx2d.shape
    rows, order = torch.sort(idx2d.t().contiguous(), dim=1, stable=True)
    seg = torch.empty(c * b, EMB, dtype=torch.float32, device=g.device)
    is_end = torch.empty(c * b, dtype=torch.bool, device=g.device)
    tiles = -(-b // TILE)
    tail = torch.empty(c * tiles * EMB, dtype=torch.float32, device=g.device)
    info = torch.empty(c * tiles * 2, dtype=torch.int32, device=g.device)
    lib = build.load_library("segment_sum")
    build.check(lib.nasrec_segment_sum(
        rows.data_ptr(), order.data_ptr(), g.data_ptr(), seg.data_ptr(), is_end.data_ptr(),
        tail.data_ptr(), info.data_ptr(), b, c, build.current_stream()), "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return rows.reshape(-1), seg, is_end


def segment_sum(idx2d: torch.Tensor, g: torch.Tensor, impl: str = "auto"):
    """Duplicate-row segment-sum.  CUDA tensors go through the kernel, CPU
    tensors through the plain version; impl='plain' names it."""
    if build.resolve_impl(impl, idx2d) == "plain":
        return segment_sum_plain(idx2d, g)
    return segment_sum_kernel(idx2d, g)
