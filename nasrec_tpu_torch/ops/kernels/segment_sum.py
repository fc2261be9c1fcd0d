"""Duplicate-row segment-sum of the sparse step's stem gradient: the CUDA
kernel (`csrc/segment_sum.cu`) and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package computes it with XLA's sort,
cumsum and cummax (nasrec_tpu/train/sparse_embedding.py ::
rowwise_segment_sum_slotwise), and the plain version is that composite in
PyTorch.  Both versions take `idx2d` [B, C] fused-table rows and `g`
[B*C, E] in (b, c) row-major order, E in `WIDTHS` (16: NASRec's tables; 128:
DLRM-DCNv2's), and return (rows [C*B] sorted within each column, column after
column; seg [C*B, E] with each run of equal rows' sum at its last position and
exact zeros elsewhere; is_end [C*B] bool marking those positions).  The sort
is PyTorch's (stable) in both; the kernel sums each run directly, the plain
version as a difference of prefix sums.

Multi-hot bags (`segment_sum_bags`): `idx` [P] holds the fused rows of every
lookup of a step and `bag_of` [P] the bag each lookup was pooled into, whose
row of the pooled gradient `g` [bags, E] is the lookup's gradient.  All P
lookups are sorted as one column (each slot's rows lie above the previous
slot's, so one sort keeps the slots apart) and the kernel reads each lookup's
gradient from its bag's row: no [P, E] copy is made.  The outputs are those
above for that one column.  The plain version sums each run with index_add_.
"""

from __future__ import annotations

from collections import Counter

import torch

from nasrec_tpu_torch.ops.kernels import build

WIDTHS = (16, 128)
# Positions a block of the kernel at each width (csrc/segment_sum.cu: kTile),
# its entry point, and its launch counter's key.
TILE = {16: 256, 128: 64}
_ENTRY = {16: "nasrec_segment_sum", 128: "nasrec_segment_sum128"}
_KEY = {16: "segment_sum", 128: "segment_sum128"}

# Launches of the kernel, one a call (its tile pass and, where a column spans
# tiles, its carry pass), by width ("segment_sum": 16, "segment_sum128": 128);
# added to where it is launched and nowhere else.
LAUNCHES: Counter = Counter()


def _validate(idx2d, g):
    if (idx2d.dim() != 2 or g.dim() != 2 or g.shape[0] != idx2d.numel()
            or g.shape[1] not in WIDTHS):
        raise ValueError(f"idx2d [B, C] and g [B*C, E], E in {WIDTHS}, expected, got "
                         f"{tuple(idx2d.shape)} / {tuple(g.shape)}")


def _validate_bags(idx, bag_of, g):
    if (idx.dim() != 1 or tuple(bag_of.shape) != tuple(idx.shape) or g.dim() != 2
            or g.shape[1] not in WIDTHS):
        raise ValueError(f"idx [P], bag_of [P] and g [bags, E], E in {WIDTHS}, expected, "
                         f"got {tuple(idx.shape)} / {tuple(bag_of.shape)} / {tuple(g.shape)}")


def _check_operands(pairs, g) -> None:
    """Each (tensor, dtype, name) contiguous, of its dtype, on the card; g on
    a 16-byte boundary."""
    for x, dt, what in pairs:
        if x.dtype != dt or not x.is_contiguous() or not x.is_cuda:
            raise ValueError(f"segment_sum: {what} must be a contiguous {dt} CUDA tensor, "
                             f"got a {'' if x.is_contiguous() else 'non-contiguous '}"
                             f"{x.dtype} tensor on {x.device}")
    if g.data_ptr() % 16:
        raise ValueError("segment_sum: g must start on a 16-byte boundary (the kernel "
                         "moves a row in 16-byte pieces)")


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


def _launch(rows: torch.Tensor, order: torch.Tensor, g: torch.Tensor):
    """The kernel over `rows` [C, B] int32 (each column sorted) and `order`
    [C, B] int64 (position (c, j) takes row order[c, j] * C + c of g)."""
    c, b = rows.shape
    e = g.shape[1]
    seg = torch.empty(c * b, e, dtype=torch.float32, device=g.device)
    is_end = torch.empty(c * b, dtype=torch.bool, device=g.device)
    tiles = -(-b // TILE[e])
    tail = torch.empty(c * tiles * e, dtype=torch.float32, device=g.device)
    info = torch.empty(c * tiles * 2, dtype=torch.int32, device=g.device)
    lib = build.load_library("segment_sum")
    build.check(getattr(lib, _ENTRY[e])(
        rows.data_ptr(), order.data_ptr(), g.data_ptr(), seg.data_ptr(), is_end.data_ptr(),
        tail.data_ptr(), info.data_ptr(), b, c, build.current_stream()), "segment_sum")
    LAUNCHES[_KEY[e]] += 1
    return rows.reshape(-1), seg, is_end


def segment_sum_kernel(idx2d: torch.Tensor, g: torch.Tensor):
    """Sort each column of idx2d (PyTorch's stable sort, on the [C, B]
    transpose, so the sorted rows are already in the output's order), then
    launch the kernel."""
    _validate(idx2d, g)
    _check_operands(((idx2d, torch.int32, "idx2d"), (g, torch.float32, "g")), g)
    rows, order = torch.sort(idx2d.t().contiguous(), dim=1, stable=True)
    return _launch(rows, order, g)


def segment_sum(idx2d: torch.Tensor, g: torch.Tensor, impl: str = "auto"):
    """Duplicate-row segment-sum.  CUDA tensors go through the kernel, CPU
    tensors through the plain version; impl='plain' names it."""
    if build.resolve_impl(impl, idx2d) == "plain":
        return segment_sum_plain(idx2d, g)
    return segment_sum_kernel(idx2d, g)


def segment_sum_bags_plain(idx: torch.Tensor, bag_of: torch.Tensor, g: torch.Tensor):
    """Plain version of the bag segment-sum: sort, then each run's sum by
    index_add_ of its lookups' bag rows in sorted order (on the CPU in that
    order; on the card in the order of its atomics)."""
    _validate_bags(idx, bag_of, g)
    rows, order = torch.sort(idx, stable=True)
    g_sorted = g.index_select(0, bag_of.index_select(0, order))
    change = rows[1:] != rows[:-1]
    one = torch.ones(min(rows.numel(), 1), dtype=torch.bool, device=idx.device)
    is_end = torch.cat([change, one])
    run = torch.cumsum(torch.cat([one, change]), 0) - 1
    sums = torch.zeros_like(g_sorted).index_add_(0, run, g_sorted)
    seg = torch.where(is_end[:, None], sums.index_select(0, run), 0.0)
    return rows, seg, is_end


def segment_sum_bags_kernel(idx: torch.Tensor, bag_of: torch.Tensor, g: torch.Tensor):
    """Sort all lookups as one column (PyTorch's stable sort), map each sorted
    lookup to its bag, then launch the kernel with g the pooled gradient.
    `bag_of` must index rows of g (the stem's own map,
    `models/embedding.py :: EmbeddingStem.bag_index`)."""
    _validate_bags(idx, bag_of, g)
    _check_operands(((idx, torch.int32, "idx"), (bag_of, torch.int64, "bag_of"),
                     (g, torch.float32, "g")), g)
    rows, order = torch.sort(idx[None, :], dim=1, stable=True)
    return _launch(rows, bag_of[order], g)


def segment_sum_bags(idx: torch.Tensor, bag_of: torch.Tensor, g: torch.Tensor,
                     impl: str = "auto"):
    """Duplicate-row segment-sum of a multi-hot step's lookups.  CUDA tensors
    go through the kernel, CPU tensors through the plain version;
    impl='plain' names it."""
    if build.resolve_impl(impl, idx) == "plain":
        return segment_sum_bags_plain(idx, bag_of, g)
    return segment_sum_bags_kernel(idx, bag_of, g)
