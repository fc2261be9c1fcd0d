"""Touched-row Adagrad update of the fused [vocab, E] table, E in `WIDTHS`
(16: NASRec's tables; 128: DLRM-DCNv2's): the CUDA kernel
(`csrc/table_update.cu`, one instance a width) and its plain PyTorch version.

Replaces nasrec_tpu/ops/kernels/table_sweep_pallas.py :: sweep_adagrad_update
with the same contract (table, acc, rows, seg16, lr, eps, row_offset), on the
plain [vocab, E] layout: the packed [T/8, 128] layout and the sweep schedule
exist only for the TPU's lane tiling and are not ported.  Both versions update
`table` and `acc` in place and return them.  Given `written` (a one-element
int64 tensor on the table's device), they add to it the number of rows they
write: the plain version at either width, the kernel at width 128.
"""

from __future__ import annotations

from collections import Counter

import torch

from nasrec_tpu_torch.ops.kernels import build

WIDTHS = (16, 128)
# The kernel's entry point and its launch counter's key at each width.
_ENTRY = {16: "nasrec_table_update", 128: "nasrec_table_update128"}
_KEY = {16: "table_update", 128: "table_update128"}

# Launches of the kernel, by width ("table_update": 16, "table_update128":
# 128); added to where it is launched and nowhere else.
LAUNCHES: Counter = Counter()


def _validate(table, acc, rows, seg16, written):
    if table.dim() != 2 or table.shape[1] not in WIDTHS or acc.shape != table.shape:
        raise ValueError(f"table/acc must both be [vocab, E], E in {WIDTHS}, got "
                         f"{tuple(table.shape)} / {tuple(acc.shape)}")
    if rows.dim() != 1 or tuple(seg16.shape) != (rows.shape[0], table.shape[1]):
        raise ValueError(f"rows [N] and seg16 [N, {table.shape[1]}] expected, got "
                         f"{tuple(rows.shape)} / {tuple(seg16.shape)}")
    if written is not None and (written.dtype != torch.int64 or written.numel() != 1
                                or written.device != table.device):
        raise ValueError(f"written must be one int64 on {table.device}, got "
                         f"{written.dtype} {tuple(written.shape)} on {written.device}")


def table_update_plain(table, acc, rows, seg16, lr: float, eps: float = 1e-2,
                       row_offset: int = 0, written=None):
    """Plain version: index_add_ of d*d and -lr*d/(sqrt(acc+d*d)+eps) at the
    positions that carry a nonzero update and whose row lies in
    [row_offset, row_offset + vocab)."""
    _validate(table, acc, rows, seg16, written)
    local = rows.long() - row_offset
    keep = (local >= 0) & (local < table.shape[0]) & (seg16 != 0).any(dim=1)
    if written is not None:
        written += keep.sum()
    r = local[keep]
    d = seg16[keep]
    sq = d * d
    denom = torch.sqrt(acc.index_select(0, r) + sq) + eps
    acc.index_add_(0, r, sq)
    table.index_add_(0, r, -(lr * d) / denom)
    return table, acc


def table_update_kernel(table, acc, rows, seg16, lr: float, eps: float = 1e-2,
                        row_offset: int = 0, written=None):
    """Launch the kernel (in place)."""
    _validate(table, acc, rows, seg16, written)
    width = table.shape[1]
    if written is not None and width != 128:
        raise ValueError(f"table_update: the {width}-wide kernel counts no rows; "
                         "written is taken at width 128")
    for x, dt, what in ((table, torch.float32, "table"), (acc, torch.float32, "acc"),
                        (rows, torch.int32, "rows"), (seg16, torch.float32, "seg16")):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"table_update: {what} must be a contiguous {dt} CUDA "
                             f"tensor, got {x.dtype} on {x.device}")
        if what != "rows" and x.data_ptr() % 16:
            raise ValueError(f"table_update: {what} must start on a 16-byte boundary "
                             "(the kernel moves a row in 16-byte pieces)")
    args = (table.data_ptr(), acc.data_ptr(), rows.data_ptr(), seg16.data_ptr(),
            rows.shape[0], table.shape[0], int(row_offset), float(lr), float(eps))
    if width == 128:
        args += (None if written is None else written.data_ptr(),)
    lib = build.load_library("table_update")
    build.check(getattr(lib, _ENTRY[width])(*args, build.current_stream()), "table_update")
    LAUNCHES[_KEY[width]] += 1
    return table, acc


def table_update(table, acc, rows, seg16, lr: float, eps: float = 1e-2,
                 row_offset: int = 0, impl: str = "auto", written=None):
    """Touched-row Adagrad update, in place.  A CUDA table goes through the
    kernel, a CPU table through the plain version; impl='plain' names it."""
    if build.resolve_impl(impl, table) == "plain":
        return table_update_plain(table, acc, rows, seg16, lr, eps, row_offset, written)
    return table_update_kernel(table, acc, rows, seg16, lr, eps, row_offset, written)
