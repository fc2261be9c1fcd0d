"""The least time DLRM-DCNv2's 128-wide table work needs on the card: the
roofline bounds of its lookup, its segment-sum and its table update
(`lib/roofline.py` is the 16-wide arithmetic of NASRec's kernels, with the
card's peaks).

Each bound counts the least bytes the work needs, whatever implements it:
each table row the batch touches read once (not once a lookup: a row that
several lookups share, or a small table's rows, can stay in the L2 cache),
the pooled gradient read once, one summed row written for each touched
row, and each index read once.  All three are bound by bytes: the table
update's 6 f32 operations an element are far below the card's rate.

    lookup        touched rows read, indices read, pooled bags [B*S, 128]
                  written;
    segment-sum   pooled gradient [B*S, 128] read, indices read, a summed
                  row written a touched row;
    table update  indices read, a summed row read a touched row, and each
                  row the update writes (a touched row whose summed gradient
                  is not zero: the program's device counter
                  `train.rows_updated`, which the table update kernel adds
                  to) of the table and of its accumulator read and written.

At the cell's step (16384 rows, 3,506,176 lookups, about 2.55 M touched
rows, all of them updated): about 1.54 GB, 1.54 GB and 6.54 GB, that is
0.46, 0.46 and 1.95 ms.  Where some examples' losses saturate, their bags'
gradients are zero and the rows only they touch are not written.
"""

from __future__ import annotations

from lib.roofline import HBM_BYTES_S

WIDTH = 128
ROW_BYTES = 4 * WIDTH

# The 128-wide kernels' `__global__` names in nasrec_tpu_torch/csrc/*.cu, as
# a device trace shows them.
SEGMENT_SUM_KERNELS = ("segsum_tile128_kernel", "segsum_walk128_kernel")
TABLE_UPDATE_KERNELS = ("table_update128_kernel",)


def lookup_bytes(positions: int, unique_rows: int, bags: int) -> int:
    return unique_rows * ROW_BYTES + positions * 4 + bags * ROW_BYTES


def segment_sum_bytes(positions: int, unique_rows: int, bags: int) -> int:
    return bags * ROW_BYTES + positions * 4 + unique_rows * ROW_BYTES


def table_update_bytes(positions: int, unique_rows: int, updated_rows: int) -> int:
    return positions * 4 + unique_rows * ROW_BYTES + updated_rows * 4 * ROW_BYTES


def bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_S


def kernels_s(kernels, names) -> float:
    """Device seconds of the launches among (name, start_ns, end_ns) whose
    name holds one of `names`."""
    return sum(e - s for n, s, e in kernels if any(k in n for k in names)) / 1e9


def span_device_s(spans, name: str) -> tuple:
    """(device seconds between the CUDA events of the program's spans `name`,
    how many) over the slice; (None, 0) where there is no such span or one
    has no events."""
    times = [s.device_ms() for s in spans if s.name == name]
    if not times or None in times:
        return None, 0
    return sum(times) / 1e3, len(times)


def counted(spans, span: str, counter: str) -> int:
    """The program's counter `counter` summed over its spans `span` in the
    slice."""
    return sum(s.counts[counter] for s in spans if s.name == span and s.counts)


def slice_bytes(ctx, spans, kind: str, rows_written=None):
    """Least bytes of the slice's `kind` work ("lookup", "segment_sum",
    "table_update"), from the lookups the program counted, the rows the
    slice's batches touch (`ctx["unique_rows_slice"]`) and, for the table
    update, the rows it wrote over the slice (`rows_written`); None without
    them."""
    n = len([s for s in spans if s.name == "train.lookup"])
    positions = counted(spans, "train.lookup", "train.bag_positions")
    if not n or not positions or "unique_rows_slice" not in ctx:
        return None
    unique, bags = ctx["unique_rows_slice"], n * ctx["bags_per_unit"]
    if kind == "lookup":
        return lookup_bytes(positions, unique, bags)
    if kind == "segment_sum":
        return segment_sum_bytes(positions, unique, bags)
    return table_update_bytes(positions, unique, rows_written) if rows_written else None
