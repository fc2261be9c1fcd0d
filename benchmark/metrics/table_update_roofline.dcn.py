"""Percent: the roofline bound of the slice's 128-wide table updates
(`lib/roofline_wide.py`: the indices read, a summed row read a touched row,
and each row the update writes, by the program's device counter
`train.rows_updated`, read and written once in the table and in its
accumulator) over the device time of the launches of
`table_update128_kernel`."""

from lib import roofline_wide


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    if not hasattr(tracing, "device_counts"):   # a program without device counters
        return None
    tr = ctx.get("trace")
    written = tracing.device_counts().get("train.rows_updated")
    nbytes = roofline_wide.slice_bytes(ctx, tracing.spans(), "table_update", written)
    if not tr or nbytes is None:
        return None
    s = roofline_wide.kernels_s(tr["kernels"], roofline_wide.TABLE_UPDATE_KERNELS)
    return 100.0 * roofline_wide.bound_s(nbytes) / s if s > 0 else None
