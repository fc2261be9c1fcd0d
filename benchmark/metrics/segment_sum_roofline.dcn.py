"""Percent: the roofline bound of the slice's 128-wide segment-sums
(`lib/roofline_wide.py`: the pooled gradient and the indices read once, a
summed row written a touched row) over the device time of the launches of
the kernel's `__global__` functions (`segsum_tile128_kernel`,
`segsum_walk128_kernel`; the sort before them is not the kernel's)."""

from lib import roofline_wide


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    tr = ctx.get("trace")
    nbytes = roofline_wide.slice_bytes(ctx, tracing.spans(), "segment_sum")
    if not tr or nbytes is None:
        return None
    s = roofline_wide.kernels_s(tr["kernels"], roofline_wide.SEGMENT_SUM_KERNELS)
    return 100.0 * roofline_wide.bound_s(nbytes) / s if s > 0 else None
