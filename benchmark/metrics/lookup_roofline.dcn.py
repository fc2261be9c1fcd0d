"""Percent: the roofline bound of the slice's bag lookups
(`lib/roofline_wide.py`: each touched row read once, the indices, the pooled
bags written; the lookups counted by the program's `train.bag_positions`)
over the device time of the program's `train.lookup` spans."""

from lib import roofline_wide


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    nbytes = roofline_wide.slice_bytes(ctx, spans, "lookup")
    s, _ = roofline_wide.span_device_s(spans, "train.lookup")
    if nbytes is None or not s:
        return None
    return 100.0 * roofline_wide.bound_s(nbytes) / s
