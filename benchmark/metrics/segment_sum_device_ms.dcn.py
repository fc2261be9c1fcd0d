"""Device ms a step between the two CUDA events of the port's
`train.segment_sum` span (the sort and the 128-wide segment-sum of the
step's lookups), over the profiled slice; None where the program records no
such span."""

from lib import program_spans, roofline_wide


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    a = program_spans.analyse(ctx, spans)
    s, _ = roofline_wide.span_device_s(spans, "train.segment_sum")
    if a is None or s is None:
        return None
    return 1e3 * s / a["units"]
