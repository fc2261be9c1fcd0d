"""Device ms a step between the two CUDA events of the port's
`train.segment_sum` span (`train/sparse_embedding.py`: the duplicate-row
segment-sum inside the real step, on the cell's own batches), over the
profiled slice; None where the program records no such span."""

from lib import program_spans


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    a = program_spans.analyse(ctx, spans)
    times = [s.device_ms() for s in spans if s.name == "train.segment_sum"]
    if a is None or not times or None in times:
        return None
    return sum(times) / a["units"]
