"""Host ms a step in the port's `data.queue_wait` span (`data/pipeline.py ::
prefetch`: the step's feed blocked on the prefetch thread's queue), over the
profiled slice; None where the program records no spans."""

from lib import program_spans


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    a = program_spans.analyse(ctx, spans)
    if a is None or not any(s.name == "data.queue_wait" for s in spans):
        return None
    return 1e3 * program_spans.total_s(spans, "data.queue_wait") / a["units"]
