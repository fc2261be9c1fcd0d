"""Host ms a group in the port's `search.score` span (`search/worker.py ::
_score`: log-loss and exact AUC of the group's candidates on the host, the
card holding nothing of the group), over the profiled slice; None where the
program records no spans."""

from lib import program_spans


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    a = program_spans.analyse(ctx, spans)
    if a is None or not any(s.name == "search.score" for s in spans):
        return None
    return 1e3 * program_spans.total_s(spans, "search.score") / a["units"]
