"""Device-idle ms a group in gaps that began while the host's innermost open
span was the port's `search.finetune` (`search/worker.py :: _finetune`) or
a span inside it, over the profiled slice; None where the program records no
spans."""

from lib import program_spans


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    a = program_spans.analyse(ctx, spans)
    if a is None or not any(s.name == "search.finetune" for s in spans):
        return None
    idle = sum(end - start for start, end, s in a["gaps"]
               if s is not None and program_spans.within(s, "search.finetune"))
    return idle / 1e6 / a["units"]
