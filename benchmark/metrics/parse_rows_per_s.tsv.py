"""Rows a second of the port's C++ parser as the stream runs: the rows
counted (`data.rows_parsed`) inside the slice's whole `data.parse` spans
(`data/native/binding.py`, on the prefetch thread) over those spans' seconds;
None where the program records no spans."""

from lib import program_spans


def read(ctx):
    try:
        from nasrec_tpu_torch import tracing
    except ImportError:         # a program without the recorder
        return None
    spans = tracing.spans()
    if program_spans.analyse(ctx, spans) is None:
        return None
    parse = [s for s in spans if s.name == "data.parse"]
    rows = sum((s.counts or {}).get("data.rows_parsed", 0) for s in parse)
    secs = program_spans.total_s(parse, "data.parse")
    return rows / secs if rows and secs > 0 else None
