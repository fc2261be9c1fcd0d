"""95th percentile of the intervals between consecutive steps' end events
on the card over the window: the stalls of a starved input pipeline."""

from lib import window


def read(ctx):
    w = ctx.get("window")
    return window.percentile(w["unit_end_ms"], 95) if w and w["unit_end_ms"] else None
