"""Host ms a step spent in next() on the batch feed, mean over the window."""

from lib import readers


def read(ctx):
    w = ctx.get("window")
    return readers.mean_ms(w["wait_s"]) if w else None
