"""Percent of a group's wall time from its first call for the test batches
to its end, over the window's groups (host clock)."""


def read(ctx):
    share = ctx.get("eval_share")
    return None if share is None else 100.0 * share
