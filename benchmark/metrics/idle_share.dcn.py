"""Percent of the profiled slice in which nothing ran on the card."""

from lib import readers


def read(ctx):
    return readers.idle_share(ctx)
