"""Percent: the roofline bound of the launches the profiled slice's steps
need over the device time of the port's hand-written kernels in it."""

from lib import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
