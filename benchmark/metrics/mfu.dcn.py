"""Percent of the H100's f32 peak (67 TFLOP/s) that the window's model FLOPs
(the reference's matmuls, forward and backward, of the steps done) fill."""

from lib import readers


def read(ctx):
    return readers.mfu(ctx)
