"""Arithmetic the per-layer readers share: shares of the card's peak and of
the kernels' roofline, the idle share, and CUDA-event timing."""

from __future__ import annotations

import statistics

from lib import roofline


def mean_ms(values) -> float:
    return 1e3 * sum(values) / len(values) if values else None


def mfu(ctx):
    """Percent of the f32 peak: model FLOPs of the window's work over its time."""
    w = ctx.get("window")
    flops = ctx.get("window_flops")
    if flops is None and ctx.get("flops_per_unit") is not None:
        flops = ctx["flops_per_unit"] * w["units"]
    if not w or not flops:
        return None
    return 100.0 * flops / w["seconds"] / roofline.F32_FLOPS


def kernel_roofline(ctx):
    """Percent: the bound time of the launches the slice's work needs over the
    device time of the port's hand-written kernels in the slice."""
    tr = ctx.get("trace")
    if not tr or not ctx.get("bounds_per_unit_s"):
        return None
    spent = roofline.hand_written_s(tr["kernels"])
    if spent <= 0:
        return None
    return 100.0 * tr["units"] * ctx["bounds_per_unit_s"] / spent


def idle_share(ctx):
    """Percent of the profiled slice in which no operation ran on the card."""
    tr = ctx.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def cuda_ms(fn, groups: int = 5, per_group: int = 5, warmup: int = 3) -> float:
    """Median over `groups` of the mean CUDA-event time of `per_group`
    back-to-back calls, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(groups):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(per_group):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per_group)
    return statistics.median(times)
