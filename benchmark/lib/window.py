"""The measured window and the profiled slice that follows it in a traced run.

`run_window` calls `body(i)` until `seconds` of host time have passed since
the window opened, then waits for the card.  `body` does one unit of the
cell's work (a training step, a candidate group), returns its loss tensor or
None, and reports the host seconds it spent waiting for input and inside the
program's call.  A CUDA event recorded after each unit gives the intervals
between units as the card finished them.  The loss comes back to the host
every `sync_every` units, as the port's training loop reads it, and at no
other point inside the window.

`profile_slice` runs `units` more of the same under torch.profiler, tracing
the card alone (no host operations: their recording costs the host more than
an xlarge step leaves it), with the benchmark's own spans around its calls
into the program kept on the host clock, and reduces the trace: device busy
time (the union of the intervals in which some operation ran on the card),
the operations that took most time, and the idle gaps by the span that was
open on the host when each gap began.  The host clock is tied to the
trace's by the synchronize calls that open and close the slice, which the
trace records as CUDA runtime calls.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

SYNC_CALL = "cudaDeviceSynchronize"


class Spans:
    """`with spans("name"):` logs (name, start, end) in host ns
    (`time.perf_counter_ns`) while a slice is being profiled, and does
    nothing otherwise."""

    def __init__(self):
        self.on = False
        self.log: List[tuple] = []

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.log.append((name, t0, time.perf_counter_ns()))

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()


def run_window(body: Callable[[int], tuple], seconds: float, sync_every: int, device,
               first: int = 0) -> Dict:
    """-> {'units', 'seconds', 'unit_end_ms' (intervals between consecutive
    units' ends on the card), 'wait_s', 'host_s' (host seconds a unit spent
    waiting for input / inside the program), 'nonfinite' (loss readings that
    were not finite), 'losses'}."""
    events: List[torch.cuda.Event] = []
    cuda = torch.device(device).type == "cuda"
    wait, host, losses, nonfinite = [], [], [], 0
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        events.append(start)
    t0 = time.perf_counter()
    i = 0
    while True:
        loss, w, h = body(first + i)
        i += 1
        wait.append(w)
        host.append(h)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        done = time.perf_counter() - t0 >= seconds
        if loss is not None and (i % sync_every == 0 or done):
            v = float(loss)
            losses.append(v)
            nonfinite += not math.isfinite(v)
        if done:
            break
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])] if cuda else []
    return {"units": i, "seconds": elapsed, "unit_end_ms": gaps, "wait_s": wait,
            "host_s": host, "losses": losses, "nonfinite": nonfinite}


def host_summary(w: Dict) -> str:
    """Host ms a unit in the feed and in the program's call, 5th / 50th /
    95th percentiles, and the card's unit intervals likewise."""
    parts = []
    for name, vals, scale in (("wait", w["wait_s"], 1e3), ("host", w["host_s"], 1e3),
                              ("card", w["unit_end_ms"], 1.0)):
        if vals:
            parts.append(f"{name} ms " + "/".join(f"{percentile(vals, q) * scale:.3f}"
                                                  for q in (5, 50, 95)))
    return "; ".join(parts)


def slice_summary(trace: Dict, w: Dict) -> str:
    """The profiled slice beside the window: a unit's time in each (the
    profiler's own cost shows as a longer unit in the slice), and how far the
    tie between the host's clock and the trace's drifted over the slice."""
    drift = trace["anchor_drift_us"]
    return (f"trace: {trace['units']} units in {trace['window_s']:.6f} s, "
            f"{trace['window_s'] / trace['units'] * 1e3:.3f} ms a unit (window "
            f"{w['seconds'] / w['units'] * 1e3:.3f}), busy {trace['busy_s']:.6f} s; clock tie "
            + ("not found" if drift is None else f"drift {drift:.1f} us"))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def profile_slice(body: Callable[[int], tuple], units: int, spans: Spans, device,
                  first: int) -> Dict:
    """Profile `units` more units; -> {'units', 'window_s', 'busy_s',
    'kernels': [(name, start_ns, end_ns)] of every device operation, 'device_ops',
    'idle_gaps', 'anchor_drift_us'}."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        raise RuntimeError("a device trace needs a CUDA card")
    torch.cuda.synchronize(device)
    spans.log = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        spans.on = True
        try:
            for i in range(units):
                body(first + i)
            with spans("sync"):
                torch.cuda.synchronize(device)
        finally:
            spans.on = False
        h1 = time.perf_counter_ns()
    return reduce_trace(prof.profiler.kineto_results.events(), units, spans.log, h0, h1)


def _union(intervals):
    total, cur_s, cur_e, merged = 0, None, None, []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    for s, e in merged:
        total += e - s
    return total, merged


def reduce_trace(events, units: int, span_log: List[tuple], h0: int, h1: int) -> Dict:
    """Busy and idle time of the card in the slice from `h0` to `h1` (host
    ns, `time.perf_counter_ns`), from kineto events (their own clock, ns).
    Every device operation in the trace is the slice's: the card was idle
    when the profiler started.  The two clocks are tied by the ends of the
    slice's synchronize calls, which returned at `h0` and just before `h1`."""
    dev = [(e.name(), e.start_ns(), e.end_ns()) for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
    if not dev:
        raise RuntimeError("the profiler recorded no operation on the card")
    busy_ns, merged = _union([(s, e) for _, s, e in dev])
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) / 1e9
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    out = {"units": units, "window_s": (h1 - h0) / 1e9, "busy_s": busy_ns / 1e9,
           "kernels": dev, "device_ops": top(by_name), "idle_gaps": [],
           "anchor_drift_us": None}
    # The profiler may synchronize on its own when it starts and stops: the
    # slice's two are the pair whose ends lie as far apart as h0 and h1.
    syncs = sorted(e.end_ns() for e in events if e.name() == SYNC_CALL)
    pairs = [(abs((b - a) - (h1 - h0)), a, b) for i, a in enumerate(syncs) for b in syncs[i + 1:]]
    if not pairs:
        return out
    _, a, b = min(pairs)
    # The offset is the mean of the two ends' readings; they differ by the
    # drift, so an idle gap's span is known to half of it.
    off = ((a - h0) + (b - h1)) // 2
    out["anchor_drift_us"] = ((b - a) - (h1 - h0)) / 1e3
    t0, t1 = h0 + off, h1 + off
    gaps = [(merged[0][0] - t0, t0)] if merged[0][0] > t0 else []
    gaps += [(b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])]
    if merged[-1][1] < t1:
        gaps.append((t1 - merged[-1][1], merged[-1][1]))
    spans = sorted((s + off, e + off, n) for n, s, e in span_log)
    idle: Dict[str, float] = defaultdict(float)
    for length, at in gaps:
        open_ = [n for s, e, n in spans if s <= at < e]
        idle[open_[-1] if open_ else "outside the benchmark's spans"] += length / 1e9
    out["idle_gaps"] = top(idle)
    return out
