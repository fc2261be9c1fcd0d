"""Arithmetic over the program's own spans (the port's `tracing` recorder)
and the device operations of the profiled slice, for the readers of
`metrics/`.

A span is anything with `name`, `start_ns`, `end_ns` (Unix-epoch ns, the
clock that the profiler's events carry: no tie between clocks is needed),
`thread`, `parent` (a span or None) and `counts` (a mapping or None).  The
device operations are the slice's `trace["kernels"]`: (name, start_ns,
end_ns).  Nothing here imports the port: a reader hands its spans in.

- Idle gaps: the complement of the union of the operations' intervals, from
  the first span of the thread that drives the card to the end of its last
  (the benchmark's own calls before and after are not the program's), each
  put down to the innermost span of that thread open when the gap began, or
  where none was, to the innermost span then open on another thread.
- Self time: a span's length less its children's.

`analyse` does both once a slice and prints one block to the run's log: the
idle time by program span, the idle time that fell in gaps beginning inside
some program span beside the slice's whole idle time (the coverage), and the
clock check: how far each `search.fetch` ends after the end of the last
device-to-host copy that began in it or before the next span of its thread, and how far each host-to-device
copy starts after the start of the `data.h2d` span that issued it.
"""

from __future__ import annotations

import sys
import threading
from collections import defaultdict
from typing import Dict, List, Optional

from lib import window

OUTSIDE = "outside the program's spans"
BENCH_SPANS = ("step", "next_batch", "group")   # the benchmark's spans around its calls
SMALL_GAP_NS = 10_000

_done: Dict[int, tuple] = {}


def depth(span) -> int:
    d = 0
    while span.parent is not None:
        span, d = span.parent, d + 1
    return d


def within(span, name: str) -> bool:
    """True if `span` is `name` or lies inside a span of that name."""
    while span is not None:
        if span.name == name:
            return True
        span = span.parent
    return False


def idle_gaps(kernels, spans, thread) -> List[tuple]:
    """[(start_ns, end_ns, span or None)]: the card's idle gaps from the first
    span of `thread` (the thread that drives the card) to the end of its last,
    each with the innermost span of `thread` open where it began or, where
    none is, the innermost span then open on another thread (which may hold
    the driving thread back: the GIL, a queue)."""
    def innermost(cands, at):
        open_ = [s for s in cands if s.start_ns <= at < s.end_ns]
        return max(open_, key=lambda s: (s.start_ns, depth(s))) if open_ else None

    mine = [s for s in spans if s.thread == thread]
    other = [s for s in spans if s.thread != thread]
    if not mine:
        return []
    lo, hi = min(s.start_ns for s in mine), max(s.end_ns for s in mine)
    out, t = [], lo
    for a, b in window._union([(s, e) for _, s, e in kernels])[1]:
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = b
    if t < hi:
        out.append((t, hi))
    return [(a, b, innermost(mine, a) or innermost(other, a)) for a, b in out]


def label(span, thread) -> str:
    if span is None:
        return OUTSIDE
    return span.name if span.thread == thread else f"{span.name} (another thread)"


def idle_by_span(gaps, thread) -> Dict[str, float]:
    """Idle seconds by the span each gap began in."""
    out: Dict[str, float] = defaultdict(float)
    for a, b, s in gaps:
        out[label(s, thread)] += (b - a) / 1e9
    return dict(out)


def self_time(spans) -> Dict[str, float]:
    """Seconds by span name of each span less its children."""
    out: Dict[str, float] = defaultdict(float)
    for s in spans:
        out[s.name] += (s.end_ns - s.start_ns) / 1e9
        if s.parent is not None:
            out[s.parent.name] -= (s.end_ns - s.start_ns) / 1e9
    return dict(out)


def total_s(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9


def fetch_offsets_us(kernels, spans) -> List[Optional[float]]:
    """For each `search.fetch`: its end less the end of the last
    device-to-host copy that began after its start and before the next span
    of its thread (a copy placed after the fetch's end reads negative), in us
    (None: no such copy)."""
    copies = [(s, e) for n, s, e in kernels if "DtoH" in n]
    out = []
    for sp in sorted((s for s in spans if s.name == "search.fetch"), key=lambda s: s.start_ns):
        nxt = min((s.start_ns for s in spans if s.thread == sp.thread
                   and s.start_ns >= sp.end_ns), default=float("inf"))
        inside = [e for s, e in copies if sp.start_ns <= s < nxt]
        out.append((sp.end_ns - max(inside)) / 1e3 if inside else None)
    return out


def h2d_offsets_us(kernels, spans) -> Optional[List[float]]:
    """Each host-to-device copy's start less the start of the `data.h2d` span
    that issued it, in us, the copies dealt to the spans in order, as many to
    each; None where the copies do not divide among the spans."""
    copies = sorted(s for n, s, _ in kernels if "HtoD" in n)
    h2d = sorted(s.start_ns for s in spans if s.name == "data.h2d")
    if not h2d or len(copies) % len(h2d):
        return None
    per = len(copies) // len(h2d)
    return [(c - h2d[i // per]) / 1e3 for i, c in enumerate(copies)]


def analyse(ctx: dict, spans, thread=None) -> Optional[dict]:
    """{'gaps', 'idle', 'units'} of the slice in `ctx["trace"]`, from the
    recorder's `spans`; the block is printed on the first call a slice.
    None without a trace or without spans of the driving thread (`thread`,
    by default the main thread's ident)."""
    tr = ctx.get("trace")
    thread = threading.main_thread().ident if thread is None else thread
    if not tr or not any(s.thread == thread for s in spans):
        return None
    if id(tr) not in _done:
        gaps = idle_gaps(tr["kernels"], spans, thread)
        # The slice is kept with its result, so that its id is not reused.
        _done[id(tr)] = (tr, {"gaps": gaps, "idle": idle_by_span(gaps, thread),
                              "units": tr["units"]})
        _print_block(tr, spans, _done[id(tr)][1])
    return _done[id(tr)][1]


def _fmt(d: Dict[str, float]) -> str:
    return "; ".join(f"{k} {v:.6f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1]))


def _range(vals, unit: str) -> str:
    return f"{min(vals):.1f} to {max(vals):.1f} {unit}" if vals else "none"


def _print_block(tr, spans, a) -> None:
    idle = a["idle"]
    inside = sum(v for k, v in idle.items() if k != OUTSIDE)
    whole = tr["window_s"] - tr["busy_s"]
    bench = sum(v for k, v in tr.get("idle_gaps", []) if k in BENCH_SPANS)
    fetch = fetch_offsets_us(tr["kernels"], spans)
    h2d = h2d_offsets_us(tr["kernels"], spans)
    short = [end - start for start, end, _ in a["gaps"] if end - start < SMALL_GAP_NS]
    small, n_small = sum(short), len(short)
    lines = [
        f"program spans: {len(spans)} recorded over {tr['units']} units",
        "program spans: idle s by span: " + _fmt(idle),
        f"program spans: coverage: {inside:.6f} s idle in gaps begun inside program spans, of "
        f"the slice's {whole:.6f} s idle; the benchmark's {'/'.join(BENCH_SPANS)} spans "
        f"hold {bench:.6f} s"
        + (f" ({100 * inside / bench:.1f} %)" if bench > 0 else ""),
        "program spans: host self time s by span: " + _fmt(self_time(spans)),
        f"program spans: {len(a['gaps'])} idle gaps, {small * 1e-9:.6f} s of them in "
        f"{n_small} under {SMALL_GAP_NS // 1000} us (the card's own time between queued "
        "operations)",
    ]
    if fetch:
        found = [v for v in fetch if v is not None]
        lines.append(f"program spans: clock check: search.fetch ends {_range(found, 'us')} after "
                     f"its last device-to-host copy ({len(found)} of {len(fetch)} fetches "
                     f"with a copy, {sum(v < 0 for v in found)} before it)")
    if any(s.name == "data.h2d" for s in spans):
        lines.append("program spans: clock check: " + (
            "the host-to-device copies do not divide among the data.h2d spans" if h2d is None
            else f"host-to-device copies start {_range(h2d, 'us')} after their data.h2d span's "
                 f"start ({len(h2d)} copies, {sum(v < 0 for v in h2d)} before it)"))
    print("\n".join(lines), file=sys.stderr, flush=True)
