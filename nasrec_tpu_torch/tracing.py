"""Spans and counters of the port's phases, recorded only while a
torch.profiler runs in the process.

`with span("train.step"):` records the phase's name, its start and end in
Unix-epoch ns (`time.time_ns`, the clock that the profiler's events carry, so
that a span and the device operations of one trace need no tie between
clocks), its thread, and the span it was opened inside (a stack per thread).
It also opens a `torch.profiler.record_function` range of the same name, so
that a trace exported from the profiler (`--profile_dir`) shows the phases.
`span(name, device=True)` records a CUDA event on the current stream at each
end as well, so that the phase's device time is known without matching
launches (`Span.device_ms`).  `count(name, n)` adds `n` to the calling
thread's innermost open span, so that a span's own counts are recorded with
it (`Span.counts`); outside any span it does nothing.  `device_counter(name,
device)` hands a kernel a counter on the device to add to, so that a count
that only the device knows costs the step no pass and no synchronisation;
`device_counts()` reads them all, once the profiled work is done.

The recorder is on exactly while `torch.autograd.profiler._is_profiler_enabled`
is set: torch sets that module global when any profiler of the process
starts and clears it when the profiler stops, and every thread reads the
same value, the prefetch thread that parses included (whereas
`torch.autograd._profiler_enabled()` reads the calling thread's profiler
state, False in a thread that the profiler does not follow).  Otherwise
`span` returns a null context after one flag test, `count` does nothing and
`device_counter` returns None.

Spans stay in memory, in the order they closed: `spans()`, and `clear()`
to drop them and the device counters.  A span opened inside a generator is
closed before the generator yields, so that a thread's stack never holds
another frame's phase.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

_SPANS: List["Span"] = []
_DEVICE_COUNTERS: Dict[tuple, torch.Tensor] = {}
_NULL = contextlib.nullcontext()
_local = threading.local()


def enabled() -> bool:
    """True while a torch.profiler runs anywhere in the process."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded phase: `name`, `start_ns` and `end_ns` (Unix-epoch ns),
    `thread` (`threading.get_ident()`), `parent` (the Span it was opened in,
    or None), `counts` (a Counter of what `count` added inside it, or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "counts", "_range",
                 "_events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.start_ns = self.end_ns = None
        self.thread = threading.get_ident()
        self.parent = None
        self.counts = None
        self._range = _profiler.record_function(name)
        self._events = None
        if device and torch.cuda.is_available():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._range.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        _stack().pop()
        _SPANS.append(self)
        return False

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's two CUDA events (once both have
        completed), or None for a span opened without `device=True`."""
        return None if self._events is None else self._events[0].elapsed_time(self._events[1])


def span(name: str, device: bool = False):
    """A context manager recording the phase `name` while a profiler runs;
    a null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span of the
    calling thread while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = collections.Counter()
        top.counts[name] += n


def device_counter(name: str, device) -> Optional[torch.Tensor]:
    """While a profiler runs, the counter `name` on `device`: one int64,
    zero when first asked for, that kernels add to; None otherwise."""
    if not _profiler._is_profiler_enabled:
        return None
    key = (name, torch.device(device))
    if key not in _DEVICE_COUNTERS:
        _DEVICE_COUNTERS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _DEVICE_COUNTERS[key]


def device_counts() -> Dict[str, int]:
    """Each device counter's total over its devices (waits for the device)."""
    out: Dict[str, int] = collections.Counter()
    for (name, _), t in _DEVICE_COUNTERS.items():
        out[name] += int(t.item())
    return dict(out)


def spans() -> List[Span]:
    return list(_SPANS)


def clear() -> None:
    _SPANS.clear()
    _DEVICE_COUNTERS.clear()
