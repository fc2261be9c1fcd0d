"""Profiling: parameter counts, matmul FLOPs, tensor bytes, chip calibration
and measured latency (port of `nasrec_tpu/profiling.py`).

What `dot_flops` counts.  The JAX package counts the dot_general equations of
a jaxpr, 2·M·N·K each.  Here `torch.utils.flop_counter.FlopCounterMode` counts
the matrix products that pass the dispatcher (mm, addmm, bmm, baddbmm,
convolutions) by the same rule, and every hand-written kernel adds the FLOPs
of its plain version at the shape it launched (`report_matmul_flops`): a
ctypes launch never passes the dispatcher.  So the kernel path and the plain
path of one call count the same number.  The forward of a fixed subnet counts
the JAX package's `dot_flops` of the same plan's jaxpr after dead-code
elimination with the port's notion of liveness (`models/fixed.py ::
live_blocks`: whole blocks whose outputs nothing reads are skipped; every
node of a live block is computed).  The JAX count itself, taken without any
elimination, also charges the dead blocks.

Count on the plain path on the `meta` device where only the numbers matter
(`estimate_latency_cost_model` in the search): there is no arithmetic and no
card time, and the counts are those of either device.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, List, Mapping, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# The counts of the `dot_flops` calls now open, innermost last.
_OPEN_COUNTS: List[List[int]] = []


def report_matmul_flops(flops: int) -> None:
    """Add `flops` to every open `dot_flops` count.  A kernel wrapper calls
    this where it launches, with its plain version's matmul FLOPs at the
    launched shape; so does code whose plain form is no product on the
    dispatcher but whose JAX counterpart is one (ops/interactions.py ::
    FM3D)."""
    for count in _OPEN_COUNTS:
        count[0] += int(flops)


def counting() -> bool:
    """True while a `dot_flops` count is open."""
    return bool(_OPEN_COUNTS)


class _ReportedFlops(torch.autograd.Function):
    """x unchanged; reports `flops` where it runs and again where its
    backward runs.  Under torch.func.vmap over K candidates it reports K
    times `flops`, as the kernels' K-candidate launches do."""

    @staticmethod
    def forward(x, flops):
        report_matmul_flops(flops)
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.flops = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        report_matmul_flops(ctx.flops)
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, flops):
        return _ReportedFlops.apply(x, flops * info.batch_size), in_dims[0]


def reported_flops(x: torch.Tensor, flops: int) -> torch.Tensor:
    """x, with `flops` reported to the open counts for its forward and again
    for its backward, if one runs (see `report_matmul_flops`)."""
    return _ReportedFlops.apply(x, int(flops))


def count_params(params: Any) -> int:
    """Elements of every parameter of a module, or of every tensor in a state
    dict (dead blocks' parameters included, as the JAX package counts them)."""
    if isinstance(params, torch.nn.Module):
        return sum(int(p.numel()) for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(count_params(v) for v in params.values())
    return int(np.prod(params.shape))


def dot_flops(fn: Callable, *args, **kwargs) -> int:
    """Matmul FLOPs of one call of fn(*args, **kwargs), forward and backward
    alike (a backward that runs inside the call is counted): the products the
    dispatcher sees, 2·M·N·K each, plus what the port's kernels report (see
    the module docstring).  Not XLA's aggregate, which also counts
    elementwise work."""
    count = [0]
    _OPEN_COUNTS.append(count)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        _OPEN_COUNTS.remove(count)
    return int(counter.get_total_flops()) + count[0]


def count_flops(fn: Callable, *args) -> float:
    """FLOPs of one call of fn(*args): `dot_flops`, the matmul FLOPs only
    (not XLA's aggregate cost, which also counts elementwise work)."""
    return float(dot_flops(fn, *args))


def _input_bytes(args: tuple) -> int:
    total = 0
    for a in args:
        tensors = a.parameters() if isinstance(a, torch.nn.Module) else tree_leaves(a)
        total += sum(t.numel() * t.element_size() for t in tensors
                     if isinstance(t, torch.Tensor))
    return total


class _OutputBytes(TorchDispatchMode):
    """Sums the bytes of every op's outputs; views move no bytes and are left
    out."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.numel() * t.element_size() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def tensor_bytes(fn: Callable, *args) -> int:
    """Bytes of every tensor one call of fn(*args) touches: its inputs once
    (a module among the args by its parameters) and each op's output once, at
    the port's op granularity (one aten op where a jaxpr may hold several
    equations).  A proxy for ranking candidates, not a bandwidth
    measurement."""
    mode = _OutputBytes()
    with mode:
        fn(*args)
    return _input_bytes(args) + mode.total


def estimate_latency_cost_model(fn: Callable, args: Tuple, calib: dict) -> float:
    """Analytic forward latency in seconds, without running anything on the
    card when fn and args lie on the `meta` device:

        dot_flops / matmul_flops_per_s + tensor_bytes / copy_bytes_per_s

    `calib` is one `calibrate_chip()` result.  A lower bound from arithmetic
    and bandwidth that is consistent across candidates, which is what the
    search's latency penalty (latency / target - 1) needs for ranking (ref:
    nasrec/searcher/searcher.py:65-73)."""
    flops = dot_flops(fn, *args)
    nbytes = tensor_bytes(fn, *args)
    return flops / calib["matmul_flops_per_s"] + nbytes / calib["copy_bytes_per_s"]


def _barrier(out) -> None:
    """A host read of one element of the first tensor in `out`: it waits
    for every launch before it on the stream."""
    first = next(t for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    first.reshape(-1)[0].item()


def calibrate_chip(matmul_dim: int = 4096, copy_mb: int = 512, trials: int = 20,
                   device: str = "cuda") -> dict:
    """Measured peaks of this device: bf16 `matmul_dim`² matrix products
    (FLOP/s) and the copy bandwidth of an f32 `x + 1` over `copy_mb` MiB
    (bytes read and written a second).  The product is `torch.matmul`: the
    library's peak is the denominator here, no kernel of the port.  TF32 is
    switched off for the calibration (the bf16 product does not use it) and
    the caller's setting restored.  Each peak is the median of 3 slopes."""
    dev = torch.device(device)
    n = matmul_dim
    # full(1/n) is a fixed point of a @ a up to rounding: chained products
    # never overflow bf16, so every link does real arithmetic.
    a = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)
    m = copy_mb * 1024 * 1024 // 4
    x = torch.zeros(m, dtype=torch.float32, device=dev)

    def run_mm(k):
        out = a
        for _ in range(k):
            out = torch.matmul(a, out)
        _barrier(out)

    def run_cp(k):
        y = x
        for _ in range(k):
            y = y + 1.0
        _barrier(y)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            run_mm(3)
            matmul_flops_per_s = float(np.median([
                2 * n ** 3 / chained_rate(run_mm, max(trials // 4, 2), trials)
                for _ in range(3)]))
            run_cp(3)
            copy_bytes_per_s = float(np.median([
                2 * m * 4 / chained_rate(run_cp, max(trials // 4, 2), trials)
                for _ in range(3)]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"matmul_flops_per_s": matmul_flops_per_s, "copy_bytes_per_s": copy_bytes_per_s}


_TIMING_FALLBACKS = 0


def chained_rate(run_k: Callable[[int], None], k1: int, k2: int) -> float:
    """Seconds an iteration from the slope between two window sizes.

    run_k(k) runs k data-dependent iterations and ends in a host read of the
    last value (`_barrier`); the read's fixed cost cancels in the slope.  A
    window that host interference stalls can push the slope to zero or below:
    it is measured again, up to 3 times, and then the raw large-window rate
    (which still holds the read) is returned and the fallback counted
    (`timing_fallbacks`)."""
    global _TIMING_FALLBACKS
    for _ in range(3):
        t0 = time.perf_counter()
        run_k(k1)
        t1 = time.perf_counter()
        run_k(k2)
        t2 = time.perf_counter()
        slope = ((t2 - t1) - (t1 - t0)) / (k2 - k1)
        if slope > 0.0:
            return slope
    _TIMING_FALLBACKS += 1
    return (t2 - t1) / k2


def timing_fallbacks(reset: bool = False) -> int:
    """Windows of `chained_rate` that fell back to the raw large-window rate
    since the process started or the last reset; nonzero means a number may
    be inflated by host interference."""
    global _TIMING_FALLBACKS
    n = _TIMING_FALLBACKS
    if reset:
        _TIMING_FALLBACKS = 0
    return n


def cost_analysis_of(fn: Callable, *args) -> dict:
    """{"flops": dot_flops, "bytes_accessed": tensor_bytes} of one call of
    fn(*args): the port's counts, not XLA's cost model of a compiled
    executable, which has no PyTorch counterpart."""
    return {"flops": float(dot_flops(fn, *args)),
            "bytes_accessed": float(tensor_bytes(fn, *args))}


def measure_latency(
    fn: Callable,
    args: Tuple,
    num_warmup_steps: int = 10,
    num_trials: int = 200,
    num_windows: int = 5,
) -> Tuple[float, float]:
    """(mean, std) seconds a call of fn(*args) over `num_windows` slopes:
    calls are issued back to back and a host read of one element of the
    last output ends each window (`chained_rate`)."""
    def run_k(k):
        out = None
        for _ in range(k):
            out = fn(*args)
        _barrier(out)

    run_k(max(num_warmup_steps, 1))
    k2 = max(num_trials // num_windows, 4)
    k1 = max(k2 // 4, 1)
    before = timing_fallbacks()
    lat = np.asarray([chained_rate(run_k, k1, k2) for _ in range(num_windows)])
    fell_back = timing_fallbacks() - before
    if fell_back:
        warnings.warn(
            f"measure_latency: {fell_back}/{num_windows} windows fell back to the raw "
            "large-window rate (host interference); the mean may hold the host read",
            RuntimeWarning)
    return float(lat.mean()), float(lat.std())
