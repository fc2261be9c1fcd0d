"""Peaks of the card and the least time each hand-written kernel's launch
needs: its roofline bound.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W (the
card's power limit is printed beside every run).  A bound is the largest of
bytes over the memory rate, f32 operations over the f32 rate outside the
tensor cores, and exponentials over the rate of the unit that computes them;
each input is counted once as read and each output once as written,
whatever the kernel reads again.  The operation counts are those of the
kernels' work (a multiply-add is 2; an exponential also counts as one
operation), worked out from the shapes, not read from the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

F32_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3
# Exponentials a second: 16 a cycle on each of 132 multiprocessors at the
# 1.98 GHz boost clock the f32 rate is stated at.
EXP_RATE = 132 * 16 * 1.98e9
EMB = 16
BODY_PARAM_FLOATS = 3 * EMB * EMB + 3 * EMB + EMB * EMB + EMB + 2 * EMB + 2 * (EMB * EMB + EMB) + 2 * EMB


def bound_s(nbytes: float, flops: float, exps: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOPS, exps / EXP_RATE)


def body_ops(slots: int) -> Tuple[int, int]:
    """(forward, backward) operations of the transformer body a position.
    Forward: the four feature linears, 2 x 16 x (48 + 16 + 16 + 16) = 3072;
    attention with 8 heads of width 2 over S keys, q.k and p.v 64 S, and
    subtract-max, exp and sum 3 a (query, key) pair, 24 S; two LayerNorms and
    the residuals, about 230.  Backward: the linears' input and weight
    gradients and the linears again (3 x 3072); attention's products twice
    and the scores once more (160 S) and 5 a pair (40 S); the LayerNorms,
    about 500."""
    lin = 2 * EMB * (3 * EMB + 3 * EMB)
    return lin + 64 * slots + 24 * slots + 230, 3 * lin + 160 * slots + 40 * slots + 500


def body_bounds(batch: int, slots: int) -> Dict[str, float]:
    """Seconds: the training forward (writes out, o and the softmax statistic
    [B, S, 8]) and the backward (reads x, dout, o, the statistic; writes
    dx and the parameter gradients)."""
    pos = batch * slots
    fwd, bwd = body_ops(slots)
    act = pos * EMB * 4
    saved = pos * EMB * 4 + pos * 8 * 4
    prm = 2 * BODY_PARAM_FLOATS * 4
    exps = 8 * slots * pos
    return {"body_fwd_train": bound_s(2 * act + saved + prm, fwd * pos, exps),
            "body_bwd": bound_s(3 * act + saved + prm, bwd * pos, exps)}


def body_eval_bound(batch: int, slots: int) -> float:
    """Seconds: the forward without gradients (reads x, writes out)."""
    pos = batch * slots
    return bound_s(2 * pos * EMB * 4 + BODY_PARAM_FLOATS * 4, body_ops(slots)[0] * pos,
                   8 * slots * pos)


def dot_bounds(batch: int, n: int) -> Dict[str, float]:
    """The pairwise dot products of n vectors of 16 a row: forward reads the
    n vectors and writes the n(n-1)/2 scores; backward reads both and writes
    the vectors' gradients."""
    pairs = n * (n - 1) // 2
    t, z = batch * n * EMB * 4, batch * pairs * 4
    return {"dot_fwd": bound_s(t + z, 2 * EMB * pairs * batch),
            "dot_bwd": bound_s(2 * t + z, 2 * EMB * n * (n - 1) * batch)}


def table_update_bound(positions: int, unique_rows: int) -> float:
    """Touched-row Adagrad: reads each position's row index and summed
    gradient, reads and writes each touched row of the table and of its
    accumulator; 6 operations an element."""
    return bound_s(positions * (4 + 4 * EMB) + unique_rows * 4 * 4 * EMB,
                   6 * EMB * unique_rows)


def step_bounds(bodies: List[int], dots: List[int], batch: int, positions: int,
                unique_rows: int) -> Dict[str, float]:
    """Bound seconds of one training step's launches, summed by kind: a
    training forward and a backward of the body for each S in `bodies`, the
    dot products' forward and backward for each n in `dots`, one table
    update."""
    out: Dict[str, float] = {}
    for s in bodies:
        for k, v in body_bounds(batch, s).items():
            out[k] = out.get(k, 0.0) + v
    for n in dots:
        for k, v in dot_bounds(batch, n).items():
            out[k] = out.get(k, 0.0) + v
    out["table_update"] = table_update_bound(positions, unique_rows)
    return out


# The port's hand-written kernels, by the names of their `__global__`
# functions in nasrec_tpu_torch/csrc/*.cu, as they appear in a device trace.
HAND_WRITTEN = ("body_fwd_kernel", "body_bwd_kernel", "reduce_partials_kernel",
                "dot_fwd_kernel", "dot_bwd_kernel", "table_update_kernel",
                "attn_fwd_kernel", "attn_bwd_kernel")


def hand_written_s(kernels) -> float:
    """Device seconds of the hand-written kernels among (name, start, end) ns."""
    return sum(e - s for name, s, e in kernels
               if any(k in name for k in HAND_WRITTEN)) / 1e9
