"""The numbers that decide `correct` for a training cell.

The program's first steps and the reference's, from the same weights and the
same batches, are compared by three numbers, each against a limit kept in the
cell's file:

  loss_gap    the largest |loss - reference loss| / |reference loss| over the
              checked steps;
  grad_gap    the first step's gradient as the optimizer got it, by leaf: the
              norm worked out from the Adagrad accumulator after one step
              (sqrt of its sum: the accumulator starts at zero);
  change_gap  each leaf's change over the checked steps, by norm.

A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and the median leaf's; the number is the worst
leaf's.  Leaves whose reference gradient is under a thousandth of the median
leaf's (a leaf that nothing downstream reads, or that moves by round-off
alone) are left out of both.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], counted: List[str]) -> Dict:
    """Each counted leaf's gap.  The median is taken over the leaves that
    moved in the reference (a supernet leaf whose node no checked step
    samples keeps its value)."""
    moved = [ref[n] for n in counted if ref[n] > 0]
    med = statistics.median(moved) if moved else 0.0
    out = {}
    for n in counted:
        scale = max(ref[n], med)
        gap = abs(prog[n] - ref[n]) / scale if scale > 0 else (0.0 if prog[n] == 0 else math.inf)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], counted: List[str]) -> float:
    return max(leaf_gaps(prog, ref, counted).values(), default=0.0)


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median of the leaves that have one (a supernet step trains only the
    sampled subnet's leaves)."""
    live = [g for g in ref_grad.values() if g > 0]
    med = statistics.median(live) if live else 0.0
    return [n for n, g in ref_grad.items() if g > 0 and g >= 1e-3 * med]


def training_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog / ref: {'losses': [..], 'grad': {leaf: norm}, 'change': {leaf: norm}}
    -> every number a training cell may compare (its limits say which)."""
    counted = counted_leaves(ref["grad"])
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if not all(math.isfinite(x) for x in prog["losses"]):
        losses = [math.inf] * len(losses)
    out = {"loss_gap": losses[0], "loss_gap_all_steps": max(losses)}
    for w in ("grad", "change"):
        gaps = leaf_gaps(prog[w], ref[w], counted)
        out[f"{w}_gap"] = max(gaps.values(), default=0.0)
        out[f"{w}_median_gap"] = statistics.median(gaps.values()) if gaps else 0.0
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {'value', 'limit'}}) over the numbers that have a
    limit: each at or under it (a number that is not finite fails)."""
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
