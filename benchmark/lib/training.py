"""What the training cells share: the checked first steps, the readings the
comparison takes from the program and from the reference, and the
window's end-to-end numbers."""

from __future__ import annotations

import gc
import sys
from typing import Callable, Dict, List

import torch

from lib import compare, window
from lib.weights import make_weights


@torch.no_grad()
def acc_norms(accs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's first gradient, as Adagrad got it: sqrt of the sum of its
    accumulator after one step (it starts at zero)."""
    names = list(accs)
    sums = torch.stack([accs[n].double().sum() for n in names]).sqrt().tolist()
    return dict(zip(names, sums))


@torch.no_grad()
def change_norms(params: Dict[str, torch.Tensor], specs, seed: int, device) -> Dict[str, float]:
    """Each leaf's distance from the weights the seed made."""
    w0 = make_weights(specs, seed, device)
    names = [n for n in params if n in w0]
    out = torch.stack([(params[n].double() - w0[n].double()).square().sum()
                       for n in names]).sqrt().tolist()
    del w0
    return dict(zip(names, out))


def checked_steps(body: Callable[[int], tuple], accs: Callable[[], Dict], params: Callable[[], Dict],
                  specs, seed: int, device, n: int = 3) -> Dict:
    """Units 0..n-1 through the window's own call and feed; the program's
    readings: each step's loss, the first gradient by leaf, the change by
    leaf after the n steps."""
    losses, grad = [], None
    for i in range(n):
        loss, _, _ = body(i)
        losses.append(float(loss))
        if i == 0:
            grad = acc_norms(accs())
    return {"losses": losses, "grad": grad,
            "change": change_norms(params(), specs, seed, device)}


def reference_readings(trainer, batches: List[tuple], specs, seed: int, device) -> Dict:
    losses, grad = [], None
    p0 = make_weights(specs, seed, device)
    for i, b in enumerate(batches):
        losses.append(trainer.step(*b))
        if i == 0:
            grad = acc_norms(trainer.acc)
    with torch.no_grad():
        change = {n: float((trainer.params[n].double() - p0[n].double()).square().sum().sqrt())
                  for n in trainer.names}
    return {"losses": losses, "grad": grad, "change": change}


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def train_e2e(w: Dict, examples: int, prefix: str) -> Dict[str, float]:
    """Examples a second over the window's whole time, and the 95th
    percentile of the intervals between consecutive steps' ends on the card."""
    out = {f"{prefix}_examples_per_s": w["units"] * examples / w["seconds"]}
    if w["unit_end_ms"]:
        out[f"{prefix}_step_ms_p95"] = window.percentile(w["unit_end_ms"], 95)
    return out


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup_mark(rt, what: str) -> None:
    """The run's clock when a part of the set-up is done (the card's queue
    drained first, so that the part's own work is in it)."""
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    say(f"setup: {what} done at {rt.clock():.3f} s")


def judge_training(prog: Dict, ref: Dict, limits: Dict, extra: Dict = None) -> tuple:
    values = compare.training_gaps(prog, ref)
    values.update(extra or {})
    say("readings: program losses " + " ".join(f"{x:.9g}" for x in prog["losses"])
        + "; reference " + " ".join(f"{x:.9g}" for x in ref["losses"]))
    counted = compare.counted_leaves(ref["grad"])
    say(f"leaves compared: {len(counted)} of {len(ref['grad'])}")
    for what in ("grad", "change"):
        gaps = compare.leaf_gaps(prog[what], ref[what], counted)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        say(f"worst {what} leaves: " + "; ".join(
            f"{n} {gaps[n]:.3g} ({prog[what][n]:.9g} against {ref[what][n]:.9g})" for n in worst))
    say("readings not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in values.items() if k not in limits))
    return compare.judge(values, limits)
