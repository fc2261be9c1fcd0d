"""Faults planted under a driver's timed path, for the tests that show the
comparison fails them.  A run on the card never plants one."""

from __future__ import annotations

import copy


class _Shadow:
    """A deep copy of a train state that a step may change freely."""

    def __init__(self, state):
        self.__dict__.update(copy.deepcopy(state).__dict__)


def broken_step(step, kind: str):
    """`state_unchanged`: the step runs on a copy and returns the state it
    was given; `half_batch`: the step sees the first half of each batch (its
    mean taken over that half)."""
    if kind == "state_unchanged":
        def frozen(state, *args):
            _, m = step(_Shadow(state), *args)
            return state, m
        return frozen
    if kind == "half_batch":
        def half(state, dense, cat, y, *rest):
            h = dense.shape[0] // 2
            return step(state, dense[:h], cat[:h], y[:h], *rest)
        return half
    raise ValueError(f"unknown fault {kind!r}")


def broken_groups(evaluator, kind: str) -> None:
    """`state_unchanged`: each candidate group's fine-tune step leaves the
    finals as they were."""
    if kind != "state_unchanged":
        raise ValueError(f"unknown fault {kind!r}")
    make = evaluator.group

    def group(choices):
        g = make(choices)
        step, w0, b0 = g.step, g.weight.clone(), g.bias.clone()

        def frozen(*args):
            out = step(*args)
            g.weight.copy_(w0)
            g.bias.copy_(b0)
            return out
        g.step = frozen
        return g
    evaluator.group = group


def altered_logits(evaluator) -> None:
    """Each group's first candidate's logits are 1 % larger where its
    forward produces them."""
    make = evaluator.group

    def group(choices):
        g = make(choices)
        forward = g.logits

        def logits(*args):
            out = forward(*args).clone()
            out[0] *= 1.01
            return out
        g.logits = logits
        return g
    evaluator.group = group


def half_batches(batches):
    """The first half of each batch."""
    return [tuple(t[:t.shape[0] // 2] for t in b) for b in batches]
