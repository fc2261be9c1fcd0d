"""Optimizers and LR schedules with reference-parity semantics (port of
`nasrec_tpu/train/optim.py`).

  - Adagrad with eps added AFTER the sqrt and a zero initial accumulator,
    torch.optim.Adagrad as the reference uses it
    (ref: nasrec/main_train.py:151-154: Adagrad(lr, eps=1e-2))
  - Nesterov SGD (momentum 0.9) and Adam (eps 1e-8 outside the sqrt, bias
    correction from a step count), the reference's other two optimizers
    (ref: main_train.py:151-160)
  - CosineAnnealingWarmupRestarts stepped per batch (ref: lr_schedule.py:47-165)
  - ConstantWithWarmup (ref: lr_schedule.py:21-42)
  - global-norm gradient clipping at 5.0 (ref: train_utils.py:284-285)
  - explicit L2 penalty over >=2-D params (ref: train_utils.py:91-115)

An optimizer's state holds one tensor a parameter name in each of its
slots: Adagrad's is a dict of accumulators, SGD's an `SGDState` of momenta,
Adam's an `AdamState` of first and second moments and a step count.  The two
NamedTuples carry the fields, and in checkpoints the class names, of the JAX
package's `SGDState` and `AdamState`.  `Optimizer.update_` updates the named
parameters and their slots in place.

Schedules are functions of the 0-indexed batch step that return a Python
float; the step counter lives on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def adagrad_init(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Zero sum-of-squares accumulator per parameter (torch initial value 0)."""
    return {name: torch.zeros_like(p) for name, p in named_params}


@torch.no_grad()
def adagrad_update_(params: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], lr: float, eps: float = 1e-2) -> None:
    """In place: acc += g^2;  p -= lr * g / (sqrt(acc) + eps)."""
    for p, a, g in zip(params, accs, grads):
        a.add_(g * g)
        p.sub_(lr * g / (torch.sqrt(a) + eps))


class SGDState(NamedTuple):
    momentum: Dict[str, torch.Tensor]


def sgd_init(named_params: Iterable[Tuple[str, torch.Tensor]]) -> SGDState:
    return SGDState(adagrad_init(named_params))


@torch.no_grad()
def sgd_update_(params: Sequence[torch.Tensor], momenta: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], lr: float, momentum: float = 0.9) -> None:
    """In place, torch.optim.SGD(nesterov=True, momentum=0.9):
    m = momentum * m + g;  p -= lr * (g + momentum * m)."""
    for p, m, g in zip(params, momenta, grads):
        m.mul_(momentum).add_(g)
        p.sub_(lr * (g + momentum * m))


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor          # int32 scalar on the host: steps taken


def adam_init(named_params: Iterable[Tuple[str, torch.Tensor]]) -> AdamState:
    named_params = list(named_params)
    return AdamState(adagrad_init(named_params), adagrad_init(named_params),
                     torch.zeros((), dtype=torch.int32))


@torch.no_grad()
def adam_update_(params: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                 nus: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: float,
                 count: int, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """In place, for step `count` (1-based): mu = b1 mu + (1 - b1) g,
    nu = b2 nu + (1 - b2) g^2, p -= lr * mu_hat / (sqrt(nu_hat) + eps).  The
    bias corrections are computed in float32, as the JAX package computes them
    from its float32 count."""
    c = np.float32(count)
    mhat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** c))
    vhat_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** c))
    for p, m, v, g in zip(params, mus, nus, grads):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(lr * (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(named_params) -> state; update_(state, names, params, grads, lr,
    scale=None, impl="auto") updates the parameters `names` (tensors
    `params`, gradients `grads`, each times `scale` where it is given: a
    0-dim tensor, the global-norm clip's) and their slots of `state` in
    place.  `impl` as the kernels take it: Adagrad's update of CUDA tensors
    runs the list kernel of ops/kernels/dense_adagrad.py, which applies
    `scale` inside the update; SGD and Adam loop over the tensors."""

    init: Callable[[Iterable[Tuple[str, torch.Tensor]]], Any]
    update_: Callable[..., None]


def _scaled(grads, scale):
    return grads if scale is None else [g * scale for g in grads]


def _adagrad(state, names, params, grads, lr, scale=None, impl="auto", eps=1e-2):
    # Imported here: the kernel's module takes its plain version from this one.
    from nasrec_tpu_torch.ops.kernels.dense_adagrad import adagrad_

    adagrad_(params, [state[n] for n in names], grads, lr, eps, scale, impl)


def _sgd(state, names, params, grads, lr, scale=None, impl="auto"):
    sgd_update_(params, [state.momentum[n] for n in names], _scaled(grads, scale), lr)


def _adam(state, names, params, grads, lr, scale=None, impl="auto"):
    state.count.add_(1)
    adam_update_(params, [state.mu[n] for n in names], [state.nu[n] for n in names],
                 _scaled(grads, scale), lr, int(state.count))


def make_optimizer(name: str, adagrad_eps: float = 1e-2) -> Optimizer:
    """`adagrad_eps` is Adagrad's eps (the reference's 1e-2 by default)."""
    if name == "adagrad":
        return Optimizer(adagrad_init, functools.partial(_adagrad, eps=adagrad_eps))
    if name == "sgd":
        return Optimizer(sgd_init, _sgd)
    if name == "adam":
        return Optimizer(adam_init, _adam)
    raise NotImplementedError(f"optimizer {name}")


def slot_dicts(state) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The per-name slots of an optimizer state: (accumulators,), (momenta,)
    or (mu, nu)."""
    if isinstance(state, dict):
        return (state,)
    if isinstance(state, SGDState):
        return (state.momentum,)
    if isinstance(state, AdamState):
        return (state.mu, state.nu)
    raise TypeError(f"not an optimizer state: {type(state).__name__}")


@torch.no_grad()
def copy_state_(dst, src) -> None:
    """Copy an optimizer state of the same kind (from a checkpoint) into
    `dst`, in place and on dst's devices."""
    if type(dst) is not type(src) and not (isinstance(dst, dict) and isinstance(src, dict)):
        raise TypeError(f"optimizer state {type(src).__name__} does not match this "
                        f"run's {type(dst).__name__}")
    for d, s in zip(slot_dicts(dst), slot_dicts(src)):
        if set(d) != set(s):
            raise ValueError("optimizer state names differ: "
                             f"{sorted(set(d) ^ set(s))[:5]}")
        for k, t in d.items():
            t.copy_(s[k])
    if isinstance(dst, AdamState):
        dst.count.copy_(src.count)


def global_norm_scale(sq_norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ factor from a squared global norm
    (scale iff the norm exceeds max_norm)."""
    return torch.clamp(max_norm / (torch.sqrt(sq_norm) + 1e-6), max=1.0)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    sq = sum(torch.sum(torch.square(g.float())) for g in grads)
    scale = global_norm_scale(sq, max_norm)
    return [g * scale.to(g.dtype) for g in grads]


def l2_penalty(named_params: Iterable[Tuple[str, torch.Tensor]], reg: float,
               exclude_prefix: Optional[str] = None) -> torch.Tensor:
    """reg * sum(||p||^2) over params with ndim >= 2 (biases and LN params
    are 1-D and skipped); `exclude_prefix` skips names starting with it."""
    named_params = list(named_params)
    total = torch.zeros((), device=named_params[0][1].device)
    if reg == 0.0:
        return total
    for name, p in named_params:
        if p.dim() < 2:
            continue
        if exclude_prefix is not None and name.startswith(exclude_prefix):
            continue
        total = total + torch.sum(torch.square(p.float()))
    return reg * total


def cosine_warmup_restarts(step: int, first_cycle_steps: int, warmup_steps: int = 0,
                           max_lr: float = 0.1, min_lr: float = 1e-8) -> float:
    """LR at batch `step` (cycle_mult=1, gamma=1): get_lr() evaluated at
    step_in_cycle = step mod cycle (ref: lr_schedule.py:97-131)."""
    t = step % first_cycle_steps
    if t < warmup_steps:
        return min_lr + (max_lr - min_lr) * t / max(warmup_steps, 1)
    denom = max(first_cycle_steps - warmup_steps, 1)
    return min_lr + (max_lr - min_lr) * (
        1.0 + math.cos(math.pi * (t - warmup_steps) / denom)) / 2.0


def constant_with_warmup(step: int, num_warmup_steps: int, base_lr: float) -> float:
    """Linear warmup to base_lr then constant; batch t uses scale
    (t+1)/warmup (the reference's _step_count is 1-based)."""
    return base_lr * min((step + 1) / max(num_warmup_steps, 1), 1.0)


def make_lr_schedule(name: str, base_lr: float, num_train_steps: int,
                     num_warmup_steps: int) -> Callable[[int], float]:
    """Schedule factory mirroring the entry-point wiring (ref: main_train.py:162-180)."""
    if name == "cosine":
        return lambda step: cosine_warmup_restarts(
            step, num_train_steps, num_warmup_steps, max_lr=base_lr, min_lr=1e-8)
    if name == "constant":
        return lambda step: constant_with_warmup(step, num_warmup_steps, base_lr)
    if name == "constant-no-warmup":
        return lambda step: base_lr
    raise NotImplementedError(f"lr schedule {name}")
