"""Host-side subnet samplers for supernet training (a copy of
`nasrec_tpu/sampling.py` whose mask buffer holds torch tensors).

Sampling happens on the host between steps with numpy's RandomState, with
the same calls in the same order as the JAX package, so one seed gives both
packages the same choice sequence.  The choice is lowered to `ChoiceMasks`,
which one train step takes for every subnet.

Reference behavior reproduced:
  - fan-in samplers `uniform` / `binomial-0.5`, both capped at 4
    (ref: nasrec/supernet/utils.py:21-43)
  - macro samplers single/any/full/fixed-path (ref: nasrec/supernet/supernet.py:723-824)
  - micro samplers single/any/full/fixed-path (ref: nasrec/supernet/supernet.py:1244-1313)
  - linear warmup: for the first `supernet_training_steps` steps the sampler
    returns the FULL path with probability `1 - step/steps`
    (ref: nasrec/supernet/supernet.py:446-453, :1014-1020)
  - evo-2shot-path: sample uniformly from a candidate list
    (ref: nasrec/supernet/supernet.py:492-500)
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nasrec_tpu_torch.choices import Choice, ChoiceMasks, choice_to_masks, full_path_choice
from nasrec_tpu_torch.config import PATH_SAMPLING_STRATEGY_LIB, OpsConfig


def _uniform_fan_in(rng: np.random.RandomState, num_items: int, max_items: int = 4) -> int:
    """U{1..min(num_items, max_items)} (ref: supernet/utils.py:21-27)."""
    return int(rng.choice(min(num_items, max_items))) + 1


def _binomial_fan_in(rng: np.random.RandomState, num_items: int, p: float = 0.5,
                     max_items: int = 4) -> int:
    """1 + Binomial(min(n-1, 3), 0.5) (ref: supernet/utils.py:30-35)."""
    return 1 + int(rng.binomial(min(num_items - 1, max_items - 1), p))


ANYPATH_CHOICE_FNS: Dict[str, Callable[[np.random.RandomState, int], int]] = {
    "uniform": _uniform_fan_in,
    "binomial-0.5": lambda rng, n: _binomial_fan_in(rng, n, p=0.5),
}


class DeviceMaskBuffer:
    """Pre-samples `size` choices, stacks their masks into one set of tensors
    on `device`, and hands out `(buffer, idx)` a step: the step selects
    `buffer.select(idx)` on the device, so a step uploads nothing.  It refills
    `size` draws at a time, as the JAX package's buffer does, which keeps the
    sampler's step counter (and so its warmup probability) in step with it."""

    def __init__(self, sampler: "ChoiceSampler", size: int = 256,
                 device: str | torch.device = "cuda"):
        self.sampler = sampler
        self.size = size
        self.device = torch.device(device)
        self._refill()

    def _refill(self) -> None:
        s = self.sampler
        stacked = ChoiceMasks.stack(
            [choice_to_masks(s(), s.space, s.num_blocks) for _ in range(self.size)])
        self.buffer = stacked.to(self.device)
        self.pos = 0

    def __call__(self):
        if self.pos >= self.size:
            self._refill()
        idx = self.pos
        self.pos += 1
        return (self.buffer, idx)


class ChoiceSampler:
    """Samples subnet choices per training step.  It owns the step counter
    that drives the full-path warmup probability and the `fixed-path`
    memoisation (the reference's `SuperNet._get_choice` /
    `SuperNetBlock._get_choice` pair)."""

    def __init__(
        self,
        space: OpsConfig,
        num_blocks: int,
        strategy: str = "default",
        anypath_choice: str = "uniform",
        supernet_training_steps: int = 0,
        candidate_choices: Optional[Sequence[Choice]] = None,
        seed: Optional[int] = None,
    ):
        self.space = space
        self.num_blocks = num_blocks
        self.configure_strategy(strategy)
        self.anypath_choice = anypath_choice
        self._fan_in = ANYPATH_CHOICE_FNS[anypath_choice]
        self.supernet_training_steps = supernet_training_steps
        self.candidate_choices = list(candidate_choices) if candidate_choices else None
        self.rng = np.random.RandomState(seed)
        # -1 so that the first sampled step has the reference counter's
        # warmup threshold of 0 (supernet.py:292).
        self.step_counter = -1
        self.last_choice: Optional[Choice] = None

    def configure_strategy(self, strategy: str) -> None:
        if strategy not in PATH_SAMPLING_STRATEGY_LIB:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.macro_strategy = PATH_SAMPLING_STRATEGY_LIB[strategy]["macro"]
        self.micro_strategy = PATH_SAMPLING_STRATEGY_LIB[strategy]["micro"]

    def configure_choice(self, choice: Choice) -> None:
        """Pin the choice used by fixed-path sampling (ref: supernet.py:842-848)."""
        self.last_choice = copy.deepcopy(choice)

    def __call__(self) -> Choice:
        """The choice for the next training step (advances the counter)."""
        self.step_counter += 1
        thresh = self._warmup_thresh()

        if self.macro_strategy == "full-path":
            return full_path_choice(self.space, self.num_blocks)

        if self.macro_strategy == "fixed-path":
            if self.last_choice is None:
                self.last_choice = self._sample_subnet("fixed")
            return self.last_choice

        if self.macro_strategy == "evo-2shot-path":
            if not self.candidate_choices:
                raise ValueError("candidate_choices must be set for 'evo-2shot-path'")
            cand = self.candidate_choices[int(self.rng.randint(len(self.candidate_choices)))]
            choice = cand["choice"] if "choice" in cand else cand
            self.last_choice = choice
            return choice

        # single-path / any-path with full-path warmup.  The full path is not
        # memoised as the last choice (ref: supernet.py:507-511).
        if self.rng.random_sample() < thresh:
            return full_path_choice(self.space, self.num_blocks)
        mode = "single" if self.macro_strategy == "single-path" else "any"
        choice = self._sample_subnet(mode)
        self.last_choice = choice
        return choice

    def _warmup_thresh(self) -> float:
        steps = self.supernet_training_steps
        c = self.step_counter
        if 0 < c < steps:
            return 1.0 - c / (steps + 1e-10)
        return 0.0

    def _sample_subnet(self, mode: str) -> Choice:
        macro = [self._sample_macro(i + 1, mode) for i in range(self.num_blocks)]
        micro = [self._sample_micro(mode) for _ in range(self.num_blocks)]
        return {"macro": macro, "micro": micro}

    def _sample_macro(self, num_prior: int, mode: str) -> dict:
        rng = self.rng
        if mode == "single":                          # ref: supernet.py:723-736
            bi = rng.choice(num_prior, 2)
            return {"dense_idx": [int(rng.choice(num_prior))],
                    "sparse_idx": [int(rng.choice(num_prior))],
                    "dense_left_idx": [int(bi[0])],
                    "dense_right_idx": [int(bi[1])]}
        # any-path (ref :738-770) and fixed-path (ref :772-812, always the
        # 'uniform' fan-in) differ only in the fan-in distribution.
        fan_in = self._fan_in if mode == "any" else ANYPATH_CHOICE_FNS["uniform"]
        n_dense = fan_in(rng, num_prior)
        n_sparse = fan_in(rng, num_prior)
        bi = rng.choice(num_prior, 2)
        return {"dense_idx": [int(x) for x in rng.choice(num_prior, n_dense, replace=False)],
                "sparse_idx": [int(x) for x in rng.choice(num_prior, n_sparse, replace=False)],
                "dense_left_idx": [int(bi[0])],
                "dense_right_idx": [int(bi[1])]}

    def _sample_micro(self, mode: str) -> dict:
        rng = self.rng
        space = self.space
        if mode in ("single", "fixed"):
            # ref: supernet.py:1244-1263 (fixed-path micro is single-path
            # micro, ref :1305-1313)
            while True:
                active = sorted([int(rng.choice(space.dense_nodes)),
                                 int(rng.choice(space.sparse_nodes))])
                choice = self._finish_micro(rng, active)
                if active != sorted(space.zero_nodes):
                    return choice
        while True:                                   # any-path micro (ref :1278-1303)
            nd = self._fan_in(rng, len(space.dense_nodes))
            ns = self._fan_in(rng, len(space.sparse_nodes))
            dense = [int(x) for x in rng.choice(space.dense_nodes, nd, replace=False)]
            sparse = [int(x) for x in rng.choice(space.sparse_nodes, ns, replace=False)]
            active = sorted(dense + sparse)
            choice = self._finish_micro(rng, active)
            if active != sorted(space.zero_nodes):
                return choice

    def _finish_micro(self, rng: np.random.RandomState, active: List[int]) -> dict:
        return {"active_nodes": active,
                "dense_in_dims": int(rng.choice(self.space.dense_node_dims)),
                "sparse_in_dims": int(rng.choice(self.space.sparse_node_dims)),
                "dense_sparse_interact": int(rng.choice([0, 1])),
                "deep_fm": int(rng.choice([0, 1]))}
