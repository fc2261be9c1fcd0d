"""Random search and regularized evolution over a trained supernet (a copy
of `nasrec_tpu/search/evolution.py`: the same candidates, histories and
`all_results` from the same seed and scores).

Algorithm parity with the reference Searcher
(ref: nasrec/searcher/searcher.py):
  - random_search_from_supernet (:88-165): evaluate `budget` random archs,
    return top_k by criterion;
  - regularized_evolution_from_supernet (:167-295): init population by random
    search; per generation sample `sample_size`, take the best as parent,
    create `n_childs` mutants (dedup by hash token; mutation count decays
    over generations, :243), evaluate, keep per-generation top_k in history,
    age out the oldest n_childs;
  - criteria test_loss | test_acc | test_auroc | test_loss_penalty_lat with
    the TuNAS-style latency penalty loss + beta*(lat/target - 1) (:65-73).

Candidates are evaluated in groups of `group_size` (see worker.py), one
group after another on one device, or fanned out across processes
(`SearchConfig.distribute`): group g goes to rank g % world, and one
all-gather over the gloo host group (parallel/distributed.py) exchanges the
metrics, so every rank holds the same result list and the seeded search
stays in lockstep with a one-process run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nasrec_tpu_torch.choices import Choice
from nasrec_tpu_torch.parallel.distributed import host_group, host_info
from nasrec_tpu_torch.search.tokenizer import Tokenizer


@dataclasses.dataclass
class SearchConfig:
    criterion: str = "test_loss"
    beta: float = 0.0
    target_latency: float = -1.0
    group_size: int = 8          # candidates per evaluation group
    seed: Optional[int] = None
    # Cross-process fan-out (ref: nasrec/searcher/searcher.py:126-156 spawns
    # one mp.Process per candidate, one GPU each): when True and more than
    # one process is up, each generation's candidate groups are
    # round-robined across the ranks, each rank evaluates its own groups, and
    # the numeric results are exchanged with one all-gather.
    distribute: bool = False


class Searcher:
    """eval_fn: (choices: List[Choice]) -> List[result dict]."""

    VALID_CRITERIA = ("test_loss", "test_acc", "test_auroc", "test_loss_penalty_lat")

    def __init__(
        self,
        eval_fn: Callable[[Sequence[Choice]], List[Dict]],
        tokenizer: Tokenizer,
        config: SearchConfig = SearchConfig(),
        log_fn: Callable[[str], None] = print,
    ):
        if config.criterion not in self.VALID_CRITERIA:
            raise NotImplementedError(f"criterion {config.criterion}")
        self.eval_fn = eval_fn
        self.tokenizer = tokenizer
        self.config = config
        self.rng = np.random.RandomState(config.seed)
        self.log = log_fn
        self.all_results: List[Dict] = []

    # -- objective -----------------------------------------------------------

    def _objective(self, result: Dict) -> float:
        c = self.config
        if c.criterion == "test_loss_penalty_lat":
            return result["test_loss"] + c.beta * (
                result["latency"] / c.target_latency - 1.0
            )
        return result[c.criterion]

    def _sort(self, results: List[Dict]) -> List[Dict]:
        objs = np.asarray([self._objective(r) for r in results], dtype=np.float64)
        order = np.argsort(objs, kind="stable")
        if self.config.criterion in ("test_acc", "test_auroc"):
            order = order[::-1]
        return [results[i] for i in order]

    # -- evaluation in groups -------------------------------------------------

    def _evaluate(self, choices: Sequence[Choice]) -> List[Dict]:
        gs = max(1, self.config.group_size)
        groups = [list(choices[i : i + gs]) for i in range(0, len(choices), gs)]
        if self.config.distribute and host_info()[1] > 1:
            return self._evaluate_distributed(groups, choices)
        out: List[Dict] = []
        for g in groups:
            out.extend(self.eval_fn(g))
        return out

    # Numeric fields exchanged across processes; every other result key
    # (the choice itself) is rebuilt alike on every rank from the shared
    # seeded RNG.
    _EXCHANGE_FIELDS = ("test_loss", "test_acc", "test_auroc", "latency")

    def _evaluate_distributed(
        self, groups: List[List[Choice]], choices: Sequence[Choice]
    ) -> List[Dict]:
        """Group g goes to rank g % world; the float metrics come back in one
        all-gather of an [n, fields + 1] float64 matrix over the gloo host
        group (disjoint rows summed, a missing field as NaN, the last column
        counting fills), so every rank returns the same results in the
        one-process order."""
        rank, world = host_info()
        n, nf = len(choices), len(self._EXCHANGE_FIELDS)
        mat = np.zeros((n, nf + 1), np.float64)
        row0 = np.cumsum([0] + [len(g) for g in groups])
        for gi, g in enumerate(groups):
            if gi % world != rank:
                continue
            for j, r in enumerate(self.eval_fn(g)):
                row = row0[gi] + j
                mat[row, :nf] = [r.get(f, np.nan) for f in self._EXCHANGE_FIELDS]
                mat[row, nf] = 1.0
        mine = torch.from_numpy(mat)
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine, group=host_group())
        total = torch.stack(parts).sum(dim=0).numpy()
        if not (total[:, nf] == 1.0).all():
            raise RuntimeError("distributed evaluation left candidate rows unfilled or "
                               f"double-filled: fill counts {total[:, nf]}")
        results: List[Dict] = []
        for i, choice in enumerate(choices):
            r: Dict = {"choice": choice}
            for k, f in enumerate(self._EXCHANGE_FIELDS):
                v = total[i, k]
                if not np.isnan(v):
                    r[f] = float(v)
            results.append(r)
        return results

    # -- algorithms ----------------------------------------------------------

    def random_search_from_supernet(
        self,
        budget: int = 200,
        top_k: int = 5,
        sorted_results: bool = True,
    ) -> List[Dict]:
        assert top_k <= budget
        choices = [self.tokenizer.generate_random_choice() for _ in range(budget)]
        self.log(f"random search: evaluating {budget} archs")
        self.all_results = self._evaluate(choices)
        if sorted_results:
            return self._sort(self.all_results)[:top_k]
        return self.all_results[:top_k]

    def regularized_evolution_from_supernet(
        self,
        n_generations: int = 50,
        n_childs: int = 16,
        init_population: int = 100,
        sample_size: int = 5,
        top_k: int = 2,
        skip_random: bool = False,
        initial_results: Optional[List[Dict]] = None,
    ) -> List[Dict]:
        assert top_k <= sample_size
        assert sample_size < init_population
        if initial_results is not None and skip_random:
            population = list(initial_results)
        else:
            population = self.random_search_from_supernet(
                budget=init_population, top_k=init_population, sorted_results=False
            )
        self.log("done random init population")
        history: List[Dict] = []
        visited = {self.tokenizer.hash_choice(r["choice"]) for r in population}

        for gen in range(n_generations):
            idx = self.rng.choice(len(population), sample_size, replace=False)
            sampled = [population[i] for i in idx]
            parent = self._sort(sampled)[0]
            # Mutation strength decays over generations (ref :243).
            num_mutations = (n_generations - gen) // max(20, n_generations // 5) + 1
            children: List[Choice] = []
            while len(children) < n_childs:
                mutated = parent["choice"]
                while True:
                    for _ in range(num_mutations):
                        mutated = self.tokenizer.mutate_spec(mutated)
                    h = self.tokenizer.hash_choice(mutated)
                    if h not in visited:
                        visited.add(h)
                        break
                children.append(mutated)
            child_results = self._evaluate(children)
            self.all_results.extend(child_results)
            population.extend(child_results)
            best = self._sort(child_results)[:top_k]
            history.extend(best)
            # Age out the oldest n_childs (regularized evolution).
            population = population[n_childs:]
            self.log(
                f"gen {gen}: parent {self._objective(parent):.5f} "
                f"best-child {self._objective(best[0]):.5f} "
                f"(mutations={num_mutations})"
            )
        return history
