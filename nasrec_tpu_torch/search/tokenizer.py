"""Architecture tokenizer: choice <-> token encoding, hashing, mutation (a
copy of `nasrec_tpu/search/tokenizer.py`; the same choices, mutations and
hashes from the same seed).

Encoding scheme parity with the reference (ref: nasrec/searcher/tokenizer.py):
  per block, macro: 4 x [num_blocks] multi-hot vectors (dense / sparse /
  dense_left / dense_right input selections); micro: [num_nodes] multi-hot of
  active nodes, the dense/sparse dim *indices*, and 2-bit one-hots for
  dense_sparse_interact and deep_fm (ref :154-182).  hash = digit string
  (ref :184-186).  Mutation resamples ONE key of ONE random block at either
  the macro or micro level (ref :188-265), with macro fan-in capped at 4.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np

from nasrec_tpu_torch.config import OpsConfig
from nasrec_tpu_torch.choices import Choice


class Tokenizer:
    def __init__(self, num_blocks: int, space: OpsConfig, seed=None):
        self.num_blocks = num_blocks
        self.space = space
        self._dense_dim_index = {d: i for i, d in enumerate(space.dense_node_dims)}
        self._sparse_dim_index = {d: i for i, d in enumerate(space.sparse_node_dims)}
        self.rng = np.random.RandomState(seed)

    # -- encoding ------------------------------------------------------------

    def _multi_hot(self, indices, width: int) -> List[int]:
        return [1 if i in set(int(x) for x in indices) else 0 for i in range(width)]

    def tokenize(self, choice: Choice) -> np.ndarray:
        enc: List[int] = []
        nb = self.num_blocks
        for m in choice["macro"]:
            enc += self._multi_hot(m["dense_idx"], nb)
            enc += self._multi_hot(m["sparse_idx"], nb)
            enc += self._multi_hot(m["dense_left_idx"], nb)
            enc += self._multi_hot(m["dense_right_idx"], nb)
        for mi in choice["micro"]:
            enc += self._multi_hot(mi["active_nodes"], self.space.num_nodes)
            enc.append(self._dense_dim_index[int(mi["dense_in_dims"])])
            enc.append(self._sparse_dim_index[int(mi["sparse_in_dims"])])
            enc += [0, 1] if int(mi["dense_sparse_interact"]) == 1 else [1, 0]
            enc += [0, 1] if int(mi["deep_fm"]) == 1 else [1, 0]
        return np.asarray(enc, dtype=np.int64)

    def hash_token(self, token: np.ndarray) -> str:
        return "".join(str(int(x)) for x in token)

    def hash_choice(self, choice: Choice) -> str:
        return self.hash_token(self.tokenize(choice))

    # -- mutation / random generation ----------------------------------------

    def _random_macro(self, block_idx: int) -> Dict[str, Any]:
        rng = self.rng
        n_prior = block_idx + 1
        nd = 1 + int(rng.choice(min(4, n_prior)))
        ns = 1 + int(rng.choice(min(4, n_prior)))
        bi = rng.choice(n_prior, 2)
        return {
            "dense_idx": [int(x) for x in rng.choice(n_prior, nd, replace=False)],
            "sparse_idx": [int(x) for x in rng.choice(n_prior, ns, replace=False)],
            "dense_left_idx": [int(bi[0])],
            "dense_right_idx": [int(bi[1])],
        }

    def _random_micro(self) -> Dict[str, Any]:
        rng = self.rng
        s = self.space
        while True:
            micro = {
                "active_nodes": sorted(
                    [int(rng.choice(s.dense_nodes)), int(rng.choice(s.sparse_nodes))]
                ),
                "dense_in_dims": int(rng.choice(s.dense_node_dims)),
                "sparse_in_dims": int(rng.choice(s.sparse_node_dims)),
                "dense_sparse_interact": int(rng.choice([0, 1])),
                "deep_fm": int(rng.choice([0, 1])),
            }
            if micro["active_nodes"] != sorted(s.zero_nodes):
                return micro

    def mutate_spec(self, choice: Choice) -> Choice:
        """Resample one key of one random block (macro-or-micro coin flip)."""
        rng = self.rng
        block_idx = int(rng.choice(self.num_blocks))
        mutated = copy.deepcopy(choice)
        if rng.random_sample() > 0.5:
            new_macro = self._random_macro(block_idx)
            key = str(
                rng.choice(["dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx"])
            )
            mutated["macro"][block_idx][key] = copy.deepcopy(new_macro[key])
        else:
            new_micro = self._random_micro()
            key = str(
                rng.choice(
                    ["active_nodes", "dense_in_dims", "sparse_in_dims",
                     "dense_sparse_interact", "deep_fm"]
                )
            )
            mutated["micro"][block_idx][key] = new_micro[key]
        return mutated

    def generate_random_choice(self) -> Choice:
        macro = [self._random_macro(i) for i in range(self.num_blocks)]
        micro = [self._random_micro() for _ in range(self.num_blocks)]
        return {"macro": macro, "micro": micro}
