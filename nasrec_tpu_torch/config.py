"""Dataset and search-space configuration (a copy of the JAX package's
`nasrec_tpu/config.py`, cut to what the port reads).

The port keeps its own copy so that it imports nothing of the JAX package.
Values are the reference's (ref: nasrec/utils/config.py:17-41,
nasrec/supernet/supernet.py:134-178).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

# Search-time cap on every table's rows; final (best-model) evaluation lifts
# it (ref: nasrec/utils/config.py:17-19).
SEARCH_MAX_NUM_EMBEDDINGS = 500_000

# ref: nasrec/utils/config.py:21-23
_RAW_NUM_EMBEDDINGS_CRITEO: Tuple[int, ...] = (
    1461, 584, 10131227, 2202609, 306, 25, 12518, 634,
    4, 93146, 5684, 8351593, 3195, 28, 14993, 5461307,
    11, 5653, 2174, 5, 7046548, 19, 16, 286182, 106, 142573,
)

# ref: nasrec/utils/config.py:30-31
_RAW_NUM_EMBEDDINGS_AVAZU: Tuple[int, ...] = (
    10000, 241, 8, 8, 4738, 7746, 27, 8553, 560, 37, 2686409,
    6729487, 8252, 6, 5, 2627, 9, 10, 436, 5, 69, 173, 61,
)

# ref: nasrec/utils/config.py:37
_RAW_NUM_EMBEDDINGS_KDD: Tuple[int, ...] = (
    26274, 641708, 14848, 22122011, 1188090, 3735797, 2934102, 20004011, 4, 8,
)


def capped_vocab_sizes(raw: Sequence[int], cap: int | None) -> Tuple[int, ...]:
    """Apply the search-time vocabulary cap (None = uncapped, final-eval mode)."""
    if cap is None:
        return tuple(int(x) for x in raw)
    return tuple(min(int(x), cap) for x in raw)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static description of a CTR dataset's feature layout."""

    name: str
    num_dense: int
    num_sparse: int
    raw_vocab_sizes: Tuple[int, ...]
    # Split sizes (train/val/test), ref: nasrec/main_train.py:354-359.
    num_train: int = 0
    num_val: int = 0
    num_test: int = 0

    def vocab_sizes(self, cap: int | None = None) -> Tuple[int, ...]:
        return capped_vocab_sizes(self.raw_vocab_sizes, cap)

    @property
    def num_trainval(self) -> int:
        return self.num_train + self.num_val


DATASETS: Dict[str, DatasetSpec] = {
    "criteo-kaggle": DatasetSpec(
        name="criteo-kaggle", num_dense=13, num_sparse=26,
        raw_vocab_sizes=_RAW_NUM_EMBEDDINGS_CRITEO,
        num_train=36_672_495, num_val=4_584_061, num_test=4_584_061,
    ),
    "avazu": DatasetSpec(
        name="avazu", num_dense=1, num_sparse=23,
        raw_vocab_sizes=_RAW_NUM_EMBEDDINGS_AVAZU,
        num_train=32_343_175, num_val=4_042_896, num_test=4_042_896,
    ),
    "kdd": DatasetSpec(
        name="kdd", num_dense=3, num_sparse=10,
        raw_vocab_sizes=_RAW_NUM_EMBEDDINGS_KDD,
        num_train=119_711_284, num_val=14_963_910, num_test=14_963_910,
    ),
}

DENSE_UNARY_NODES = ("linear-2d", "zeros-2d")
DENSE_BINARY_NODES = ("sum", "sigmoid-gating")
DENSE_SPARSE_NODES = ("dot-product",)
SPARSE_NODES = ("zeros-3d", "transformer", "linear-3d")
ALL_NODE_NAMES = DENSE_UNARY_NODES + DENSE_BINARY_NODES + DENSE_SPARSE_NODES + SPARSE_NODES


@dataclasses.dataclass(frozen=True)
class OpsConfig:
    """One search-space definition (ref schema: nasrec/supernet/supernet.py:125-178)."""

    name: str
    node_names: Tuple[str, ...]
    dense_node_dims: Tuple[int, ...]
    sparse_node_dims: Tuple[int, ...]
    dense_nodes: Tuple[int, ...]   # indices into node_names producing 2-D output
    sparse_nodes: Tuple[int, ...]  # indices producing 3-D output
    zero_nodes: Tuple[int, ...]    # indices of zeros nodes

    def __post_init__(self):
        for n in self.node_names:
            if n not in ALL_NODE_NAMES:
                raise ValueError(f"unknown node {n}")

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def max_dense_dim(self) -> int:
        return max(self.dense_node_dims)

    @property
    def max_sparse_dim(self) -> int:
        return max(self.sparse_node_dims)


_DENSE_DIMS = (16, 32, 64, 128, 256, 512, 768, 1024)
_SPARSE_DIMS = (16, 32, 48, 64)

OPS_CONFIG_LIB: Dict[str, OpsConfig] = {
    # NASRec-Full space (ref: nasrec/supernet/supernet.py:135-150)
    "xlarge": OpsConfig(
        name="xlarge",
        node_names=("linear-2d", "dot-product", "sigmoid-gating", "sum",
                    "transformer", "linear-3d"),
        dense_node_dims=_DENSE_DIMS, sparse_node_dims=_SPARSE_DIMS,
        dense_nodes=(0, 1, 2, 3), sparse_nodes=(4, 5), zero_nodes=(),
    ),
    # ref: nasrec/supernet/supernet.py:151-168
    "xlarge-zeros": OpsConfig(
        name="xlarge-zeros",
        node_names=("linear-2d", "dot-product", "sigmoid-gating", "sum", "zeros-2d",
                    "transformer", "zeros-3d", "linear-3d"),
        dense_node_dims=_DENSE_DIMS, sparse_node_dims=_SPARSE_DIMS,
        dense_nodes=(0, 1, 2, 3, 4), sparse_nodes=(5, 6, 7), zero_nodes=(4, 6),
    ),
    # NASRec-Small space (ref: nasrec/supernet/supernet.py:169-177)
    "autoctr": OpsConfig(
        name="autoctr",
        node_names=("linear-2d", "dot-product", "linear-3d"),
        dense_node_dims=_DENSE_DIMS, sparse_node_dims=_SPARSE_DIMS,
        dense_nodes=(0, 1), sparse_nodes=(2,), zero_nodes=(),
    ),
}

# Path-sampling strategies, each a (macro, micro) pair
# (ref: nasrec/supernet/supernet.py:188-207).
PATH_SAMPLING_STRATEGY_LIB: Dict[str, Dict[str, str]] = {
    "default": {"macro": "any-path", "micro": "single-path"},
    "single-path": {"macro": "single-path", "micro": "single-path"},
    "any-path": {"macro": "any-path", "micro": "any-path"},
    "full-path": {"macro": "full-path", "micro": "full-path"},
    "fixed-path": {"macro": "fixed-path", "micro": "fixed-path"},
    "evo-2shot-path": {"macro": "evo-2shot-path", "micro": "evo-2shot-path"},
}

# Dense output of every block is split into this many pseudo-slots when merged
# into the sparse stream (ref: nasrec/supernet/supernet.py:882).
DS_INTERACT_NUM_SPLITS = 8

# Transformer node heads and residual-LN weight init (ref: modules.py:26, :598).
NUM_MHA_HEADS = 8
LN_INIT = 0.17

DEFAULT_EMBEDDING_DIM = 16
