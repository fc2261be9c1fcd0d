"""Architecture-choice schema, validation, enumeration and lowering to
static-shape masks (a copy of `nasrec_tpu/choices.py`).

    choice = {
      "macro": [ {"dense_idx": [..], "sparse_idx": [..],
                  "dense_left_idx": [..], "dense_right_idx": [..]} ],  # per block
      "micro": [ {"active_nodes": [d, s], "dense_in_dims": int,
                  "sparse_in_dims": int, "dense_sparse_interact": 0|1,
                  "deep_fm": 0|1} ],                                    # per block
    }

Block i may consume outputs of virtual blocks 0..i, where 0 is the input stem
and j >= 1 is choice block j-1 (ref: nasrec/supernet/supernet.py:432-511).

The supernet takes a choice as `ChoiceMasks`: 0/1 float arrays of fixed
shapes, made on the host with numpy as in the JAX package.  `ChoiceMasks.to`
moves them to a device as torch tensors, so one step serves every subnet and
no mask value is read back on the host.
"""

from __future__ import annotations

import dataclasses
import json
from itertools import combinations
from typing import Any, Dict, List

import numpy as np
import torch
import torch.utils._pytree

from nasrec_tpu_torch.config import OpsConfig

Choice = Dict[str, Any]


def validate_choice(choice: Choice, space: OpsConfig, num_blocks: int) -> None:
    """Raise ValueError if `choice` is not a valid subnet of `space`."""
    macro = choice.get("macro")
    micro = choice.get("micro")
    if macro is None or micro is None:
        raise ValueError("choice must contain 'macro' and 'micro'")
    if len(macro) != num_blocks or len(micro) != num_blocks:
        raise ValueError(
            f"choice must have {num_blocks} macro+micro entries, got "
            f"{len(macro)}/{len(micro)}"
        )
    for i in range(num_blocks):
        m = macro[i]
        for key in ("dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx"):
            idxs = m[key]
            if len(idxs) == 0:
                raise ValueError(f"block {i}: macro['{key}'] empty")
            for j in idxs:
                if not (0 <= int(j) <= i):
                    raise ValueError(f"block {i}: macro['{key}'] index {j} out of range")
        mi = micro[i]
        active = [int(a) for a in mi["active_nodes"]]
        for a in active:
            if not (0 <= a < space.num_nodes):
                raise ValueError(f"block {i}: active node {a} out of range")
        if not any(a in space.dense_nodes for a in active):
            raise ValueError(f"block {i}: no active dense node")
        if not any(a in space.sparse_nodes for a in active):
            raise ValueError(f"block {i}: no active sparse node")
        if sorted(active) == sorted(space.zero_nodes):
            raise ValueError(f"block {i}: all active nodes are zero nodes")
        if int(mi["dense_in_dims"]) not in space.dense_node_dims:
            raise ValueError(f"block {i}: bad dense_in_dims {mi['dense_in_dims']}")
        if int(mi["sparse_in_dims"]) not in space.sparse_node_dims:
            raise ValueError(f"block {i}: bad sparse_in_dims {mi['sparse_in_dims']}")
        for flag in ("dense_sparse_interact", "deep_fm"):
            if int(mi[flag]) not in (0, 1):
                raise ValueError(f"block {i}: {flag} must be 0/1")


def load_choice_file(path: str) -> Dict[str, Any]:
    """Load a best-arch JSON (reference schema).  Returns the full payload."""
    with open(path, "r") as f:
        return json.load(f)


def full_path_choice(space: OpsConfig, num_blocks: int) -> Choice:
    """The whole-supernet choice: all nodes, all inputs, max dims
    (ref: nasrec/supernet/supernet.py:814-824 macro, :1265-1276 micro)."""
    macro: List[dict] = []
    micro: List[dict] = []
    for i in range(num_blocks):
        allp = list(range(i + 1))
        macro.append({"dense_idx": list(allp), "sparse_idx": list(allp),
                      "dense_left_idx": list(allp), "dense_right_idx": list(allp)})
        micro.append({"active_nodes": list(range(space.num_nodes)),
                      "dense_in_dims": space.max_dense_dim,
                      "sparse_in_dims": space.max_sparse_dim,
                      "dense_sparse_interact": 1, "deep_fm": 1})
    return {"macro": macro, "micro": micro}


def enumerate_macro_choices(block_idx: int) -> Dict[str, list]:
    """All macro input selections of one block (ref: supernet.py:670-712):
    every non-empty subset of prior outputs for dense/sparse, singletons for
    the binary nodes' left/right inputs."""
    n_prior = block_idx + 1
    subsets: List[tuple] = []
    for k in range(1, n_prior + 1):
        subsets += list(combinations(range(n_prior), k))
    singles = [(j,) for j in range(n_prior)]
    return {"dense_idx": list(subsets), "sparse_idx": list(subsets),
            "dense_left_idx": list(singles), "dense_right_idx": list(singles)}


def enumerate_micro_choices(space: OpsConfig) -> Dict[str, list]:
    """All micro options of one block (ref: supernet.py:1164-1183)."""
    return {
        "active_nodes": [(d, s) for s in space.sparse_nodes for d in space.dense_nodes],
        "dense_in_dims": [(d,) for d in space.dense_node_dims],
        "sparse_in_dims": [(d,) for d in space.sparse_node_dims],
        "dense_sparse_interact": [0, 1],
        "deep_fm": [0, 1],
    }


def get_all_subnet_choices(space: OpsConfig, num_blocks: int) -> Dict[str, list]:
    """Per-block enumeration of the whole choice space (ref: supernet.py:714-721)."""
    return {"macro": [enumerate_macro_choices(i) for i in range(num_blocks)],
            "micro": [enumerate_micro_choices(space) for _ in range(num_blocks)]}


def choice_to_json(choice: Choice, *, num_blocks: int, config_name: str,
                   use_layernorm: bool = False, extra: dict | None = None) -> str:
    payload = {
        "micro": [
            {"active_nodes": [int(a) for a in m["active_nodes"]],
             "dense_in_dims": int(m["dense_in_dims"]),
             "sparse_in_dims": int(m["sparse_in_dims"]),
             "dense_sparse_interact": int(m["dense_sparse_interact"]),
             "deep_fm": int(m["deep_fm"])}
            for m in choice["micro"]
        ],
        "macro": [
            {k: [int(j) for j in m[k]] for k in
             ("dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx")}
            for m in choice["macro"]
        ],
        "num_blocks": int(num_blocks),
        "use_layernorm": int(use_layernorm),
        "config": config_name,
    }
    if extra:
        payload.update(extra)
    return json.dumps(payload, indent=1)


def choice_from_json(text_or_obj) -> Choice:
    obj = json.loads(text_or_obj) if isinstance(text_or_obj, (str, bytes)) else text_or_obj
    return {"macro": obj["macro"], "micro": obj["micro"]}


@dataclasses.dataclass
class ChoiceMasks:
    """Static-shape mask encoding of a choice (B = num_blocks, N = num_nodes),
    all float32, numpy on the host or torch tensors after `to`:

      dense_sel / sparse_sel / left_sel / right_sel : [B, B]  ([i, j] = 1 iff
          block i consumes virtual block j; only j <= i is ever set)
      node_act   : [B, N]
      dense_dim  : [B, max_dense]   (prefix-ones width mask)
      sparse_dim : [B, max_sparse]
      interact   : [B]
      deep_fm    : [B]

    A leading axis of any size stacks several choices (`stack`); `select`
    picks one of them without leaving the device.
    """

    dense_sel: Any
    sparse_sel: Any
    left_sel: Any
    right_sel: Any
    node_act: Any
    dense_dim: Any
    sparse_dim: Any
    interact: Any
    deep_fm: Any

    def astuple(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def to(self, device) -> "ChoiceMasks":
        """The masks as float32 torch tensors on `device` (no copy for a leaf
        that is one already)."""
        return ChoiceMasks(*(torch.as_tensor(x, dtype=torch.float32, device=device)
                             for x in self.astuple()))

    def select(self, idx: int) -> "ChoiceMasks":
        """Choice `idx` of a stack (indexing views; nothing is read back)."""
        return ChoiceMasks(*(x[idx] for x in self.astuple()))

    @staticmethod
    def stack(masks: List["ChoiceMasks"]) -> "ChoiceMasks":
        """Host masks of several choices stacked on a new leading axis."""
        return ChoiceMasks(*(np.stack(xs) for xs in zip(*(m.astuple() for m in masks))))


# A pytree node, so that torch.func.vmap maps over a stack of choices (the
# leading axis of every leaf) as jax.vmap maps over the JAX package's masks.
torch.utils._pytree.register_pytree_node(
    ChoiceMasks, lambda m: (list(m.astuple()), None), lambda leaves, _: ChoiceMasks(*leaves),
    serialized_type_name="nasrec_tpu_torch.choices.ChoiceMasks")


def prefix_mask(width: int, dims_in_use: int) -> np.ndarray:
    """[1]*dims_in_use + [0]*(width-dims_in_use)  (ref: modules.py:57-96)."""
    m = np.zeros((width,), dtype=np.float32)
    m[: int(dims_in_use)] = 1.0
    return m


def choice_to_masks(choice: Choice, space: OpsConfig, num_blocks: int) -> ChoiceMasks:
    nb, nn = num_blocks, space.num_nodes
    sel = {k: np.zeros((nb, nb), np.float32)
           for k in ("dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx")}
    node_act = np.zeros((nb, nn), np.float32)
    dense_dim = np.zeros((nb, space.max_dense_dim), np.float32)
    sparse_dim = np.zeros((nb, space.max_sparse_dim), np.float32)
    interact = np.zeros((nb,), np.float32)
    deep_fm = np.zeros((nb,), np.float32)
    for i in range(nb):
        m, mi = choice["macro"][i], choice["micro"][i]
        for key, arr in sel.items():
            for j in m[key]:
                arr[i, int(j)] = 1.0
        for a in mi["active_nodes"]:
            node_act[i, int(a)] = 1.0
        dense_dim[i] = prefix_mask(space.max_dense_dim, mi["dense_in_dims"])
        sparse_dim[i] = prefix_mask(space.max_sparse_dim, mi["sparse_in_dims"])
        interact[i] = float(mi["dense_sparse_interact"])
        deep_fm[i] = float(mi["deep_fm"])
    return ChoiceMasks(sel["dense_idx"], sel["sparse_idx"], sel["dense_left_idx"],
                       sel["dense_right_idx"], node_act, dense_dim, sparse_dim,
                       interact, deep_fm)
