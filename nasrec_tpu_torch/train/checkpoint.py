"""Checkpoint IO in the JAX package's layout (port of
`nasrec_tpu/train/checkpoint.py`).

A pickle checkpoint is one pickle of a dict: `params` and `opt_state` as the
JAX package's pytrees of numpy arrays (`models/transplant.py ::
to_jax_params`, `to_jax_opt_state`; the table as [vocab, 16]), `step`, and an
options dict.  Torch tensors in a payload are written as numpy arrays, so
each package loads the other's.  Writes go to `<path>.tmp` and are renamed
into place.

The "orbax" backend writes a directory, as the JAX package's does: the
payload's array entries under `arrays/`, its other entries in
`sidecar.json` (the same file as the JAX package's).  The port may not import
orbax, so `arrays/` is written with `torch.distributed.checkpoint` (its
leaves as tensors, and the tree's structure as a JSON string beside them),
and neither package reads the other's `arrays/`.  What a load returns is what
the JAX package's orbax restore returns: dicts and lists of numpy arrays, a
NamedTuple as a dict of its fields, `step` as a 0-d array.

SGD and Adam states are the JAX package's `SGDState` and `AdamState`
NamedTuples, which its pickles name by their module,
`nasrec_tpu.train.optim`.  The port has its own copies (`train/optim.py`) and
imports nothing of the JAX package, so it reads those two names as its own
classes (`_Unpickler.find_class`) and writes its own classes under the JAX
package's names (`_Pickler.save_global`, on the pure-Python pickler, which
lets a subclass emit a global by name).  Every other global is read and
written as pickle does it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import warnings
from typing import Any, Dict

import numpy as np
import torch

from nasrec_tpu_torch.train.optim import AdamState, SGDState

JAX_OPTIM_MODULE = "nasrec_tpu.train.optim"
_AS_JAX = {SGDState: "SGDState", AdamState: "AdamState"}
_FROM_JAX = {(JAX_OPTIM_MODULE, name): cls for cls, name in _AS_JAX.items()}


class _Pickler(pickle._Pickler):
    def save_global(self, obj, name=None):
        if obj not in _AS_JAX:
            return super().save_global(obj, name)
        # Protocol 4 and up: module and name as strings, then STACK_GLOBAL.
        self.save(JAX_OPTIM_MODULE)
        self.save(_AS_JAX[obj])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _FROM_JAX.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):     # a NamedTuple
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(_to_numpy(payload))
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


SIDECAR = "sidecar.json"
ARRAYS = "arrays"
_SKELETON = "skeleton"      # the DCP entry that holds the tree's structure


def _is_array_leaf(x) -> bool:
    return (isinstance(x, (np.ndarray, np.generic, torch.Tensor, int, float))
            and not isinstance(x, bool))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _is_array_tree(tree) -> bool:
    """An entry of arrays only (as the JAX package's `_is_array_tree`): it
    goes under arrays/, anything else into the sidecar."""
    leaves = list(_leaves(tree))
    return bool(leaves) and all(_is_array_leaf(x) for x in leaves)


def _split(tree, flat: Dict[str, torch.Tensor]):
    """The tree's skeleton (a leaf as {"__leaf__": key}, a NamedTuple as a
    dict of its fields), its leaves collected into `flat` as CPU tensors."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _split(v, flat) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {str(k): _split(v, flat) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_split(v, flat) for v in tree]
    key = f"leaf/{len(flat)}"
    flat[key] = (tree.detach().cpu().clone() if isinstance(tree, torch.Tensor)
                 else torch.from_numpy(np.array(tree)))
    return {"__leaf__": key}


def _join(skeleton, flat: Dict[str, torch.Tensor]):
    if isinstance(skeleton, list):
        return [_join(v, flat) for v in skeleton]
    if set(skeleton) == {"__leaf__"}:
        return flat[skeleton["__leaf__"]].numpy()
    return {k: _join(v, flat) for k, v in skeleton.items()}


def save_checkpoint_dcp(path: str, payload: Dict[str, Any]) -> None:
    """`payload`'s array entries under `path/arrays` (torch.distributed.
    checkpoint, one writer), the others in `path/sidecar.json`; a checkpoint
    already at `path` is replaced."""
    arrays = {k: v for k, v in payload.items() if _is_array_tree(v)}
    extras = {k: v for k, v in payload.items() if k not in arrays}
    if os.path.isdir(path):
        shutil.rmtree(path)
    flat: Dict[str, Any] = {}
    skeleton = _split(arrays, flat)
    flat[_SKELETON] = json.dumps(skeleton)
    from torch.distributed import checkpoint as dcp

    with warnings.catch_warnings():    # "assuming the intent is to save in a single process"
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(flat, checkpoint_id=os.path.join(path, ARRAYS), no_dist=True)
    with open(os.path.join(path, SIDECAR), "w") as f:
        json.dump(extras, f, default=str)


def load_checkpoint_dcp(path: str) -> Dict[str, Any]:
    """Read a directory written by `save_checkpoint_dcp`."""
    from torch.distributed import checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    arrays_dir = os.path.join(path, ARRAYS)
    meta = dcp.FileSystemReader(arrays_dir).read_metadata().state_dict_metadata
    flat = {k: torch.empty(m.size, dtype=m.properties.dtype)
            if isinstance(m, TensorStorageMetadata) else "" for k, m in meta.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(flat, checkpoint_id=arrays_dir, no_dist=True)
    payload = _join(json.loads(flat.pop(_SKELETON)), flat)
    sidecar = os.path.join(path, SIDECAR)
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            payload.update(json.load(f))
    return payload


def save_checkpoint_any(path: str, payload: Dict[str, Any], backend: str = "pickle") -> None:
    """Save `payload` with the chosen backend: "pickle" (one file) or "orbax"
    (a directory at `path`, see the module docstring)."""
    if backend == "pickle":
        save_checkpoint(path, payload)
    elif backend == "orbax":
        save_checkpoint_dcp(path, payload)
    else:
        raise NotImplementedError(f"ckpt backend {backend}")


def load_any_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint of either backend (a directory is the orbax one)."""
    if os.path.isdir(path):
        return load_checkpoint_dcp(path)
    return load_checkpoint(path)


def as_opt_state(tree: Any) -> Any:
    """An optimizer state as a directory checkpoint restores it (a
    NamedTuple as a dict of its fields) -> the NamedTuple again; any other
    state as it is."""
    if isinstance(tree, dict):
        for cls in (SGDState, AdamState):
            if set(tree) == set(cls._fields):
                return cls(**tree)
    return tree
