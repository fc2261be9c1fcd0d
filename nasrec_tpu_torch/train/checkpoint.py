"""Checkpoint IO in the JAX package's layout (port of
`nasrec_tpu/train/checkpoint.py`, pickle backend).

A checkpoint is one pickle of a dict: `params` and `opt_state` as the JAX
package's pytrees of numpy arrays (`models/transplant.py :: to_jax_params`,
`to_jax_opt_state`; the table as [vocab, 16]), `step`, and an options dict.
Torch tensors in a payload are written as numpy arrays, so each package
loads the other's.  Writes go to `<path>.tmp` and are renamed into place.
The orbax backend is not ported.

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

import os
import pickle
from typing import Any, Dict

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


def _not_ported_orbax() -> NotImplementedError:
    return NotImplementedError("orbax checkpoints (--ckpt_backend orbax) are not yet "
                               "ported to nasrec_tpu_torch (see ROADMAP.md, Queue A)")


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


def save_checkpoint_any(path: str, payload: Dict[str, Any], backend: str = "pickle") -> None:
    if backend == "orbax":
        raise _not_ported_orbax()
    if backend != "pickle":
        raise NotImplementedError(f"ckpt backend {backend}")
    save_checkpoint(path, payload)


def load_any_checkpoint(path: str) -> Dict[str, Any]:
    """Load a pickle checkpoint (an orbax one is a directory: not ported)."""
    if os.path.isdir(path):
        raise _not_ported_orbax()
    return load_checkpoint(path)
