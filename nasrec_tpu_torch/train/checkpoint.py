"""Checkpoint IO in the JAX package's layout (port of
`nasrec_tpu/train/checkpoint.py`, pickle backend).

A checkpoint is one pickle of a dict: `params` and `opt_state` as the JAX
package's pytrees of numpy arrays (`models/transplant.py :: to_jax_params`,
`to_jax_opt_state`; the table as [vocab, 16]), `step`, and an options dict.
Torch tensors in a payload are written as numpy arrays, so reading a
checkpoint needs neither torch nor this package, and each package loads the
other's.  Writes go to `<path>.tmp` and are renamed into place.  The orbax
backend is not ported.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch


def _not_ported_orbax() -> NotImplementedError:
    return NotImplementedError("orbax checkpoints (--ckpt_backend orbax) are not yet "
                               "ported to nasrec_tpu_torch (see ROADMAP.md, Queue A)")


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


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

