"""Carry parameters and Adagrad accumulators between the JAX package's pytree
and the port's modules, both ways.

The JAX pytree of a model holds numpy arrays (after `jax.device_get`, or as a
checkpoint stores them) under the same names the port's modules use: dicts
where the port has modules, lists where it has a ModuleList (a supernet's
`blocks` and `nodes`, a fixed model's `blocks`), `str(k)`-keyed dicts where
it has a ModuleDict (a fixed model's `nodes`), `{}` for a module without
parameters.  Two conventions differ:

  - linear weights: JAX stores [in, out] and applies x @ w; the port stores
    PyTorch's [out, in].  Keys `w`, `w_in`, `w_out` are transposed.
  - names: JAX `w`/`b` -> `weight`/`bias`; LayerNorm `scale` -> `weight`.

The fused table is [vocab, 16] in both.  Arrays are copied both ways, never
aliased: a buffer from `device_get` may be read-only or shared with the JAX
runtime.  Checkpoints of both packages hold this pytree
(`train/checkpoint.py`), so each package loads the other's.

Optimizer states map slot by slot: Adagrad's accumulators are one pytree
mirroring the params; SGD's is an `SGDState(momentum)` and Adam's an
`AdamState(mu, nu, count)` of such pytrees (and an int32 count), in the JAX
package and, with the same fields, in the port (`train/optim.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

from nasrec_tpu_torch.models.fixed import FixedPlan
from nasrec_tpu_torch.models.supernet import SuperNetConfig
from nasrec_tpu_torch.train.optim import AdamState, SGDState

_TRANSPOSED = {"w": "weight", "w_in": "w_in", "w_out": "w_out"}
_RENAMED = {"b": "bias", "scale": "weight"}

ModelSpec = Union[FixedPlan, SuperNetConfig]


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        out[prefix] = tree


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Any JAX param subtree (numpy leaves) -> the matching module's state_dict."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        head, _, last = path.rpartition(".")
        arr = np.array(leaf, dtype=np.float32)
        if last in _TRANSPOSED:
            name, arr = _TRANSPOSED[last], arr.T
        else:
            name = _RENAMED.get(last, last)
        sd[f"{head}.{name}" if head else name] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def from_jax_params(params_np: Dict[str, Any], spec: ModelSpec) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) of a fixed subnet (`spec` a FixedPlan) or a
    supernet (`spec` a SuperNetConfig) -> the port's state_dict.

    Load with `model.load_state_dict(sd)` (strict), which also checks that the
    two packages built the same parameter set."""
    sd = state_dict_from_jax(params_np)
    rows = sum(spec.vocab_sizes)
    if tuple(sd["embedding.table"].shape) != (rows, spec.emb_dim):
        raise ValueError(f"embedding table {tuple(sd['embedding.table'].shape)} does "
                         f"not match the model's vocab ({rows} rows of {spec.emb_dim})")
    return sd


def from_jax_opt_state(opt_np: Any, spec: ModelSpec) -> Any:
    """A JAX optimizer state of numpy leaves (Adagrad accumulators mirroring
    the params, an SGDState or an AdamState) -> the port's state of the same
    kind, keyed by parameter name."""
    fields = getattr(opt_np, "_fields", None)    # either package's NamedTuple
    if fields == SGDState._fields:
        return SGDState(from_jax_params(opt_np.momentum, spec))
    if fields == AdamState._fields:
        return AdamState(from_jax_params(opt_np.mu, spec), from_jax_params(opt_np.nu, spec),
                         torch.tensor(int(opt_np.count), dtype=torch.int32))
    return from_jax_params(opt_np, spec)


def _jax_leaf(module: nn.Module, name: str, value: torch.Tensor):
    arr = value.detach().to("cpu", torch.float32).numpy()
    if isinstance(module, nn.LayerNorm):
        return {"weight": "scale", "bias": "bias"}[name], arr.copy()
    if name in ("weight", "w_in", "w_out"):
        return ("w" if name == "weight" else name), np.ascontiguousarray(arr.T)
    return ("b" if name == "bias" else name), arr.copy()


def _to_jax_tree(module: nn.Module, values: Mapping[str, torch.Tensor], prefix: str):
    if isinstance(module, nn.ModuleList):
        return [_to_jax_tree(child, values, f"{prefix}{i}.") for i, child in enumerate(module)]
    out: Dict[str, Any] = {}
    for name, _ in module.named_parameters(recurse=False):
        key, arr = _jax_leaf(module, name, values[prefix + name])
        out[key] = arr
    for name, child in module.named_children():
        out[name] = _to_jax_tree(child, values, f"{prefix}{name}.")
    return out


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The port's parameters -> the JAX package's pytree of numpy arrays
    (`[in, out]` weights, `w`/`b`/`scale`, lists and dicts as JAX has them)."""
    return _to_jax_tree(model, dict(model.named_parameters()), "")


def to_jax_opt_state(model: nn.Module, opt_state: Any) -> Any:
    """The port's optimizer state (slots keyed by parameter name) -> the JAX
    package's: a pytree mirroring its params for Adagrad, an SGDState or an
    AdamState (count as an int32 numpy scalar) of such pytrees."""
    if isinstance(opt_state, SGDState):
        return SGDState(_to_jax_tree(model, opt_state.momentum, ""))
    if isinstance(opt_state, AdamState):
        return AdamState(_to_jax_tree(model, opt_state.mu, ""),
                         _to_jax_tree(model, opt_state.nu, ""),
                         np.asarray(int(opt_state.count), np.int32))
    return _to_jax_tree(model, opt_state, "")
