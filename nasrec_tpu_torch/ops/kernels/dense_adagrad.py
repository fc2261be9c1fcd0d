"""Global-norm clip and Adagrad update of a list of dense tensors: the CUDA
kernel (`csrc/dense_adagrad.cu`) and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package leaves the clip and the dense
Adagrad to XLA.  The plain versions are the port's loops over the tensors
(the sparse step's clip, then `train/optim.py :: adagrad_update_`), a few
launches a tensor; the kernel takes the whole list in a few launches.  Two
entries, so that each runs under its own span of the step:

- `clip_scale(grads, max_norm, extra)`: min(max_norm / (||grads, extra|| +
  1e-6), 1) as a 0-dim f32 tensor on the tensors' device; the norm covers
  every tensor of `grads` and, where given, `extra` (the table's summed
  gradient).  Nothing is read back to the host.
- `adagrad_(params, accs, grads, lr, eps, scale)`: in place, with
  gs = g * scale (g where scale is None), acc += gs * gs and
  p -= lr * gs / (sqrt(acc) + eps), without materialising g * scale.
  `make_optimizer("adagrad").update_` (`train/optim.py`) calls it, so the
  steps that train through that optimizer take the kernel on the card.

Given the same scale the kernel's parameters and accumulators are the plain
version's bit for bit; its scale sums the squares in another order (in f64,
in an order fixed by the sizes alone), so it is within a few ulps of the
plain version's.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.ops.kernels import build
from nasrec_tpu_torch.train.optim import adagrad_update_, global_norm_scale

# Floats a block of the kernel (csrc/dense_adagrad.cu: kChunk): the norm
# pass writes one partial sum a block.
CHUNK = 16384

# Calls that launched the kernel ("clip_scale": the norm and the scale;
# "adagrad": the update), one a call whatever the number of launches its
# list takes; added to where it is launched and nowhere else.
LAUNCHES: Counter = Counter()


def _table(lists, what: str, device):
    """(pointers, sizes): int64 arrays [len(lists) * n], each list's data
    pointers and sizes, list after list.  Raises on a tensor that is not a
    contiguous f32 tensor on `device`, or where the lists' sizes differ.
    (Checked a property at a time over the whole list: a step's list is
    hundreds of tensors, and the host's time is what the kernel saves.)"""
    flat = [t for tensors in lists for t in tensors]
    if ({t.dtype for t in flat} != {torch.float32}
            or set(map(torch.Tensor.get_device, flat)) != {device.index}
            or not all(map(torch.Tensor.is_contiguous, flat))):
        bad = next(t for t in flat if t.dtype != torch.float32 or t.device != device
                   or not t.is_contiguous())
        raise ValueError(f"dense_adagrad: every {what} must be a contiguous float32 tensor "
                         f"on {device}, got a {'' if bad.is_contiguous() else 'non-contiguous '}"
                         f"{bad.dtype} tensor on {bad.device}")
    ptrs = np.fromiter(map(torch.Tensor.data_ptr, flat), np.int64, len(flat))
    sizes = np.fromiter(map(torch.Tensor.numel, flat), np.int64, len(flat))
    if len(lists) > 1 and not (sizes.reshape(len(lists), -1) == sizes[:len(lists[0])]).all():
        raise ValueError(f"dense_adagrad: the sizes of each {what} differ")
    return ptrs, sizes


def clip_scale_plain(grads: Sequence[torch.Tensor], max_norm: float,
                     extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the squared norm of each gradient, stacked and summed,
    plus the squared norm of `extra`."""
    sq = torch.stack([torch.sum(torch.square(g)) for g in grads]).sum()
    if extra is not None:
        sq = sq + torch.sum(torch.square(extra))
    return global_norm_scale(sq, max_norm)


def clip_scale_kernel(grads: Sequence[torch.Tensor], max_norm: float,
                      extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel's norm pass and scale."""
    tensors = list(grads) + ([] if extra is None else [extra])
    device = tensors[0].device
    ptrs, sizes = _table([tensors], "gradient", device)
    partials = torch.empty(int(((sizes + CHUNK - 1) // CHUNK).sum()), dtype=torch.float64,
                           device=device)
    scale = torch.empty((), dtype=torch.float32, device=device)
    lib = build.load_library("dense_adagrad")
    build.check(lib.nasrec_dense_clip_scale(
        ptrs.ctypes.data, sizes.ctypes.data, len(tensors), partials.data_ptr(),
        partials.numel(), float(max_norm), scale.data_ptr(), build.current_stream()),
        "dense_adagrad clip_scale")
    LAUNCHES["clip_scale"] += 1
    return scale


def clip_scale(grads: Sequence[torch.Tensor], max_norm: float,
               extra: Optional[torch.Tensor] = None, impl: str = "auto") -> torch.Tensor:
    """The global-norm clip's scale of `grads` and `extra`, on their device.
    CUDA tensors go through the kernel, CPU tensors through the plain
    version; impl='plain' names it."""
    first = grads[0] if len(grads) else extra
    if build.resolve_impl(impl, first) == "plain":
        return clip_scale_plain(grads, max_norm, extra)
    return clip_scale_kernel(grads, max_norm, extra)


def adagrad_plain(params, accs, grads, lr: float, eps: float,
                  scale: Optional[torch.Tensor] = None) -> None:
    """Plain version: g * scale for each gradient, then `adagrad_update_`."""
    if scale is not None:
        grads = [g * scale for g in grads]
    adagrad_update_(params, accs, grads, lr, eps)


def adagrad_kernel(params, accs, grads, lr: float, eps: float,
                   scale: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel's update (in place)."""
    if not len(params) == len(accs) == len(grads):
        raise ValueError(f"dense_adagrad: {len(params)} parameters, {len(accs)} "
                         f"accumulators and {len(grads)} gradients")
    device = params[0].device
    if scale is not None:
        if scale.numel() != 1:
            raise ValueError(f"dense_adagrad: scale must hold one value, got {scale.numel()}")
        _table([[scale]], "scale", device)
    ptrs, sizes = _table([params, accs, grads], "parameter, accumulator and gradient",
                         device)
    lib = build.load_library("dense_adagrad")
    build.check(lib.nasrec_dense_adagrad(
        ptrs.ctypes.data, sizes.ctypes.data, len(params),
        None if scale is None else scale.data_ptr(), float(lr), float(eps),
        build.current_stream()), "dense_adagrad")
    LAUNCHES["adagrad"] += 1


def adagrad_(params: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], lr: float, eps: float,
             scale: Optional[torch.Tensor] = None, impl: str = "auto") -> None:
    """Adagrad over the list, in place, with each gradient scaled by `scale`
    (a 0-dim tensor from `clip_scale`, or None).  CUDA tensors go through the
    kernel, CPU tensors through the plain version; impl='plain' names it.
    Under a profiler the innermost open span counts the tensors the kernel
    updated (`train.dense_tensors_fused`; 0 on the plain version)."""
    if not len(params):
        return
    if build.resolve_impl(impl, params[0]) == "plain":
        adagrad_plain(params, accs, grads, lr, eps, scale)
        tracing.count("train.dense_tensors_fused", 0)
        return
    adagrad_kernel(params, accs, grads, lr, eps, scale)
    tracing.count("train.dense_tensors_fused", len(params))
