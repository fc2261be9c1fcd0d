"""Shared primitives: linear / layernorm / activations / init, and the flat
slot-major sparse layout helpers (port of `nasrec_tpu/ops/common.py`).

Weights use PyTorch's layout: a linear weight is [out, in] and applies as
`F.linear(x, w, b)` (the JAX package stores [in, out] and applies x @ w;
`models/transplant.py` transposes).  Init parity with the reference
(ref: nasrec/utils/train_utils.py:70-89): linear -> xavier-uniform weight and
zero bias, embedding -> xavier-normal.  LayerNorm eps is torch's 1e-5.

Compute dtype (the JAX package's rule, `nasrec_tpu/ops/common.py`): the
parameters stay float32; a linear casts its weight and bias to its input's
dtype at the call, and a LayerNorm takes its statistics and affine in
float32 and returns its input's dtype.  So a bf16 activation stays bf16
through every op, and the parameters' gradients come back float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-5


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def xavier_normal_(w: torch.Tensor, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


class Linear(nn.Linear):
    """nn.Linear with xavier-uniform weight and zero bias from a generator."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool,
                 generator: torch.Generator, device=None):
        super().__init__(in_dim, out_dim, bias=bias, device=device)
        xavier_uniform_(self.weight, in_dim, out_dim, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_cast(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, weight filled with `init`."""

    def __init__(self, dim: int, init: float = 1.0, device=None):
        super().__init__(dim, eps=LN_EPS, device=device)
        with torch.no_grad():
            self.weight.fill_(init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_cast(x, self.normalized_shape, self.weight, self.bias, self.eps)


def linear_cast(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """F.linear with the weight and bias cast to x's dtype."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm_cast(x: torch.Tensor, shape, w: torch.Tensor, b: torch.Tensor,
                    eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm with its statistics and affine in float32, in x's dtype."""
    if x.dtype == torch.float32:
        return F.layer_norm(x, shape, w, b, eps)
    return F.layer_norm(x.float(), shape, w, b, eps).to(x.dtype)


ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "identity": lambda x: x,
}


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor], axis: int = -1) -> torch.Tensor:
    """Multiply by a width mask along `axis` (None = fixed mode, no-op).  A
    [K, W] mask holds K candidates' masks over x's rows folded from [K, B]:
    rows k B to (k + 1) B take mask k."""
    if mask is None:
        return x
    mask = mask.to(x.dtype)
    if mask.dim() == 2:
        k = mask.shape[0]
        shape = [k] + [1] * x.ndim
        shape[axis % x.ndim + 1] = mask.shape[1]
        return (x.reshape(k, -1, *x.shape[1:]) * mask.reshape(shape)).reshape(x.shape)
    if axis == -1 or axis == x.ndim - 1:
        return x * mask
    shape = [1] * x.ndim
    shape[axis] = mask.shape[0]
    return x * mask.reshape(shape)


# FLAT sparse layout [B, S*E] (slot-major flatten) and its E-major view
# [B, E, S] for ops that contract the slot axis.  The port keeps the JAX
# package's layout at every op boundary, so slot-axis concat, the ds-interact
# merge and the head flatten stay plain 2-D ops and transplanted head weights
# line up column for column.


def flat_to_emajor(x: torch.Tensor, slots: int, emb_dim: int) -> torch.Tensor:
    """[B, S*E] slot-major flat -> E-major [B, E, S] (a strided view)."""
    return x.reshape(x.shape[0], slots, emb_dim).transpose(1, 2)


def emajor_to_flat(xt: torch.Tensor) -> torch.Tensor:
    """E-major [B, E, S] -> slot-major flat [B, S*E]."""
    b, e, s = xt.shape
    return xt.transpose(1, 2).reshape(b, s * e)


def linear_apply_e(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Feature linear on E-major [B, E, S]: contract the E axis."""
    y = torch.einsum("fe,bes->bfs", lin.weight.to(x.dtype), x)
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)[None, :, None]
    return y


def ln_apply_e(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the E axis of E-major [B, E, S]."""
    return layer_norm_cast(x.transpose(1, 2), ln.normalized_shape, ln.weight,
                           ln.bias, ln.eps).transpose(1, 2)
