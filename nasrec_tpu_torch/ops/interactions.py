"""Dense/sparse interaction operators: DotProduct, Sum, SigmoidGating, FM3D
(port of `nasrec_tpu/ops/interactions.py`).

Projection elision follows the reference's LazyLinear rules, decided at init
from the known widths (ref: nasrec/supernet/modules.py:339-389, :488-495,
:583-586, :739-743), so fixed subnets have the reference's exact parameter
set.  Absent projections are `None` attributes.  In the supernet a
`dim_mask` multiplies each node's output last; the fixed path passes none.
The dot-product kernel never sees the mask: it takes x and yt as they lie.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.ops.common import (
    LayerNorm,
    Linear,
    apply_mask,
    flat_to_emajor,
    linear_apply_e,
    ln_apply_e,
)
from nasrec_tpu_torch.ops.kernels.dotprod import dot_scores_tril


def dot_product_slot_dim(out_dim: int) -> int:
    """Slot-axis projection width: round(sqrt(2*out_dim)) (ref :298)."""
    return round((2 * out_dim) ** 0.5)


class DotProduct(nn.Module):
    """Pairwise dot-product interaction (ref: modules.py:273-401), flat layout.

    dense_in      width of the incoming dense tensor
    sparse_slots  slot count of the incoming sparse tensor
    out_dim       this node's output width
    """

    def __init__(self, dense_in: int, sparse_slots: int, out_dim: int, emb_dim: int,
                 use_layernorm: bool, generator: torch.Generator, device=None,
                 sparse_feat_dim: int | None = None):
        super().__init__()
        sparse_feat_dim = emb_dim if sparse_feat_dim is None else sparse_feat_dim
        bias = not use_layernorm
        ln = (lambda d: LayerNorm(d, device=device)) if use_layernorm else (lambda d: None)
        self.dense_proj = self.dense_ln = None
        self.sparse_proj = self.sparse_ln = None
        self.slot_proj = self.slot_ln = None
        self.out_proj = None
        if dense_in != emb_dim:                       # ref :339-345
            self.dense_proj = Linear(dense_in, emb_dim, bias, generator, device)
            self.dense_ln = ln(emb_dim)
        if sparse_feat_dim != emb_dim:                # ref :348-354
            self.sparse_proj = Linear(sparse_feat_dim, emb_dim, bias, generator, device)
            self.sparse_ln = ln(emb_dim)
        slot_dim = dot_product_slot_dim(out_dim)
        if sparse_slots != slot_dim:                  # ref :357-364
            self.slot_proj = Linear(sparse_slots, slot_dim, bias, generator, device)
            self.slot_ln = ln(slot_dim)
        n = 1 + slot_dim
        n_interactions = n * (n - 1) // 2             # tril offset -1 (ref :374-379)
        if n_interactions != out_dim:                 # ref :384-389
            self.out_proj = Linear(n_interactions, out_dim, bias, generator, device)
        self.out_ln = ln(out_dim)                     # final LN iff layernorm (ref :391-392)

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor, in_slots: int,
                emb_dim: int, impl: str = "auto",
                dim_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """dense [B, D], sparse [B, S*E] slot-major flat -> [B, out_dim]."""
        x = dense
        if self.dense_proj is not None:
            x = self.dense_proj(x)
            if self.dense_ln is not None:
                x = self.dense_ln(x)
        yt = flat_to_emajor(sparse, in_slots, emb_dim)    # [B, F, S]
        if self.sparse_proj is not None:                  # contract the feature axis
            yt = linear_apply_e(self.sparse_proj, yt)
            if self.sparse_ln is not None:
                yt = ln_apply_e(self.sparse_ln, yt)
        if self.slot_proj is not None:
            yt = self.slot_proj(yt)                       # [B, E, slot_dim]
            if self.slot_ln is not None:
                yt = self.slot_ln(yt)
        # The kernel takes the projected dense row and the slots as they lie.
        out = dot_scores_tril(x, yt, impl)                # [B, P], n = 1 + slot_dim
        if self.out_proj is not None:
            out = self.out_proj(out)
        if self.out_ln is not None:
            out = self.out_ln(out)
        return apply_mask(out, dim_mask)


def pad_align_2d(left: torch.Tensor, right: torch.Tensor):
    """Zero-pad the narrower tensor to match widths (ref :403-430)."""
    dl, dr = left.shape[-1], right.shape[-1]
    if dl < dr:
        return F.pad(left, (0, dr - dl)), right
    if dr < dl:
        return left, F.pad(right, (0, dl - dr))
    return left, right


class Sum(nn.Module):
    """Sum of two dense inputs (ref: modules.py:432-501); no activation."""

    def __init__(self, left_in: int, right_in: int, out_dim: int, use_layernorm: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        width = max(left_in, right_in)
        self.proj = (Linear(width, out_dim, not use_layernorm, generator, device)
                     if width != out_dim else None)                  # ref :488-491
        self.ln = LayerNorm(out_dim, device=device) if use_layernorm else None

    def forward(self, left, right, dim_mask: Optional[torch.Tensor] = None):
        left, right = pad_align_2d(left, right)
        out = left + right
        if self.proj is not None:
            out = self.proj(out)
        if self.ln is not None:
            out = self.ln(out)
        return apply_mask(out, dim_mask)


class SigmoidGating(nn.Module):
    """out = proj(sigmoid(self_linear(left)) * right) (ref: modules.py:504-595)."""

    def __init__(self, left_in: int, right_in: int, out_dim: int, use_layernorm: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        width = max(left_in, right_in)
        # LazySelfLinear always has bias (ref :515); proj always has bias (ref :541).
        self.self_linear = Linear(width, width, True, generator, device)
        self.proj = (Linear(width, out_dim, True, generator, device)
                     if width != out_dim else None)                  # ref :583-586
        self.ln = LayerNorm(out_dim, device=device) if use_layernorm else None

    def forward(self, left, right, dim_mask: Optional[torch.Tensor] = None):
        left, right = pad_align_2d(left, right)
        out = torch.sigmoid(self.self_linear(left)) * right
        if self.proj is not None:
            out = self.proj(out)
        if self.ln is not None:
            out = self.ln(out)
        return apply_mask(out, dim_mask)


def fm3d_matmul_flops(b: int, slots: int, emb_dim: int) -> int:
    """FLOPs that `profiling.dot_flops` charges an FM3D forward (and again its
    backward): the JAX package sums the slots with two products by a static
    [S*E, E] block identity (nasrec_tpu/ops/interactions.py ::
    fm3d_apply_flat), which its count sees; the port sums them without a
    product, and reports the same number so that the two counts agree."""
    return 2 * 2 * b * slots * emb_dim * emb_dim


class FM3D(nn.Module):
    """FactorizationMachine3D (ref: modules.py:720-750): over the slot axis,
    (sum_s x)^2 - sum_s x^2, then an optional projection + LN."""

    def __init__(self, feat_dim: int, out_dim: int, use_layernorm: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.proj = self.ln = None
        if feat_dim != out_dim:                        # ref :739-743
            self.proj = Linear(feat_dim, out_dim, not use_layernorm, generator, device)
            if use_layernorm:
                self.ln = LayerNorm(out_dim, device=device)

    def forward(self, sparse: torch.Tensor, in_slots: int, emb_dim: int,
                dim_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sparse [B, S*E] slot-major flat -> [B, out_dim]."""
        x = sparse.reshape(sparse.shape[0], in_slots, emb_dim)
        if profiling.counting():
            x = profiling.reported_flops(x, fm3d_matmul_flops(sparse.shape[0], in_slots, emb_dim))
        ix = torch.square(x.sum(dim=1)) - torch.square(x).sum(dim=1)
        if self.proj is not None:
            ix = self.proj(ix)
            if self.ln is not None:
                ix = self.ln(ix)
        return apply_mask(ix, dim_mask)
