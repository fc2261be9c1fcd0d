"""Elastic linear operators, dense 2-D and sparse 3-D (port of
`nasrec_tpu/ops/linear.py`).

  - ElasticLinear   (ref: nasrec/supernet/modules.py:134-181):
        out = act(LN(x @ W + b)); bias only when layernorm is off.
  - ElasticLinear3D (ref: nasrec/supernet/modules.py:184-235): the same linear
    over the slot axis, LayerNorm over the projected slot axis, activation.

In the supernet a width mask (`dim_mask` over the features, `slot_mask` over
the slots) multiplies the output after the activation; the fixed path passes
none.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from nasrec_tpu_torch.ops.common import (
    ACTIVATIONS,
    LayerNorm,
    Linear,
    apply_mask,
    emajor_to_flat,
    flat_to_emajor,
)


class ElasticLinear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_layernorm: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.linear = Linear(in_dim, out_dim, not use_layernorm, generator, device)
        self.ln = LayerNorm(out_dim, device=device) if use_layernorm else None

    def forward(self, x: torch.Tensor, activation: str = "relu",
                dim_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.linear(x)
        if self.ln is not None:
            out = self.ln(out)
        return apply_mask(ACTIVATIONS[activation](out), dim_mask)


class ElasticLinear3D(nn.Module):
    """Flat-layout ElasticLinear3D: [B, S_in*E] -> [B, out_slots*E]."""

    def __init__(self, in_slots: int, out_slots: int, use_layernorm: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.in_slots = in_slots
        self.linear = Linear(in_slots, out_slots, not use_layernorm, generator, device)
        self.ln = LayerNorm(out_slots, device=device) if use_layernorm else None

    def forward(self, x: torch.Tensor, emb_dim: int, activation: str = "relu",
                slot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xt = flat_to_emajor(x, self.in_slots, emb_dim)   # [B, E, S_in]
        out = self.linear(xt)                            # [B, E, out_slots]
        if self.ln is not None:
            out = self.ln(out)                           # LN over slots (ref :225-226)
        # The slot axis is the last one in this layout.
        return emajor_to_flat(apply_mask(ACTIVATIONS[activation](out), slot_mask))
