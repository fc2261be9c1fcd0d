"""Transformer node over the sparse-slot axis (port of
`nasrec_tpu/ops/attention.py`).

Reference semantics (ref: nasrec/supernet/modules.py:599-688): slot projection
S_in -> out_slots (+ optional LN over slots), 8-head self-attention
(E=16, head_dim 2), residual + LN(0.17), ReLU FFN E->E->E, residual + LN(0.17).

The slot projection is a PyTorch product that leaves its output as
[B, E, S]; the fused body's kernels read that layout in place (as the
transposed view [B, S, E]) and return the input gradient in it, so no
transposed copy is made on either side of the body.  Everything after the
projection, the body, has three forms that compute the same function:

  - fused (the default): one hand-written kernel forward and one backward,
    `ops/kernels/transformer_body.py`, as the JAX package runs
    `transformer_body_fused` under attention_impl="pallas".  On a CPU tensor
    the wrapper takes the kernel's plain version.
  - impl="plain": op by op through this module's layers, with the attention
    core written out (the JAX package's impl="xla" path).
  - unfused (the node's attribute `fused` set to False): op by op, with the
    attention core through `ops/kernels/attention.py` (its kernel on the
    card), the counterpart of `_transformer_bmajor_unfused`.  Tests and the
    on-card smoke run reach it; no model selects it.

Slot masks belong to the supernet and are applied outside the body; the fixed
path has none.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nasrec_tpu_torch.config import LN_INIT, NUM_MHA_HEADS
from nasrec_tpu_torch.ops.common import LayerNorm, Linear, xavier_uniform_
from nasrec_tpu_torch.ops.kernels.attention import tiny_head_attention
from nasrec_tpu_torch.ops.kernels.transformer_body import transformer_body


class MultiheadAttention(nn.Module):
    """Combined qkv projection with torch MultiheadAttention's fan-in/fan-out
    (E, 3E) for init; weights in PyTorch layout ([3E, E] and [E, E])."""

    def __init__(self, emb_dim: int, generator: torch.Generator, device=None):
        super().__init__()
        e = emb_dim
        self.w_in = nn.Parameter(xavier_uniform_(torch.empty(3 * e, e, device=device), e, 3 * e, generator))
        self.b_in = nn.Parameter(torch.zeros(3 * e, device=device))
        self.w_out = nn.Parameter(xavier_uniform_(torch.empty(e, e, device=device), e, e, generator))
        self.b_out = nn.Parameter(torch.zeros(e, device=device))

    def forward(self, x: torch.Tensor, num_heads: int, impl: str = "plain") -> torch.Tensor:
        """impl='plain' writes the attention core out; any other impl sends it
        through `tiny_head_attention` (the kernel for a CUDA tensor)."""
        b, s, e = x.shape
        hd = e // num_heads
        qkv = F.linear(x, self.w_in, self.b_in)
        if impl != "plain":
            return F.linear(tiny_head_attention(qkv, num_heads, impl), self.w_out, self.b_out)
        q, k, v = qkv.split(e, dim=-1)

        def heads(t):
            return t.reshape(b, s, num_heads, hd).transpose(1, 2)   # [B, H, S, hd]

        scores = heads(q) @ heads(k).transpose(-1, -2) / (hd ** 0.5)
        out = torch.softmax(scores, dim=-1) @ heads(v)
        out = out.transpose(1, 2).reshape(b, s, e)
        return F.linear(out, self.w_out, self.b_out)


class Transformer(nn.Module):
    def __init__(self, in_slots: int, out_slots: int, emb_dim: int, use_layernorm: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.in_slots = in_slots
        self.proj = Linear(in_slots, out_slots, not use_layernorm, generator, device)
        self.mha = MultiheadAttention(emb_dim, generator, device)
        self.attn_ln = LayerNorm(emb_dim, init=LN_INIT, device=device)
        self.fc1 = Linear(emb_dim, emb_dim, True, generator, device)
        self.fc2 = Linear(emb_dim, emb_dim, True, generator, device)
        self.fc_ln = LayerNorm(emb_dim, init=LN_INIT, device=device)
        self.proj_ln = LayerNorm(out_slots, device=device) if use_layernorm else None
        self.fused = True   # False: the unfused form (see the module docstring)

    def body_params(self) -> tuple:
        """The body's twelve parameters in the fused kernel's order."""
        return (self.mha.w_in, self.mha.b_in, self.mha.w_out, self.mha.b_out,
                self.attn_ln.weight, self.attn_ln.bias,
                self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias,
                self.fc_ln.weight, self.fc_ln.bias)

    def forward(self, sparse: torch.Tensor, emb_dim: int,
                num_heads: int = NUM_MHA_HEADS, impl: str = "auto") -> torch.Tensor:
        """[B, S_in*E] slot-major flat -> [B, out_slots*E]."""
        b = sparse.shape[0]
        xt = sparse.reshape(b, self.in_slots, emb_dim).transpose(1, 2)  # [B, E, S_in]
        xt = self.proj(xt)
        if self.proj_ln is not None:
            xt = self.proj_ln(xt)
        x = xt.transpose(1, 2)                      # [B, S, E], a view: no copy
        if self.fused and impl != "plain":
            return transformer_body(x, self.body_params(), num_heads, impl).reshape(b, -1)
        x = self.attn_ln(self.mha(x, num_heads, impl) + x)   # residual + LN (ref :666-668)
        h = self.fc2(F.relu(self.fc1(x)))                    # hard-coded relu (ref :671)
        x = self.fc_ln(x + h)                                # residual + LN (ref :673-675)
        return x.reshape(b, -1)
