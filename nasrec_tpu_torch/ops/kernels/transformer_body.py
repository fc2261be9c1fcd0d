"""Fused body of the transformer node: the CUDA kernels
(`csrc/transformer_body.cu`) and the plain PyTorch version.

Replaces nasrec_tpu/ops/kernels/transformer_body_pallas.py ::
transformer_body_fused.  The TPU kernel takes batch-on-lanes x[E, S, B] whose
training batch must divide into lane tiles; this one takes batch-major
x [B, S, 16] at any B >= 1, the flat slot-major layout the blocks exchange,
viewed without a copy.  The body is everything after the slot projection:

    qkv = W_in x + b_in;  o = 8-head attention(qkv);  a = W_out o + b_out
    x4  = LN(a + x);  f = fc2(relu(fc1(x4)));  out = LN(x4 + f)

The twelve parameters are passed in `PARAM_NAMES` order in PyTorch's layout
(a linear weight is [out, in]).  Under `torch.no_grad()`, or when nothing
needs a gradient, the forward writes `out` only; otherwise it also saves the
attention output o and the softmax statistics, from which the backward kernel
returns dx and all twelve parameter gradients, bit-identically from run to
run (per-block partials summed in block order, no atomics).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import torch
import torch.nn.functional as F

from nasrec_tpu_torch.ops.common import LN_EPS
from nasrec_tpu_torch.ops.kernels import build
from nasrec_tpu_torch.ops.kernels.attention import (
    EMB,
    HEADS,
    check_f32_cuda,
    tile_geometry,
    tiny_head_attention_plain,
)

PARAM_NAMES = ("w_in", "b_in", "w_out", "b_out", "attn_ln_w", "attn_ln_b",
               "fc1_w", "fc1_b", "fc2_w", "fc2_b", "fc_ln_w", "fc_ln_b")
PARAM_SHAPES = ((3 * EMB, EMB), (3 * EMB,), (EMB, EMB), (EMB,), (EMB,), (EMB,),
                (EMB, EMB), (EMB,), (EMB, EMB), (EMB,), (EMB,), (EMB,))
PARAM_SIZES = [math.prod(s) for s in PARAM_SHAPES]
NUM_PARAM_FLOATS = sum(PARAM_SIZES)          # 1696
# The backward's grid: at most two 128-thread blocks a multiprocessor of the
# 132 (what its registers admit), each walking its share of the tiles.
MAX_BWD_BLOCKS = 132 * 2

# Launches, keyed "fwd_s<S>" (eval forward), "fwd_train_s<S>" (forward that
# saves o and the statistics) and "bwd_s<S>"; added to where a kernel is
# launched and nowhere else.
LAUNCHES: Counter = Counter()


def transformer_body_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                           num_heads: int = HEADS) -> torch.Tensor:
    """Plain version, op by op on x [B, S, E]."""
    w_in, b_in, w_out, b_out, g1, h1, fc1w, fc1b, fc2w, fc2b, g2, h2 = params
    e = x.shape[-1]
    o = tiny_head_attention_plain(F.linear(x, w_in, b_in), num_heads)
    x4 = F.layer_norm(F.linear(o, w_out, b_out) + x, (e,), g1, h1, LN_EPS)
    f = F.linear(F.relu(F.linear(x4, fc1w, fc1b)), fc2w, fc2b)
    return F.layer_norm(x4 + f, (e,), g2, h2, LN_EPS)


def flatten_params(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The twelve parameters as the kernels' one flat [1696] array."""
    if len(params) != len(PARAM_SHAPES):
        raise ValueError(f"transformer_body: expected {len(PARAM_SHAPES)} parameters "
                         f"({', '.join(PARAM_NAMES)}), got {len(params)}")
    for name, p, shape in zip(PARAM_NAMES, params, PARAM_SHAPES):
        if tuple(p.shape) != shape or p.dtype != torch.float32:
            raise ValueError(f"transformer_body: {name} must be float32 {shape}, got "
                             f"{p.dtype} {tuple(p.shape)}")
    return torch.cat([p.detach().reshape(-1) for p in params])


def _check_x(x: torch.Tensor, flat: torch.Tensor) -> tuple:
    if x.dim() != 3 or x.shape[2] != EMB or x.shape[0] < 1:
        raise ValueError(f"transformer_body: x must be [B >= 1, S, {EMB}], got {tuple(x.shape)}")
    check_f32_cuda(x, "transformer_body (x)", x.shape)
    check_f32_cuda(flat, "transformer_body (parameters)", (NUM_PARAM_FLOATS,))
    return x.shape[0], x.shape[1]


def transformer_body_fwd_kernel(x: torch.Tensor, flat: torch.Tensor, save: bool):
    """Launch the forward kernel on x [B, S, 16] and the flat parameters.
    save=False -> (out, None, None); save=True -> (out, o, stats), the
    attention output and the softmax statistics [B, S, 16] for the backward."""
    b, s = _check_x(x, flat)
    rpt, threads = tile_geometry(s)
    out = torch.empty_like(x)
    o = torch.empty_like(x) if save else None
    stats = torch.empty_like(x) if save else None
    lib = build.load_library("transformer_body")
    build.check(lib.nasrec_body_fwd(
        x.data_ptr(), flat.data_ptr(), out.data_ptr(),
        o.data_ptr() if save else None, stats.data_ptr() if save else None,
        b, s, rpt, threads, LN_EPS, build.current_stream()), "transformer_body fwd")
    LAUNCHES[f"fwd_train_s{s}" if save else f"fwd_s{s}"] += 1
    return out, o, stats


def transformer_body_bwd_kernel(x, dout, o, stats, flat):
    """Launch the backward kernel -> (dx [B, S, 16], dflat [1696])."""
    b, s = _check_x(x, flat)
    for t, what in ((dout, "dout"), (o, "o"), (stats, "stats")):
        check_f32_cuda(t, f"transformer_body backward ({what})", x.shape)
    rpt, _ = tile_geometry(s)
    nblocks = min(-(-b // rpt), MAX_BWD_BLOCKS)
    dx = torch.empty_like(x)
    partial = torch.empty((nblocks, NUM_PARAM_FLOATS), device=x.device, dtype=x.dtype)
    dflat = torch.empty_like(flat)
    lib = build.load_library("transformer_body")
    build.check(lib.nasrec_body_bwd(
        x.data_ptr(), dout.data_ptr(), o.data_ptr(), stats.data_ptr(), flat.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), dflat.data_ptr(), b, s, rpt, nblocks,
        LN_EPS, build.current_stream()), "transformer_body bwd")
    LAUNCHES[f"bwd_s{s}"] += 1
    return dx, dflat


class _TransformerBody(torch.autograd.Function):
    @staticmethod
    def forward(ctx, save, x, *params):
        flat = flatten_params(params)
        out, o, stats = transformer_body_fwd_kernel(x, flat, save)
        if save:
            ctx.save_for_backward(x, flat, o, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, flat, o, stats = ctx.saved_tensors
        dx, dflat = transformer_body_bwd_kernel(x, dout.contiguous(), o, stats, flat)
        grads = [g.reshape(shape) for g, shape in zip(dflat.split(PARAM_SIZES), PARAM_SHAPES)]
        return (None, dx, *grads)


def transformer_body(x: torch.Tensor, params: Sequence[torch.Tensor],
                     num_heads: int = HEADS, impl: str = "auto") -> torch.Tensor:
    """The transformer node's body on x [B, S, 16] -> [B, S, 16].

    A CUDA tensor goes through the kernels (forward and backward); a CPU tensor
    through the plain version.  impl='plain' names the plain version."""
    if build.resolve_impl(impl, x) == "plain":
        return transformer_body_plain(x, params, num_heads)
    if num_heads != HEADS:
        raise ValueError(f"transformer_body: the kernel has {HEADS} heads, got {num_heads}")
    save = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))
    return _TransformerBody.apply(save, x.contiguous(), *params)
