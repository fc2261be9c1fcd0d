"""Fused body of the transformer node: the CUDA kernels
(`csrc/transformer_body.cu`) and the plain PyTorch version.

Replaces nasrec_tpu/ops/kernels/transformer_body_pallas.py ::
transformer_body_fused.  The TPU kernel takes batch-on-lanes x[E, S, B] whose
training batch must divide into lane tiles; this one takes x [B, S, 16] at any
B >= 1, either contiguous (the flat slot-major layout the blocks exchange,
viewed without a copy) or as the transposed view of a contiguous [B, 16, S],
which is how the slot projection before the body leaves it: the kernels read
that layout in place and return dx in it, so no transposed copy is made on
either side.  `out` is always contiguous [B, S, 16].  The body is everything
after the slot projection:

    qkv = W_in x + b_in;  o = 8-head attention(qkv);  a = W_out o + b_out
    x4  = LN(a + x);  f = fc2(relu(fc1(x4)));  out = LN(x4 + f)

The twelve parameters are passed in `PARAM_NAMES` order in PyTorch's layout
(a linear weight is [out, in]).  Under `torch.no_grad()`, or when nothing
needs a gradient, the forward writes `out` only; otherwise it also saves the
attention output o and one softmax statistic a head, lse2 [B, S, 8] (the
base-2 log-sum-exp of the scores times log2(e); `attention.softmax_lse2`),
from which the backward kernel returns dx and all twelve parameter gradients,
bit-identically from run to run (per-block partials summed in block order, no
atomics).  The kernels' matrix products (the feature linears and the parameter
gradients) run on the tensor cores as TF32 products of operands split three
ways; `matmul_tf32x3` is that product's plain version.

K candidates launch as one (the Function's rule under `torch.func.vmap`,
`ops/kernels/candidates.py`): x [K B, S, 16] and each parameter with a
leading candidate axis [K, ...], rows k B ... (k+1) B - 1 computed with
candidate k's parameters; the backward returns each candidate's parameter
gradients.  The search's whole-net fine-tune runs it, the counterpart of the
JAX package's `jax.vmap` of the Pallas kernel; `transformer_body_k_plain` is
its plain version.

x, out, dout and dx are float32 or bfloat16 (one dtype for all four), as in
the JAX kernel; o, the statistics, the parameters and their gradients are
float32 either way.  A bf16 kernel computes in f32 and rounds each output
once; its plain version is the f32 plain version on the widened input, its
output rounded once (autograd then returns dx in bf16 and the parameter
gradients in f32, as the kernels do).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import torch
import torch.nn.functional as F

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.ops.common import LN_EPS
from nasrec_tpu_torch.ops.kernels import build, candidates
from nasrec_tpu_torch.ops.kernels.attention import (
    EMB,
    HEADS,
    check_activation_dtype,
    check_cuda,
    dtype_suffix,
    tile_geometry,
    tiny_head_attention_plain,
)
from nasrec_tpu_torch.ops.kernels.attention import matmul_flops as attention_matmul_flops

PARAM_NAMES = ("w_in", "b_in", "w_out", "b_out", "attn_ln_w", "attn_ln_b",
               "fc1_w", "fc1_b", "fc2_w", "fc2_b", "fc_ln_w", "fc_ln_b")
PARAM_SHAPES = ((3 * EMB, EMB), (3 * EMB,), (EMB, EMB), (EMB,), (EMB,), (EMB,),
                (EMB, EMB), (EMB,), (EMB, EMB), (EMB,), (EMB,), (EMB,))
PARAM_SIZES = [math.prod(s) for s in PARAM_SHAPES]
NUM_PARAM_FLOATS = sum(PARAM_SIZES)          # 1696
# The backward's grid: two blocks on each of the 132 multiprocessors (what its
# registers admit), each block walking its share of the tiles.
BWD_BLOCKS_PER_SM = 2
NUM_SMS = 132

# Launches, keyed "fwd_s<S>" (eval forward), "fwd_train_s<S>" (forward that
# saves o and the statistics) and "bwd_s<S>", with "_k<K>" added for a
# K-candidate launch and "_bf16" for a bf16 one; added to where a kernel is
# launched and nowhere else.
LAUNCHES: Counter = Counter()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its mantissa rounded to TF32's 10 bits (to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` rounds)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' tensor-core product: each f32 operand is a
    high TF32 part (rounded) and a low one (the exact rest, cut to 10 bits), and
    a @ b is the sum of three TF32 products with f32 sums (lo.hi, hi.lo, hi.hi;
    lo.lo, 2^-22 of the product, is left out)."""
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    a_lo = ((a - a_hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    b_lo = ((b - b_hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_flops(b: int, s: int) -> int:
    """Matmul FLOPs of one forward on x [b, s, 16], as the dispatcher counts
    the plain version's products (2·M·N·K each): the four feature linears
    (qkv 16 -> 48, out-projection, fc1, fc2) and the attention core's two.  A
    backward counts twice this, as autograd of the plain version runs it
    where x needs a gradient (each product's two input gradients)."""
    return 2 * b * s * EMB * (3 * EMB + 3 * EMB) + attention_matmul_flops(b, s)


def transformer_body_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                           num_heads: int = HEADS) -> torch.Tensor:
    """Plain version, op by op on x [B, S, E]; a bf16 x is computed in f32
    and the output rounded once, as the kernels do."""
    if x.dtype != torch.float32:
        return transformer_body_plain(x.float(), params, num_heads).to(x.dtype)
    w_in, b_in, w_out, b_out, g1, h1, fc1w, fc1b, fc2w, fc2b, g2, h2 = params
    e = x.shape[-1]
    o = tiny_head_attention_plain(F.linear(x, w_in, b_in), num_heads)
    x4 = F.layer_norm(F.linear(o, w_out, b_out) + x, (e,), g1, h1, LN_EPS)
    f = F.linear(F.relu(F.linear(x4, fc1w, fc1b)), fc2w, fc2b)
    return F.layer_norm(x4 + f, (e,), g2, h2, LN_EPS)


def transformer_body_k_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                             num_heads: int = HEADS) -> torch.Tensor:
    """Plain version of the K-candidate form: x [K B, S, E], each parameter
    [K, ...]; candidate k's rows through the plain version with its
    parameters (torch.func.vmap of it over the candidates)."""
    k = params[0].shape[0]
    xk = x.reshape(k, x.shape[0] // k, *x.shape[1:])
    out = torch.func.vmap(transformer_body_plain, in_dims=(0, 0, None))(xk, list(params),
                                                                      num_heads)
    return out.reshape(x.shape)


def candidates_of(params: Sequence[torch.Tensor]) -> int:
    """0 for one candidate's parameters (each of its shape in PARAM_SHAPES),
    K for K candidates' (each [K, *shape]); raises on anything else."""
    if len(params) != len(PARAM_SHAPES):
        raise ValueError(f"transformer_body: expected {len(PARAM_SHAPES)} parameters "
                         f"({', '.join(PARAM_NAMES)}), got {len(params)}")
    k = 0 if tuple(params[0].shape) == PARAM_SHAPES[0] else params[0].shape[0]
    for name, p, shape in zip(PARAM_NAMES, params, PARAM_SHAPES):
        if tuple(p.shape) != ((k,) if k else ()) + shape or p.dtype != torch.float32:
            raise ValueError(f"transformer_body: {name} must be float32 {shape} (or [K, *shape] "
                             f"for K candidates), got {p.dtype} {tuple(p.shape)}")
    return k


def flatten_params(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The twelve parameters as the kernels' one flat [1696] array, or
    [K, 1696] for K candidates' parameters."""
    k = candidates_of(params)
    return torch.cat([p.detach().reshape(k or 1, -1) for p in params], dim=1).reshape(
        (k, NUM_PARAM_FLOATS) if k else (NUM_PARAM_FLOATS,))


def _slot_minor(x: torch.Tensor) -> bool:
    """True where x [B, S, 16] is the transposed view of a contiguous [B, 16, S]."""
    return not x.is_contiguous() and x.transpose(1, 2).is_contiguous()


def _check_x(x: torch.Tensor, flat: torch.Tensor) -> tuple:
    """(rows, S, slot_minor, K, key suffix) of a launch on x and flat [1696]
    (K = 1) or [K, 1696]; x's rows divide into K equal runs."""
    if x.dim() != 3 or x.shape[2] != EMB or x.shape[0] < 1:
        raise ValueError(f"transformer_body: x must be [B >= 1, S, {EMB}], got {tuple(x.shape)}")
    k = flat.shape[0] if flat.dim() == 2 else 1
    if x.shape[0] % k:
        raise ValueError(f"transformer_body: {x.shape[0]} rows of x do not divide among "
                         f"{k} candidates")
    slot_minor = _slot_minor(x)
    dtype = check_activation_dtype(x, "transformer_body (x)")
    check_cuda(x.transpose(1, 2) if slot_minor else x, "transformer_body (x)",
               (x.shape[0], EMB, x.shape[1]) if slot_minor else x.shape, dtype)
    check_cuda(flat, "transformer_body (parameters)",
               (k, NUM_PARAM_FLOATS) if flat.dim() == 2 else (NUM_PARAM_FLOATS,), torch.float32)
    key = (f"_k{k}" if flat.dim() == 2 else "") + dtype_suffix(dtype)
    return x.shape[0], x.shape[1], slot_minor, k, key


def transformer_body_fwd_kernel(x: torch.Tensor, flat: torch.Tensor, save: bool):
    """Launch the forward kernel on x [B, S, 16] (contiguous, or the transposed
    view of a contiguous [B, 16, S]) and the flat parameters, [1696] or, for K
    candidates, [K, 1696] with x's rows in K runs of B / K.
    save=False -> (out, None, None); save=True -> (out, o, lse2), the attention
    output [B, S, 16] and the softmax statistic [B, S, 8] for the backward, both
    float32; out is in x's dtype."""
    b, s, slot_minor, k, key = _check_x(x, flat)
    rpt, threads = tile_geometry(s)
    out = torch.empty((b, s, EMB), device=x.device, dtype=x.dtype)
    f32 = dict(device=x.device, dtype=torch.float32)
    o = torch.empty((b, s, EMB), **f32) if save else None
    stats = torch.empty((b, s, HEADS), **f32) if save else None
    lib = build.load_library("transformer_body")
    sfx = dtype_suffix(x.dtype)
    build.check(getattr(lib, f"nasrec_body_fwd{sfx}")(
        x.data_ptr(), flat.data_ptr(), out.data_ptr(),
        o.data_ptr() if save else None, stats.data_ptr() if save else None,
        b // k, k, s, rpt, threads, int(slot_minor), LN_EPS, build.current_stream()),
        "transformer_body fwd")
    LAUNCHES[(f"fwd_train_s{s}" if save else f"fwd_s{s}") + key] += 1
    profiling.report_matmul_flops(matmul_flops(b, s))
    return out, o, stats


def transformer_body_bwd_kernel(x, dout, o, stats, flat):
    """Launch the backward kernel -> (dx, dflat); dx has x's shape [B, S, 16],
    x's layout and x's dtype, dflat is float32 in flat's shape ([K, 1696]: each
    candidate's gradients from its own rows)."""
    b, s, slot_minor, k, key = _check_x(x, flat)
    check_cuda(dout, "transformer_body backward (dout)", (b, s, EMB), x.dtype)
    check_cuda(o, "transformer_body backward (o)", (b, s, EMB), torch.float32)
    check_cuda(stats, "transformer_body backward (statistics)", (b, s, HEADS), torch.float32)
    rpt, threads = tile_geometry(s)
    # A candidate's blocks, as a one-candidate launch on its rows would have.
    nblocks = min(-(-(b // k) // rpt), NUM_SMS * BWD_BLOCKS_PER_SM)
    dx = torch.empty_like(x.transpose(1, 2) if slot_minor else x)
    partial = torch.empty((k, nblocks, NUM_PARAM_FLOATS), device=x.device, dtype=torch.float32)
    dflat = torch.empty_like(flat)
    lib = build.load_library("transformer_body")
    sfx = dtype_suffix(x.dtype)
    build.check(getattr(lib, f"nasrec_body_bwd{sfx}")(
        x.data_ptr(), dout.data_ptr(), o.data_ptr(), stats.data_ptr(), flat.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), dflat.data_ptr(), b // k, k, s, rpt, threads,
        nblocks, int(slot_minor), LN_EPS, build.current_stream()), "transformer_body bwd")
    LAUNCHES[f"bwd_s{s}{key}"] += 1
    profiling.report_matmul_flops(2 * matmul_flops(b, s))
    return (dx.transpose(1, 2) if slot_minor else dx), dflat


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it in place: contiguous or slot-minor (else a copy)."""
    return x if x.is_contiguous() or _slot_minor(x) else x.contiguous()


def _needs_save(x: torch.Tensor, params: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))


class _TransformerBody(torch.autograd.Function):
    """(save, x, *params) -> (out, o, stats, flat); params one candidate's or
    K candidates' (see `transformer_body_fwd_kernel`)."""

    @staticmethod
    def forward(save, x, *params):
        flat = flatten_params(params)
        return (*transformer_body_fwd_kernel(x, flat, save), flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, o, stats, flat = output
        ctx.mark_non_differentiable(*(t for t in (o, stats, flat) if t is not None))
        if inputs[0]:
            ctx.save_for_backward(inputs[1], flat, o, stats)

    @staticmethod
    def backward(ctx, dout, *_):
        x, flat, o, stats = ctx.saved_tensors
        dx, dflat = transformer_body_bwd_kernel(x, dout.contiguous(), o, stats, flat)
        lead = tuple(flat.shape[:-1])
        grads = [g.reshape(lead + shape)
                 for g, shape in zip(dflat.split(PARAM_SIZES, dim=-1), PARAM_SHAPES)]
        return (None, dx, *grads)

    @staticmethod
    def vmap(info, in_dims, save, x, *params):
        # Candidates that share the parameters launch the one-candidate form
        # over all their rows; otherwise the K-candidate form.
        k = info.batch_size
        xs = _kernel_layout(candidates.fold(x, in_dims[1], k))
        if any(d is not None for d in in_dims[2:]):
            params = [candidates.stacked(p, d, k) for p, d in zip(params, in_dims[2:])]
        out, o, stats, flat = _TransformerBody.apply(_needs_save(xs, params), xs, *params)
        return ((candidates.unfold(out, k), candidates.unfold(o, k),
                 candidates.unfold(stats, k), flat), (0, 0 if o is not None else None,
                                                      0 if stats is not None else None,
                                                      0 if flat.dim() == 2 else None))


def transformer_body(x: torch.Tensor, params: Sequence[torch.Tensor],
                     num_heads: int = HEADS, impl: str = "auto") -> torch.Tensor:
    """The transformer node's body on x [B, S, 16] -> [B, S, 16].

    A CUDA tensor goes through the kernels (forward and backward); a CPU tensor
    through the plain version.  impl='plain' names the plain version.  The
    kernels read x in place where it is contiguous or the transposed view of a
    contiguous [B, 16, S]; any other layout is copied first."""
    if build.resolve_impl(impl, x) == "plain":
        return transformer_body_plain(x, params, num_heads)
    if num_heads != HEADS:
        raise ValueError(f"transformer_body: the kernel has {HEADS} heads, got {num_heads}")
    # Under torch.func.vmap the Function's rule folds the candidates and takes
    # the layout and the save decision again from the tensors it launches on.
    x = _kernel_layout(x)
    return _TransformerBody.apply(_needs_save(x, params), x, *params)[0]
