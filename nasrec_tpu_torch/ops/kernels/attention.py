"""Tiny-head self-attention core: the CUDA kernel (`csrc/attention.cu`) and
its plain PyTorch version.

Replaces nasrec_tpu/ops/kernels/attention_pallas.py ::
tiny_head_attention_bmajor.  The TPU kernel takes batch-on-lanes stacked
qkv[3E, S, B]; this one takes batch-major qkv [B, S, 48] (q, k and v stacked
on the last axis, as `F.linear(x, w_in, b_in)` leaves them) and returns
o [B, S, 16].  Eight heads of width 2; the backward is a kernel too and
recomputes the softmax from qkv, since nothing is saved.  qkv, o, do and
dqkv are float32 or bfloat16 (one dtype for all four); a bf16 kernel computes
in f32 and rounds each output once, and its plain version does the same:
the f32 plain version on the widened inputs, rounded once.

Under `torch.func.vmap` over K candidates the kernels launch once at batch
K B (`ops/kernels/candidates.py`), forward and backward.

The kernels fold the softmax into base-2 exponentials of pre-scaled scores and
one statistic a head (`csrc/tiny_attn.cuh`); `tiny_head_attention_folded` and
`tiny_head_attention_folded_bwd` are that arithmetic in plain PyTorch, so that
it can be held against the plain version without a card.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.ops.kernels import build, candidates

EMB = 16
HEADS = 8
# Positions (batch row, slot) one block handles at a time, one per thread; a
# batch row is never split, so the kernels take S <= 128.
TILE_THREADS = 128

# Launches of each kernel, keyed "fwd_s<S>" / "bwd_s<S>" (with "_bf16" added
# for a bf16 launch); added to where a kernel is launched and nowhere else.
LAUNCHES: Counter = Counter()

# The dtypes of the activations a kernel takes; everything else is float32.
ACTIVATION_DTYPES = (torch.float32, torch.bfloat16)


def dtype_suffix(dtype: torch.dtype) -> str:
    """The suffix of a bf16 kernel's C entry point and launch key: "_bf16"
    for bfloat16, "" for float32."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def tile_geometry(s: int) -> tuple:
    """(batch rows per tile, threads per block) for S slots."""
    if not 1 <= s <= TILE_THREADS:
        raise ValueError(f"the attention kernels take 1 <= S <= {TILE_THREADS} slots, got {s}")
    rpt = TILE_THREADS // s
    return rpt, -(-rpt * s // 32) * 32


def matmul_flops(b: int, s: int) -> int:
    """Matmul FLOPs of one forward on qkv [b, s, 48], as the dispatcher counts
    the plain version's two products (q k^T and p v, 2·M·N·K each, the eight
    heads of width 2 together 16 wide).  A backward counts twice this: each
    product's two input gradients, as autograd of the plain version runs them."""
    return 2 * 2 * b * s * s * EMB


def tiny_head_attention_plain(qkv: torch.Tensor, num_heads: int = HEADS) -> torch.Tensor:
    """Plain version: qkv [B, S, 3E] -> softmax(q k^T / sqrt(hd)) v, [B, S, E].
    A bf16 qkv is computed in f32 and the output rounded once, as the kernel
    does."""
    if qkv.dtype != torch.float32:
        return tiny_head_attention_plain(qkv.float(), num_heads).to(qkv.dtype)
    b, s, e3 = qkv.shape
    e = e3 // 3
    hd = e // num_heads
    q, k, v = (t.reshape(b, s, num_heads, hd) for t in qkv.split(e, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(b, s, e)


def _heads(qkv: torch.Tensor, num_heads: int) -> tuple:
    b, s, e3 = qkv.shape
    hd = e3 // 3 // num_heads
    return tuple(t.reshape(b, s, num_heads, hd) for t in qkv.split(e3 // 3, dim=-1))


def softmax_lse2(qkv: torch.Tensor, num_heads: int = HEADS) -> torch.Tensor:
    """The statistic the kernels save, in its plain form: the log-sum-exp of a
    query's scores, in base 2 (times log2 e).  qkv [B, S, 3E] -> [B, S, H]."""
    q, k, _ = _heads(qkv, num_heads)
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k) / (q.shape[-1] ** 0.5)
    return torch.logsumexp(scores, dim=-1) * math.log2(math.e)


def tiny_head_attention_folded(qkv: torch.Tensor, num_heads: int = HEADS) -> tuple:
    """The forward as the kernels compute it: the query scaled once by
    log2(e) / sqrt(hd), p = 2^(t - max), and lse2 = max + log2(sum p) as the one
    saved statistic.  qkv [B, S, 3E] -> (o [B, S, E], lse2 [B, S, H])."""
    b, s, e3 = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    q2 = q * (math.log2(math.e) / q.shape[-1] ** 0.5)
    t = torch.einsum("bqhd,bkhd->bqhk", q2, k)
    m = t.amax(dim=-1, keepdim=True)
    p = torch.exp2(t - m)
    total = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqhk,bkhd->bqhd", p, v) / total
    return o.reshape(b, s, e3 // 3), (m + torch.log2(total)).squeeze(-1)


def tiny_head_attention_folded_bwd(qkv: torch.Tensor, do: torch.Tensor, o: torch.Tensor,
                                   lse2: torch.Tensor, num_heads: int = HEADS) -> torch.Tensor:
    """The backward as the kernels compute it, from the saved o and lse2:
    p = 2^(t - lse2) is the normalised probability, ds = p (do . v - do . o),
    dq = sum_k ds k / sqrt(hd), dk = ln 2 sum_q ds q2 (q2 carries the log2 e),
    dv = sum_q p do.  -> dqkv [B, S, 3E]."""
    b, s, e3 = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    hd = q.shape[-1]
    dov, ov = do.reshape(b, s, num_heads, hd), o.reshape(b, s, num_heads, hd)
    q2 = q * (math.log2(math.e) / hd ** 0.5)
    p = torch.exp2(torch.einsum("bqhd,bkhd->bqhk", q2, k) - lse2[..., None])
    dsum = (dov * ov).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bqhd,bkhd->bqhk", dov, v) - dsum)
    dq = torch.einsum("bqhk,bkhd->bqhd", ds, k) * (1.0 / hd ** 0.5)
    dk = torch.einsum("bqhk,bqhd->bkhd", ds, q2) * math.log(2.0)
    dv = torch.einsum("bqhk,bqhd->bkhd", p, dov)
    return torch.cat([t.reshape(b, s, e3 // 3) for t in (dq, dk, dv)], dim=-1)


def check_activation_dtype(x: torch.Tensor, what: str) -> torch.dtype:
    """x's dtype, where a kernel takes it for its activations (float32 or
    bfloat16); raises on any other."""
    if x.dtype not in ACTIVATION_DTYPES:
        raise ValueError(f"{what}: the kernels take float32 or bfloat16 activations, "
                         f"got {x.dtype}")
    return x.dtype


def check_cuda(x: torch.Tensor, what: str, shape: tuple, dtype: torch.dtype) -> None:
    """x is a contiguous CUDA tensor of `dtype` and `shape` whose first
    element lies on a 16-byte boundary; raises otherwise.  An activation
    operand passes its first activation's dtype, so mixed operands raise."""
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous {dtype} CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels load 16 bytes at a time and need the "
                         "tensor's first element aligned to 16 bytes")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(x.shape)}")


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> tuple:
    if qkv.dim() != 3 or qkv.shape[2] != 3 * EMB or num_heads != HEADS or qkv.shape[0] < 1:
        raise ValueError(f"tiny_head_attention: the kernel takes qkv [B >= 1, S, {3 * EMB}] "
                         f"with {HEADS} heads, got {tuple(qkv.shape)} with {num_heads}")
    dtype = check_activation_dtype(qkv, "tiny_head_attention (qkv)")
    check_cuda(qkv, "tiny_head_attention (qkv)", qkv.shape, dtype)
    return qkv.shape[0], qkv.shape[1]


def tiny_head_attention_fwd_kernel(qkv: torch.Tensor, num_heads: int = HEADS) -> torch.Tensor:
    """Launch the forward kernel: qkv [B, S, 48] -> o [B, S, 16]."""
    b, s = _check_qkv(qkv, num_heads)
    rpt, threads = tile_geometry(s)
    o = torch.empty((b, s, EMB), device=qkv.device, dtype=qkv.dtype)
    lib = build.load_library("attention")
    sfx = dtype_suffix(qkv.dtype)
    build.check(getattr(lib, f"nasrec_attn_fwd{sfx}")(
        qkv.data_ptr(), o.data_ptr(), b, s, rpt, threads, build.current_stream()),
        "attention fwd")
    LAUNCHES[f"fwd_s{s}{sfx}"] += 1
    profiling.report_matmul_flops(matmul_flops(b, s))
    return o


def tiny_head_attention_bwd_kernel(qkv: torch.Tensor, do: torch.Tensor,
                                   num_heads: int = HEADS) -> torch.Tensor:
    """Launch the backward kernel: (qkv [B, S, 48], do [B, S, 16]) -> dqkv."""
    b, s = _check_qkv(qkv, num_heads)
    check_cuda(do, "tiny_head_attention backward (do)", (b, s, EMB), qkv.dtype)
    rpt, threads = tile_geometry(s)
    dqkv = torch.empty_like(qkv)
    lib = build.load_library("attention")
    sfx = dtype_suffix(qkv.dtype)
    build.check(getattr(lib, f"nasrec_attn_bwd{sfx}")(
        qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), b, s, rpt, threads,
        build.current_stream()), "attention bwd")
    LAUNCHES[f"bwd_s{s}{sfx}"] += 1
    profiling.report_matmul_flops(2 * matmul_flops(b, s))
    return dqkv


class _TinyHeadAttention(torch.autograd.Function):
    @staticmethod
    def forward(qkv):
        return tiny_head_attention_fwd_kernel(qkv)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return tiny_head_attention_bwd_kernel(qkv, do.contiguous())

    @staticmethod
    def vmap(info, in_dims, qkv):
        # K candidates: one launch at batch K B, forward and backward.
        k = info.batch_size
        o = _TinyHeadAttention.apply(candidates.fold(qkv, in_dims[0], k).contiguous())
        return candidates.unfold(o, k), 0


def tiny_head_attention(qkv: torch.Tensor, num_heads: int = HEADS,
                        impl: str = "auto") -> torch.Tensor:
    """softmax(q k^T / sqrt(2)) v per head; qkv [B, S, 48] -> [B, S, 16].

    A CUDA tensor goes through the kernel (forward and backward); a CPU tensor
    through the plain version.  impl='plain' names the plain version."""
    if build.resolve_impl(impl, qkv) == "plain":
        return tiny_head_attention_plain(qkv, num_heads)
    if num_heads != HEADS:
        raise ValueError(f"tiny_head_attention: the kernel has {HEADS} heads, got {num_heads}")
    return _TinyHeadAttention.apply(qkv.contiguous())
