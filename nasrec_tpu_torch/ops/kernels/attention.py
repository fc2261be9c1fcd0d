"""Tiny-head self-attention core: the CUDA kernel (`csrc/attention.cu`) and
its plain PyTorch version.

Replaces nasrec_tpu/ops/kernels/attention_pallas.py ::
tiny_head_attention_bmajor.  The TPU kernel takes batch-on-lanes stacked
qkv[3E, S, B]; this one takes batch-major qkv [B, S, 48] (q, k and v stacked
on the last axis, as `F.linear(x, w_in, b_in)` leaves them) and returns
o [B, S, 16].  Eight heads of width 2; the backward is a kernel too and
recomputes the softmax from qkv, since nothing is saved.
"""

from __future__ import annotations

from collections import Counter

import torch

from nasrec_tpu_torch.ops.kernels import build

EMB = 16
HEADS = 8
# Positions (batch row, slot) one block handles at a time, one per thread; a
# batch row is never split, so the kernels take S <= 128.
TILE_THREADS = 128

# Launches of each kernel, keyed "fwd_s<S>" / "bwd_s<S>"; added to where a
# kernel is launched and nowhere else.
LAUNCHES: Counter = Counter()


def tile_geometry(s: int) -> tuple:
    """(batch rows per tile, threads per block) for S slots."""
    if not 1 <= s <= TILE_THREADS:
        raise ValueError(f"the attention kernels take 1 <= S <= {TILE_THREADS} slots, got {s}")
    rpt = TILE_THREADS // s
    return rpt, -(-rpt * s // 32) * 32


def tiny_head_attention_plain(qkv: torch.Tensor, num_heads: int = HEADS) -> torch.Tensor:
    """Plain version: qkv [B, S, 3E] -> softmax(q k^T / sqrt(hd)) v, [B, S, E]."""
    b, s, e3 = qkv.shape
    e = e3 // 3
    hd = e // num_heads
    q, k, v = (t.reshape(b, s, num_heads, hd) for t in qkv.split(e, dim=-1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(b, s, e)


def check_f32_cuda(x: torch.Tensor, what: str, shape: tuple) -> None:
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(x.shape)}")


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> tuple:
    if qkv.dim() != 3 or qkv.shape[2] != 3 * EMB or num_heads != HEADS or qkv.shape[0] < 1:
        raise ValueError(f"tiny_head_attention: the kernel takes qkv [B >= 1, S, {3 * EMB}] "
                         f"with {HEADS} heads, got {tuple(qkv.shape)} with {num_heads}")
    check_f32_cuda(qkv, "tiny_head_attention (qkv)", qkv.shape)
    return qkv.shape[0], qkv.shape[1]


def tiny_head_attention_fwd_kernel(qkv: torch.Tensor, num_heads: int = HEADS) -> torch.Tensor:
    """Launch the forward kernel: qkv [B, S, 48] -> o [B, S, 16]."""
    b, s = _check_qkv(qkv, num_heads)
    rpt, threads = tile_geometry(s)
    o = torch.empty((b, s, EMB), device=qkv.device, dtype=qkv.dtype)
    lib = build.load_library("attention")
    build.check(lib.nasrec_attn_fwd(qkv.data_ptr(), o.data_ptr(), b, s, rpt, threads,
                                    build.current_stream()), "attention fwd")
    LAUNCHES[f"fwd_s{s}"] += 1
    return o


def tiny_head_attention_bwd_kernel(qkv: torch.Tensor, do: torch.Tensor,
                                   num_heads: int = HEADS) -> torch.Tensor:
    """Launch the backward kernel: (qkv [B, S, 48], do [B, S, 16]) -> dqkv."""
    b, s = _check_qkv(qkv, num_heads)
    check_f32_cuda(do, "tiny_head_attention backward (do)", (b, s, EMB))
    rpt, threads = tile_geometry(s)
    dqkv = torch.empty_like(qkv)
    lib = build.load_library("attention")
    build.check(lib.nasrec_attn_bwd(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), b, s,
                                    rpt, threads, build.current_stream()), "attention bwd")
    LAUNCHES[f"bwd_s{s}"] += 1
    return dqkv


class _TinyHeadAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv):
        ctx.save_for_backward(qkv)
        return tiny_head_attention_fwd_kernel(qkv)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return tiny_head_attention_bwd_kernel(qkv, do.contiguous())


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
