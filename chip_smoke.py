#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (nasrec_tpu_torch).

    python3 chip_smoke.py            # one CUDA card; exits non-zero without one

Phases, each printing JSON lines; any failure exits non-zero:
  1. device   nvidia-smi name and power limit, torch/CUDA versions, and the
              build of every kernel from csrc/ (one nvcc per source, in
              parallel), with ptxas's registers and shared memory.
  2. kernels  each hand-written kernel against its plain PyTorch version on
              the same CUDA inputs at the main paths' shapes, batch 32768:
              the dot-product at n = 46, 17 (autoctr) and 40, 9 (xlarge); the
              transformer body at S = 64 and 48, and at S = 16, which no live
              block of these archs runs (eval forward, training forward with
              o and the softmax statistic, backward with dx and the twelve
              parameter gradients, equal bits from two backward runs, and equal
              bits from x as the slot projection leaves it, [B, 16, S]
              transposed, and from a contiguous x);
              the attention core at the same S; the transformer
              node's fused form against its unfused form; the full-vocab
              table update with uniform and zipf(1.05) indices.  With errors
              and CUDA-event times of kernel, plain version and the one
              PyTorch call that computes the same function.
  3. main     sparse-embedding train steps at full Criteo vocab (33,762,601
              rows) and batch 32768 through the kernels, counted, then the
              same steps from the same weights through the plain versions:
              10 steps and one eval forward of criteo-kaggle/xlarge (whose
              blocks 0 and 6 run transformer nodes), 2 more steps of it
              with the nodes in their unfused form (the attention kernel),
              then 4 steps of criteo-kaggle/autoctr.  A torch.profiler window
              over 3 more kernel-path steps prints where the device time
              goes (one "profile" line per arch).
  4. cli      nasrec_tpu_torch.cli.main_train on synthetic data, once per
              arch; 40 steps must lower the test loss, lift the AUROC above
              0.6 and launch every kernel of the path (counted as in phase 3).

Then one {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32768
STEPS = {"xlarge": 10, "autoctr": 4}
UNFUSED_STEPS = 2
CLI_STEPS = 40
DEVICE = "cuda"
VOCAB_CAP = None         # full Criteo vocab
F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores (data sheet)
# Exponentials a second: 16 a cycle on each of 132 multiprocessors at the
# 1.98 GHz boost clock that the f32 rate above is stated at.
EXP_RATE = 132 * 16 * 1.98e9
# Tolerances (f32).  Kernel vs plain: the kernels sum in another order than
# cuBLAS, so errors are held to 1e-5 of the output's largest magnitude; the
# table update rounds step by step like the plain version and must match
# exactly.  The transformer body's and the attention core's gradients sum over
# the slots, and the body's parameter gradients over all 2 M positions of a
# batch, so they are held to 1e-4 of the gradient's largest magnitude (or of
# 1, where that is smaller).  Train steps: losses within 1e-4, logits within
# 1e-3 and parameters within 1e-4 (absolute).
KERNEL_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
RELU_MARGIN = 1e-5   # |ReLU input| below this: the side taken is a matter of rounding
LOSS_TOL, LOGIT_TOL, PARAM_TOL = 1e-4, 1e-3, 1e-4
# The transformer nodes the xlarge step runs: blocks 0 (S = 64) and 6 (S = 48).
# Block 5 holds one more, at S = 16, but nothing reads the outputs of blocks
# 3 to 5, so the model skips them (models/fixed.py :: live_blocks); that shape
# is held against the plain version and timed here all the same, on a line of
# its own outside the "kernels" line.
BODY_SLOTS = (64, 48)
OFF_PATH_SLOTS = (16,)
# Every kernel launch of one train step.  autoctr: the dot-product of blocks 1
# (n = 46) and 4 (n = 17), forward and backward, and the table update.
# xlarge: the dot-product of blocks 2 (n = 40) and 1 (n = 9), the transformer
# body's training forward and backward at each S, and the table update.
TRAIN_STEP_KERNELS = {
    "autoctr": {"dot_scores_tril_fwd_n46", "dot_scores_tril_fwd_n17",
                "dot_scores_tril_bwd_n46", "dot_scores_tril_bwd_n17", "table_update"},
    "xlarge": {"dot_scores_tril_fwd_n40", "dot_scores_tril_fwd_n9",
               "dot_scores_tril_bwd_n40", "dot_scores_tril_bwd_n9", "table_update"}
              | {f"transformer_body_{k}_s{s}" for k in ("fwd_train", "bwd") for s in BODY_SLOTS},
}
# An eval forward (under no_grad) launches the forward kernels only.
EVAL_KERNELS = {
    "autoctr": {"dot_scores_tril_fwd_n46", "dot_scores_tril_fwd_n17"},
    "xlarge": {"dot_scores_tril_fwd_n40", "dot_scores_tril_fwd_n9"}
              | {f"transformer_body_fwd_s{s}" for s in BODY_SLOTS},
}
# With the transformer nodes unfused, the attention core's kernel takes the
# body kernels' place.
UNFUSED_STEP_KERNELS = (
    {k for k in TRAIN_STEP_KERNELS["xlarge"] if not k.startswith("transformer_body")}
    | {f"tiny_head_attention_{k}_s{s}" for k in ("fwd", "bwd") for s in BODY_SLOTS})


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    # H100 data sheet: SXM 3.35 TB/s, PCIe 2.0 TB/s.
    return 2.0e12 if "PCIe" in name else 3.35e12


def cuda_ms(fn, groups: int = 5, per_group: int = 5, warmup: int = 3) -> float:
    """Median over `groups` of the mean CUDA-event time of `per_group`
    back-to-back calls, in ms."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return float(np.median(times))


def max_err(a, b) -> tuple:
    d = (a.float() - b.float()).abs().max().item()
    scale = b.float().abs().max().item()
    return d, d / max(scale, 1e-30), scale


def kernel_modules():
    """Name prefix of a kernel's rows and launch counts -> its wrapper module."""
    from nasrec_tpu_torch.ops.kernels import attention, dotprod, table_update, transformer_body

    return {"dot_scores_tril_": dotprod, "transformer_body_": transformer_body,
            "tiny_head_attention_": attention, "": table_update}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.LAUNCHES.clear()


def read_launches() -> dict:
    return {prefix + k: v for prefix, mod in kernel_modules().items()
            for k, v in mod.LAUNCHES.items()}


def kernel_row(name, source, replaces, err, kern, plain, lib, nbytes, flops, hbm,
               heavy=False, exps=0) -> dict:
    """One entry of the "kernels" line.  bound_ms is the larger of `nbytes`
    over the card's memory rate and the operations' time: `flops` over the
    card's f32 rate or, where that is longer, `exps` exponentials over the rate
    of the unit that computes them, which runs beside the f32 pipes.  `heavy`
    times a slow plain version or library call with fewer repeats."""
    t_bytes, t_ops = nbytes / hbm, max(flops / F32_FLOPS, exps / EXP_RATE)
    reps = dict(groups=3, per_group=3, warmup=1) if heavy else {}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, **reps),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib is None else cuda_ms(lib, **reps)}


def draw_indices(rng, batch, vocab, kind):
    """[batch, S] int32; slot s uniform (or zipf(1.05), clipped) over its table
    (the synthetic index draw of the JAX package's bench.py)."""
    import numpy as np

    cols = []
    for v in vocab:
        if kind == "uniform":
            cols.append(rng.randint(0, v, size=batch))
        else:
            cols.append(np.minimum(rng.zipf(1.05, size=batch) - 1, v - 1))
    return np.stack(cols, axis=1).astype(np.int32)


def phase_device(kernel_build):
    import torch

    smi = nvidia_smi()
    t0 = time.perf_counter()
    report = kernel_build.build_all()
    ptxas = {name: [l.strip() for l in r["log"].splitlines()
                    if "registers" in l or "Compiling entry" in l or "spill" in l]
             for name, r in report.items()}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "nvcc_s": {k: r["seconds"] for k, r in report.items()}, "ptxas": ptxas})
    return smi


BODY_SOURCE = "nasrec_tpu_torch/csrc/transformer_body.cu"
BODY_REPLACES = "nasrec_tpu/ops/kernels/transformer_body_pallas.py:414"
ATTN_SOURCE = "nasrec_tpu_torch/csrc/attention.cu"
ATTN_REPLACES = "nasrec_tpu/ops/kernels/attention_pallas.py:166"


def attention_flops(slots: int) -> tuple:
    """(forward, backward) operations of the attention core for one position:
    8 heads x S keys.  Forward: score 3, subtract the max 1, exp 1, row sum 1,
    p v 4.  Backward from saved statistics, each (query, key) pair once:
    score 3, subtract 1, exp 1, times 1/sum 1, dp 3, ds 2, dq 4, dk 4, dv 4.
    An exp counts as one operation here, and also in the bound's own term for
    exponentials: 8 * S of them a position each way (`kernel_row`)."""
    return 8 * slots * 10, 8 * slots * 23


def body_flops(slots: int) -> tuple:
    """(forward, backward) operations of the transformer body for one position.
    Forward: the four feature linears 2*16*(48+16+16+16), the attention core,
    two LayerNorms and residuals (about 230).  Backward: the linears again,
    their transposes and their weight gradients (3x), the attention backward,
    and both LayerNorms forward and backward (about 500)."""
    lin = 2 * 16 * (48 + 16 + 16 + 16)
    fwd, bwd = attention_flops(slots)
    return lin + fwd + 230, 3 * lin + bwd + 500


def within(got, want, rel_tol) -> tuple:
    """(max abs error, ok): the error against rel_tol * max(1, largest |want|)."""
    err, _, scale = max_err(got, want)
    return err, err <= rel_tol * max(scale, 1.0)


def relu_edge_rows(x, params):
    """The one discontinuity of the body: where an input of the FFN's ReLU lies
    within rounding of zero, a kernel and the plain version may take different
    sides, and their gradients then differ by a whole term.  Returns the mask
    of batch rows of x [B, S, 16] that hold such an input (a few in 32768);
    the checks give them a zero output gradient, so they count in no backward."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.common import LN_EPS
    from nasrec_tpu_torch.ops.kernels.attention import tiny_head_attention_plain

    with torch.no_grad():
        o = tiny_head_attention_plain(F.linear(x, params[0], params[1]))
        x4 = F.layer_norm(F.linear(o, params[2], params[3]) + x, (16,), params[4],
                          params[5], LN_EPS)
        return (F.linear(x4, params[6], params[7]).abs() < RELU_MARGIN).flatten(1).any(1)


def check_transformer_body(slots, hbm, gen, rows_out) -> None:
    """The body kernels at [BATCH, slots, 16] against the plain version: the
    eval forward, the training forward (out, o, statistic), the backward (dx
    and each of the twelve parameter gradients), equal bits from two backward
    runs and from both layouts of x, and the times.  x is laid out as the
    main path gives it: the transposed view of a contiguous [BATCH, 16, slots]."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.kernels import transformer_body as tb
    from nasrec_tpu_torch.ops.kernels.attention import softmax_lse2, tiny_head_attention_plain

    dev = torch.device(DEVICE)
    x = torch.randn(BATCH, 16, slots, device=dev, generator=gen).transpose(1, 2)
    dout = torch.randn(BATCH, slots, 16, device=dev, generator=gen)
    params = []
    for name, shape in zip(tb.PARAM_NAMES, tb.PARAM_SHAPES):
        p = 0.3 * torch.randn(shape, device=dev, generator=gen)
        params.append(p + 0.17 if name in ("attn_ln_w", "fc_ln_w") else p)
    flat = tb.flatten_params(params)

    unsure = relu_edge_rows(x, params)
    dout[unsure] = 0.0
    with torch.no_grad():        # the plain attention output and statistics
        qkv = F.linear(x, params[0], params[1])
        o_p = tiny_head_attention_plain(qkv)
        stats_p = softmax_lse2(qkv)
        del qkv

    out_e, _, _ = tb.transformer_body_fwd_kernel(x, flat, save=False)
    out_t, o_k, stats_k = tb.transformer_body_fwd_kernel(x, flat, save=True)
    dx_k, dflat_k = tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat)
    dx_2, dflat_2 = tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat)
    torch.cuda.synchronize()
    same_bits = (torch.equal(out_e, out_t) and torch.equal(dx_k, dx_2)
                 and torch.equal(dflat_k, dflat_2))
    # The same values as a contiguous [BATCH, slots, 16]: the other layout the
    # kernels read in place.  dx comes back in the layout x had.
    xc = x.contiguous()
    out_c, o_c, stats_c = tb.transformer_body_fwd_kernel(xc, flat, save=True)
    dx_c, dflat_c = tb.transformer_body_bwd_kernel(xc, dout, o_c, stats_c, flat)
    torch.cuda.synchronize()
    same_layouts = (dx_c.is_contiguous() and dx_k.transpose(1, 2).is_contiguous()
                    and torch.equal(out_c, out_t) and torch.equal(o_c, o_k)
                    and torch.equal(stats_c, stats_k) and torch.equal(dx_c, dx_k)
                    and torch.equal(dflat_c, dflat_k))
    del xc, out_c, o_c, stats_c, dx_c, dflat_c

    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    out_g = tb.transformer_body_plain(xg, pg)
    grads_p = torch.autograd.grad(out_g, [xg] + pg, dout, retain_graph=True)
    errs, scales, ok = {}, {}, same_bits and same_layouts
    for key, got, want, tol in (
            [("out", out_e, out_g.detach(), KERNEL_REL_TOL), ("o", o_k, o_p, KERNEL_REL_TOL),
             ("stats", stats_k, stats_p, KERNEL_REL_TOL), ("dx", dx_k, grads_p[0], GRAD_REL_TOL)]
            + [(f"d_{n}", g.reshape(w.shape), w, GRAD_REL_TOL)
               for n, g, w in zip(tb.PARAM_NAMES, dflat_k.split(tb.PARAM_SIZES), grads_p[1:])]):
        errs[key], good = within(got, want, tol)
        scales[key] = want.abs().max().item()
        ok = ok and good
    emit({"phase": "kernels", "kernel": "transformer_body", "slots": slots, "batch": BATCH,
          "max_abs_err": errs, "grad_scale": scales, "equal_bits_twice": same_bits,
          "equal_bits_both_layouts": same_layouts,
          "rows_at_a_relu_edge": int(unsure.sum()), "ok": ok})
    if not ok:
        raise SystemExit(f"transformer_body S={slots} disagrees with its plain version")
    del o_p, stats_p

    # The one library module that computes the same function, timed only.
    lib = torch.nn.TransformerEncoderLayer(16, 8, dim_feedforward=16, dropout=0.0,
                                           batch_first=True, norm_first=False, device=dev)
    with torch.no_grad():
        for dst, src in zip((lib.self_attn.in_proj_weight, lib.self_attn.in_proj_bias,
                             lib.self_attn.out_proj.weight, lib.self_attn.out_proj.bias,
                             lib.norm1.weight, lib.norm1.bias, lib.linear1.weight,
                             lib.linear1.bias, lib.linear2.weight, lib.linear2.bias,
                             lib.norm2.weight, lib.norm2.bias), params):
            dst.copy_(src)
    lib.eval()        # no dropout either way; eval lets no_grad calls take its fused path
    lib_params = list(lib.parameters())
    xl = x.clone().requires_grad_(True)

    def lib_eval():
        with torch.no_grad():
            return lib(x)

    # A yardstick only: where the library refuses the shape or disagrees with
    # the plain version, the rows carry no library time.
    try:
        out_l = lib(xl)
        lib_err, lib_ok = within(out_l.detach(), out_g.detach(), 10 * KERNEL_REL_TOL)
        lib_err = max(lib_err, within(lib_eval(), out_g.detach(), 10 * KERNEL_REL_TOL)[0])
        lib_ok = lib_ok and lib_err <= 10 * KERNEL_REL_TOL * max(1.0, out_g.abs().max().item())
        note = None
    except RuntimeError as exc:
        out_l, lib_err, lib_ok, note = None, None, False, str(exc)[:200]
    emit({"phase": "kernels", "library": "nn.TransformerEncoderLayer", "slots": slots,
          "max_abs_err_vs_plain": lib_err, "agrees": lib_ok, "error": note})

    pos = BATCH * slots
    f_fwd, f_bwd = body_flops(slots)
    tensor_bytes = pos * 16 * 4
    # Tensors moved, in units of one [B, S, 16]: x and out; with o and the
    # statistic [B, S, 8]; x, dout, o, the statistic and dx.
    for name, kern, plain, lib_fn, ntensors, flops, err in (
        (f"transformer_body_fwd_s{slots}",
         lambda: tb.transformer_body_fwd_kernel(x, flat, save=False),
         lambda: no_grad_call(tb.transformer_body_plain, x, params), lib_eval,
         2, f_fwd, errs["out"]),
        (f"transformer_body_fwd_train_s{slots}",
         lambda: tb.transformer_body_fwd_kernel(x, flat, save=True),
         lambda: tb.transformer_body_plain(xg, pg), lambda: lib(xl),
         3.5, f_fwd, max(errs["out"], errs["o"], errs["stats"])),
        (f"transformer_body_bwd_s{slots}",
         lambda: tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat),
         lambda: torch.autograd.grad(out_g, [xg] + pg, dout, retain_graph=True),
         lambda: torch.autograd.grad(out_l, [xl] + lib_params, dout, retain_graph=True),
         4.5, f_bwd, max(v for k, v in errs.items() if k.startswith("d"))),
    ):
        rows_out[name] = kernel_row(name, BODY_SOURCE, BODY_REPLACES, err, kern, plain,
                                    lib_fn if lib_ok else None,
                                    ntensors * tensor_bytes + 2 * flat.numel() * 4,
                                    flops * pos, hbm, heavy=True, exps=8 * slots * pos)
    del out_g, out_l, grads_p, xg, xl
    torch.cuda.empty_cache()


def no_grad_call(fn, *args):
    import torch

    with torch.no_grad():
        return fn(*args)


def check_attention(slots, hbm, gen, rows_out) -> None:
    """The attention kernel at [BATCH, slots, 48], forward and backward,
    against the plain version; F.scaled_dot_product_attention as the library."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.kernels import attention as at

    dev = torch.device(DEVICE)
    qkv = torch.randn(BATCH, slots, 48, device=dev, generator=gen)
    do = torch.randn(BATCH, slots, 16, device=dev, generator=gen)
    o_k = at.tiny_head_attention_fwd_kernel(qkv)
    dqkv_k = at.tiny_head_attention_bwd_kernel(qkv, do)
    qg = qkv.clone().requires_grad_(True)
    o_g = at.tiny_head_attention_plain(qg)
    (dqkv_p,) = torch.autograd.grad(o_g, qg, do, retain_graph=True)
    torch.cuda.synchronize()
    fe, f_ok = within(o_k, o_g.detach(), KERNEL_REL_TOL)
    be, b_ok = within(dqkv_k, dqkv_p, GRAD_REL_TOL)
    emit({"phase": "kernels", "kernel": "tiny_head_attention", "slots": slots,
          "batch": BATCH, "o_max_abs_err": fe, "dqkv_max_abs_err": be, "ok": f_ok and b_ok})
    if not (f_ok and b_ok):
        raise SystemExit(f"tiny_head_attention S={slots} disagrees with its plain version")

    ql = qkv.clone().requires_grad_(True)

    def sdpa(t):
        q, k, v = (u.reshape(BATCH, slots, 8, 2).transpose(1, 2) for u in t.split(16, dim=-1))
        return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(BATCH, slots, 16)

    o_l = sdpa(ql)
    lib_err, lib_ok = within(o_l.detach(), o_g.detach(), 10 * KERNEL_REL_TOL)
    emit({"phase": "kernels", "library": "F.scaled_dot_product_attention", "slots": slots,
          "max_abs_err_vs_plain": lib_err, "agrees": lib_ok})
    pos = BATCH * slots
    f_fwd, f_bwd = attention_flops(slots)
    for name, kern, plain, lib_fn, nfloats, flops, exps, err in (
        (f"tiny_head_attention_fwd_s{slots}",
         lambda: at.tiny_head_attention_fwd_kernel(qkv),
         lambda: no_grad_call(at.tiny_head_attention_plain, qkv),
         lambda: no_grad_call(sdpa, qkv), 48 + 16, f_fwd, 8 * slots, fe),
        # Nothing is saved, so the backward first needs the forward's work too.
        (f"tiny_head_attention_bwd_s{slots}",
         lambda: at.tiny_head_attention_bwd_kernel(qkv, do),
         lambda: torch.autograd.grad(o_g, qg, do, retain_graph=True),
         lambda: torch.autograd.grad(o_l, ql, do, retain_graph=True),
         48 + 16 + 48, f_fwd + f_bwd, 16 * slots, be),
    ):
        rows_out[name] = kernel_row(name, ATTN_SOURCE, ATTN_REPLACES, err, kern, plain,
                                    lib_fn if lib_ok else None, nfloats * 4 * pos,
                                    flops * pos, hbm, heavy=True, exps=exps * pos)
    del o_g, o_l, qg, ql
    torch.cuda.empty_cache()


def check_fused_against_unfused(gen) -> None:
    """The transformer node of the xlarge plan's block 0 (26 -> 64 slots):
    its fused form (the body kernels) against its unfused form (PyTorch ops
    around the attention kernel), output and input gradient."""
    import torch

    from nasrec_tpu_torch.ops.attention import Transformer

    dev = torch.device(DEVICE)
    node = Transformer(26, 64, 16, False, gen, dev)
    sparse = torch.randn(BATCH, 26 * 16, device=dev, generator=gen)
    co = torch.randn(BATCH, 64 * 16, device=dev, generator=gen)
    with torch.no_grad():
        x = node.proj(sparse.reshape(BATCH, 26, 16).transpose(1, 2)).transpose(1, 2)
    unsure = relu_edge_rows(x, node.body_params())
    co[unsure] = 0.0
    res = []
    for fused in (True, False):
        node.fused = fused
        xs = sparse.clone().requires_grad_(True)
        out = node(xs, 16)
        res.append((out.detach(), torch.autograd.grad(out, xs, co)[0]))
    fe, f_ok = within(res[0][0], res[1][0], KERNEL_REL_TOL)
    be, b_ok = within(res[0][1], res[1][1], GRAD_REL_TOL)
    emit({"phase": "kernels", "check": "fused form against unfused form", "slots": 64,
          "batch": BATCH, "out_max_abs_err": fe, "dx_max_abs_err": be,
          "rows_at_a_relu_edge": int(unsure.sum()), "ok": f_ok and b_ok})
    if not (f_ok and b_ok):
        raise SystemExit("the transformer node's fused and unfused forms disagree")



def phase_kernels(hbm):
    """Each kernel against its plain version at the main paths' shapes."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.embedding import table_offsets
    from nasrec_tpu_torch.ops.kernels import dotprod, table_update
    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows_out = {}
    for slots in BODY_SLOTS:
        check_transformer_body(slots, hbm, gen, rows_out)
        check_attention(slots, hbm, gen, rows_out)
    for slots in OFF_PATH_SLOTS:
        off_path = {}
        check_transformer_body(slots, hbm, gen, off_path)
        check_attention(slots, hbm, gen, off_path)
        emit({"phase": "kernels", "off_path_shape": True, "slots": slots,
              "rows": list(off_path.values())})
    check_fused_against_unfused(gen)

    for n in (46, 17, 40, 9):
        P = dotprod.tril_size(n)
        t = torch.randn(BATCH, n, 16, device=dev, generator=gen)
        dz = torch.randn(BATCH, P, device=dev, generator=gen)
        idx = dotprod._tril_flat_index(n, dev)
        idx_t = (idx % n) * n + idx // n

        z_k = dotprod.dot_scores_tril_fwd_kernel(t)
        z_p = dotprod.dot_scores_tril_plain(t)
        dt_k = dotprod.dot_scores_tril_bwd_kernel(t, dz)
        tg = t.clone().requires_grad_(True)
        z_g = dotprod.dot_scores_tril_plain(tg)
        (dt_p,) = torch.autograd.grad(z_g, tg, dz, retain_graph=True)
        torch.cuda.synchronize()
        fe, fr, fs = max_err(z_k, z_p)
        be, br, bs = max_err(dt_k, dt_p)
        ok = fe <= KERNEL_REL_TOL * max(fs, 1.0) and be <= KERNEL_REL_TOL * max(bs, 1.0)
        emit({"phase": "kernels", "kernel": "dot_scores_tril", "n": n, "batch": BATCH,
              "z_max_abs_err": fe, "z_max_rel_err": fr, "dt_max_abs_err": be,
              "dt_max_rel_err": br, "ok": ok})
        if not ok:
            raise SystemExit(f"dot_scores_tril n={n} disagrees with its plain version")

        def lib_fwd():
            return torch.bmm(t, t.transpose(1, 2)).reshape(BATCH, n * n)[:, idx]

        def lib_bwd():
            full = torch.zeros(BATCH, n * n, device=dev)
            full[:, idx] = dz
            full[:, idx_t] = dz
            return torch.bmm(full.reshape(BATCH, n, n), t)

        t_bytes, z_bytes = BATCH * n * 16 * 4, BATCH * P * 4
        for name, kern, plain, lib, nbytes, flops, err in (
            (f"dot_scores_tril_fwd_n{n}",
             lambda: dotprod.dot_scores_tril_fwd_kernel(t),
             lambda: dotprod.dot_scores_tril_plain(t), lib_fwd,
             t_bytes + z_bytes, 2 * 16 * P * BATCH, fe),
            (f"dot_scores_tril_bwd_n{n}",
             lambda: dotprod.dot_scores_tril_bwd_kernel(t, dz),
             lambda: torch.autograd.grad(z_g, tg, dz, retain_graph=True), lib_bwd,
             2 * t_bytes + z_bytes, 2 * 16 * n * (n - 1) * BATCH, be),
        ):
            rows_out[name] = kernel_row(
                name, "nasrec_tpu_torch/csrc/dotprod.cu",
                "nasrec_tpu/ops/kernels/dotprod_pallas.py:160", err, kern, plain, lib,
                nbytes, flops, hbm)
        del t, dz, z_k, z_p, dt_k, tg, z_g, dt_p
        torch.cuda.empty_cache()

    spec = DATASETS["criteo-kaggle"]
    vocab = spec.vocab_sizes(VOCAB_CAP)
    total = int(sum(vocab))
    offsets = torch.as_tensor(table_offsets(vocab), device=dev)
    table0 = torch.randn(total, 16, device=dev, generator=gen)
    acc0 = torch.rand(total, 16, device=dev, generator=gen)
    rng = np.random.RandomState(0)
    for kind in ("uniform", "zipf"):
        idx2d = torch.as_tensor(draw_indices(rng, BATCH, vocab, kind), device=dev) + offsets
        g = 0.01 * torch.randn(BATCH * 26, 16, device=dev, generator=gen)
        rows, seg, is_end = rowwise_segment_sum_slotwise(idx2d, g)
        lr = 0.05
        t_k, a_k = table0.clone(), acc0.clone()
        table_update.table_update_kernel(t_k, a_k, rows, seg, lr)
        t_p, a_p = table0.clone(), acc0.clone()
        table_update.table_update_plain(t_p, a_p, rows, seg, lr)
        torch.cuda.synchronize()
        touched = torch.zeros(total, dtype=torch.bool, device=dev)
        touched[rows[is_end].long()] = True
        changed = (t_k != table0).any(1) | (a_k != acc0).any(1)
        untouched_exact = not bool((changed & ~touched).any())
        te, _, _ = max_err(t_k, t_p)
        ae, _, _ = max_err(a_k, a_p)
        unique = int(is_end.sum())
        ok = untouched_exact and te == 0.0 and ae == 0.0
        emit({"phase": "kernels", "kernel": "table_update", "indices": kind,
              "positions": rows.numel(), "touched_rows": unique,
              "table_max_abs_err": te, "acc_max_abs_err": ae,
              "untouched_rows_bit_exact": untouched_exact, "ok": ok})
        if not ok:
            raise SystemExit(f"table_update ({kind}) disagrees with its plain version")
        if kind == "uniform":
            r_end = rows[is_end].long()
            d = seg[is_end]
            sq = d * d
            delta = -(lr * d) / (torch.sqrt(acc0.index_select(0, r_end) + sq) + 1e-2)

            def lib_update():
                a_k.index_add_(0, r_end, sq)
                t_k.index_add_(0, r_end, delta)

            nbytes = rows.numel() * (4 + 64) + unique * 4 * 64
            rows_out["table_update"] = kernel_row(
                "table_update", "nasrec_tpu_torch/csrc/table_update.cu",
                "nasrec_tpu/ops/kernels/table_sweep_pallas.py:430", max(te, ae),
                lambda: table_update.table_update_kernel(t_k, a_k, rows, seg, lr),
                lambda: table_update.table_update_plain(t_p, a_p, rows, seg, lr),
                lib_update, nbytes, 6 * 16 * unique, hbm)
        del t_k, a_k, t_p, a_p, touched, changed, idx2d, g, rows, seg, is_end
        torch.cuda.empty_cache()
    del table0, acc0
    torch.cuda.empty_cache()
    return rows_out


def phase_main(space, rows_out):
    """One main path at full width: criteo-kaggle/<space>, kernel run (counted)
    against plain run, then one eval forward of each; for xlarge also a short
    run with the transformer nodes unfused."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
    from nasrec_tpu_torch.configs import get_best_arch
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
    from nasrec_tpu_torch.ops.attention import Transformer
    from nasrec_tpu_torch.train.loop import make_eval_step
    from nasrec_tpu_torch.train.optim import make_lr_schedule
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    dev = torch.device(DEVICE)
    steps = STEPS[space]
    spec = DATASETS["criteo-kaggle"]
    vocab = spec.vocab_sizes(VOCAB_CAP)
    plan = build_fixed_plan(get_best_arch("criteo-kaggle", space),
                            OPS_CONFIG_LIB[space], 7, spec.num_dense,
                            spec.num_sparse, vocab)
    t0 = time.perf_counter()
    model_k = fixed_init(plan, seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    model_u = copy.deepcopy(model_k) if space == "xlarge" else None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    batches = [(torch.as_tensor(rng.randn(BATCH, spec.num_dense).astype(np.float32), device=dev),
                torch.as_tensor(draw_indices(rng, BATCH, vocab, "uniform"), device=dev),
                torch.as_tensor(rng.randint(0, 2, size=(BATCH, 1)).astype(np.float32), device=dev))
               for _ in range(steps)]
    sched = make_lr_schedule("cosine", 0.16, 10_000, 1_000)

    def run(model, impl, n):
        state = init_sparse_train_state(model)
        step = make_sparse_embedding_train_step(sched, grad_clip=5.0, impl=impl)
        losses, times = [], []
        for d, c, y in batches[:n]:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            state, m = step(state, d, c, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(float(m["loss"]))
        return losses, times, m["logits"], lambda: step(state, *batches[0])

    def evaluate(model, impl):
        with torch.no_grad():
            return make_eval_step(impl)(model, *batches[0][:2])

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses_k, times_k, logits_k, more_k = run(model_k, "auto", steps)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_launches()
    eval_k = evaluate(model_k, "auto")
    eval_launches = read_launches()
    torch.cuda.reset_peak_memory_stats()
    losses_p, times_p, logits_p, _ = run(model_p, "plain", steps)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_p = evaluate(model_p, "plain")

    sd_k, sd_p = model_k.state_dict(), model_p.state_dict()
    param_diff = max((sd_k[k] - sd_p[k]).abs().max().item() for k in sd_k)
    loss_diff = max(abs(a - b) for a, b in zip(losses_k, losses_p))
    logit_diff = (logits_k - logits_p).abs().max().item()
    eval_diff = (eval_k - eval_p).abs().max().item()
    step_ms = float(np.median(times_k[1:])) * 1e3
    plain_step_ms = float(np.median(times_p[1:])) * 1e3
    ok = (all(math.isfinite(x) for x in losses_k + losses_p)
          and tuple(eval_k.shape) == (BATCH, 1) and bool(torch.isfinite(eval_k).all())
          and loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
          and eval_diff <= LOGIT_TOL
          and launches == {k: steps for k in TRAIN_STEP_KERNELS[space]}
          and eval_launches == {k: 1 for k in EVAL_KERNELS[space]})
    emit({"phase": "main", "arch": f"criteo-kaggle/{space}", "vocab_rows": int(sum(vocab)),
          "batch": BATCH, "steps": steps, "init_s": init_s, "losses": losses_k,
          "losses_plain": losses_p, "max_loss_diff": loss_diff,
          "max_logit_diff": logit_diff, "max_param_diff": param_diff,
          "max_eval_logit_diff": eval_diff,
          "step_ms": step_ms, "examples_per_s": BATCH / step_ms * 1e3,
          "step_ms_all": [x * 1e3 for x in times_k], "plain_step_ms": plain_step_ms,
          "peak_mem_gb": peak_gb, "plain_peak_mem_gb": plain_peak_gb,
          "plain_run": "whole batches", "launches": launches,
          "eval_launches": eval_launches, "ok": ok})
    if not ok:
        raise SystemExit(f"main path criteo-kaggle/{space} failed (see the 'main' line)")
    del model_p
    for name, count in [*launches.items(), *eval_launches.items()]:
        rows_out[name]["launches"] = rows_out[name].get("launches", 0) + count

    if model_u is not None:
        # The same first steps with every transformer node in its unfused
        # form, which runs the attention kernel in the body kernels' place.
        for node in model_u.modules():
            if isinstance(node, Transformer):
                node.fused = False
        reset_launches()
        losses_u, times_u, _, _ = run(model_u, "auto", UNFUSED_STEPS)
        unfused = read_launches()
        diff_u = max(abs(a - b) for a, b in zip(losses_u, losses_k))
        ok = (diff_u <= LOSS_TOL
              and unfused == {k: UNFUSED_STEPS for k in UNFUSED_STEP_KERNELS})
        emit({"phase": "main", "arch": f"criteo-kaggle/{space}", "form": "unfused",
              "steps": UNFUSED_STEPS, "losses": losses_u, "max_loss_diff_vs_fused": diff_u,
              "step_ms_all": [x * 1e3 for x in times_u], "launches": unfused, "ok": ok})
        if not ok:
            raise SystemExit("main path with unfused transformer nodes failed")
        for name, count in unfused.items():
            if name.startswith("tiny_head_attention"):
                rows_out[name]["launches"] = count
        del model_u

    profile_steps(space, more_k, 3)
    del model_k, batches, more_k
    torch.cuda.empty_cache()


def profile_steps(space, step_fn, steps: int) -> None:
    """Where a main-path step's device time goes: torch.profiler over a few
    more kernel-path steps (after the comparison above), device time summed
    by kernel, and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # device kernels and copies only
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        rows.append((dev_us / 1e3 / steps, ev.key[:90], ev.count // steps))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "arch": f"criteo-kaggle/{space}", "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_ms_per_step": device_ms,
          "device_busy_share": device_ms * steps / wall_ms if wall_ms else None,
          "top_ops": [{"op": k, "ms_per_step": ms, "calls_per_step": c}
                      for ms, k, c in rows[:15]]})


def phase_cli(space):
    """The CLI on synthetic data with a planted signal: 40 steps must lower
    the test loss and lift the test AUROC above chance.  (At the default
    lr 0.16 a run this short has a warmup of 0 steps and diverges, in the
    JAX package as here, so the phase trains at lr 0.02.)"""
    from nasrec_tpu_torch.cli import main_train

    reset_launches()
    t0 = time.perf_counter()
    out = main_train.main([
        "--arch", f"criteo-kaggle/{space}", "--data_source", "synthetic",
        "--device", "cuda", "--max_train_steps", str(CLI_STEPS), "--max_eval_steps", "1",
        "--train_batch_size", "2048", "--test_batch_size", "8192",
        "--learning_rate", "0.02", "--display_interval", "10", "--test_interval", "20",
    ])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    logs = out["logs"][0]
    first, last = logs["test_loss"][0], logs["test_loss"][-1]
    # Each train step launches every kernel of a train step once; the eval
    # forwards, under no_grad, launch the forward kernels.
    ok = (all(math.isfinite(x) for x in logs["train_loss"]) and math.isfinite(last)
          and last < first and logs["test_AUROC"][-1] > 0.6
          and set(launches) == TRAIN_STEP_KERNELS[space] | EVAL_KERNELS[space]
          and all(launches[k] >= CLI_STEPS for k in TRAIN_STEP_KERNELS[space])
          and all(launches[k] >= 1 for k in EVAL_KERNELS[space]))
    emit({"phase": "cli", "arch": f"criteo-kaggle/{space}", "train_loss": logs["train_loss"],
          "test_loss": logs["test_loss"], "test_auroc": logs["test_AUROC"],
          "launches": launches, "seconds": seconds, "ok": ok})
    if not ok:
        raise SystemExit(f"CLI entry point did not learn the synthetic signal ({space})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "nasrec_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the nasrec_tpu_torch package is not next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nasrec_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    smi = phase_device(build)
    rows_out = phase_kernels(hbm_bytes_per_s(smi))
    for space in ("xlarge", "autoctr"):
        phase_main(space, rows_out)
    for space in ("autoctr", "xlarge"):
        phase_cli(space)
    idle = [name for name, row in rows_out.items() if not row.get("launches")]
    if idle:
        raise SystemExit(f"kernels that no main path launched: {idle}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": list(rows_out.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
