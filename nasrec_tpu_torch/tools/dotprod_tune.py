"""Which launch shape suits the dot-product kernels and the table update.

    python -m nasrec_tpu_torch.tools.dotprod_tune                   # one CUDA card
    python -m nasrec_tpu_torch.tools.dotprod_tune --n 46 --quick    # one shape, defaults only

For each n (46, 40, 17, 9: the main paths' shapes) at batch 32768 it runs the
forward kernel over tiles of 1 to 32 batch rows and blocks of 64 to 256
threads, and the backward kernel over 4 and 8 features a thread and the same
tiles and blocks; every shape is first held against the plain version (1e-5
of the largest magnitude) and then timed with CUDA events, back to back and
with the L2 cache overwritten between launches.  The table update, which has
one launch shape, is held against its plain version bit for bit and timed the
same two ways on the full Criteo vocab.  One JSON line a shape, then the
default's time beside the best for each kernel.  `--quick` holds and times
the defaults only.  Nothing in the package changes: the shapes are set through
`dotprod.TUNE` for the run.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import numpy as np
import torch

from nasrec_tpu_torch.ops.kernels import build, dotprod, table_update

REL_TOL = 1e-5
L2_FLUSH_BYTES = 256 * 1024 * 1024      # well over the H100's 50 MB L2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def warm_ms(fn, groups: int = 5, per_group: int = 5) -> float:
    """Median over groups of the mean time of back-to-back launches."""
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


def cold_ms(fn, scratch: torch.Tensor, launches: int = 7) -> float:
    """Median time of single launches, each after the L2 was overwritten."""
    times = []
    for _ in range(launches):
        scratch.add_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(got, want) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def tune_dotprod(n: int, batch: int, quick: bool, scratch) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(batch, 16, device=dev, generator=gen)
    yt = torch.randn(batch, 16, n - 1, device=dev, generator=gen)
    dz = torch.randn(batch, dotprod.tril_size(n), device=dev, generator=gen)
    xg, yg = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    z_p = dotprod.dot_scores_tril_plain(xg, yg)
    dx_p, dy_p = torch.autograd.grad(z_p, [xg, yg], dz)
    z_p = z_p.detach()

    tbs, threads = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32), (64, 96, 128, 192, 256)
    fwd = [dotprod.fwd_config(n)] + ([] if quick else [
        (tb, th) for tb, th in itertools.product(tbs, threads)
        if dotprod.fwd_smem_bytes(n, tb) <= dotprod.SMEM_MAX])
    bwd = [dotprod.bwd_config(n)] + ([] if quick else [
        (te, tb, th) for te, tb, th in itertools.product((4, 8), tbs, threads)
        if dotprod.bwd_smem_bytes(n, tb) <= dotprod.SMEM_MAX])
    for kind, shapes in (("fwd", fwd), ("bwd", bwd)):
        results = []
        for shape in shapes:
            dotprod.TUNE[(kind, n)] = shape
            if kind == "fwd":
                run = lambda: dotprod.dot_scores_tril_fwd_kernel(x, yt)
                err = rel_err(run(), z_p)
            else:
                run = lambda: dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
                dx_k, dy_k = run()
                err = max(rel_err(dx_k, dx_p), rel_err(dy_k, dy_p))
            if err > REL_TOL:
                raise SystemExit(f"dot_scores_tril {kind} n={n} shape={shape}: error {err}")
            results.append({"kernel": f"dot_scores_tril_{kind}", "n": n, "batch": batch,
                            "shape": list(shape), "rel_err": err, "ms": warm_ms(run),
                            "cold_ms": cold_ms(run, scratch)})
            emit(results[-1])
        del dotprod.TUNE[(kind, n)]
        best = min(results, key=lambda r: r["ms"])
        emit({"summary": f"dot_scores_tril_{kind}", "n": n, "default": results[0],
              "best": best, "best_cold": min(results, key=lambda r: r["cold_ms"])})


def tune_table_update(batch: int, scratch) -> None:
    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.embedding import table_offsets
    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(None)
    total = int(sum(vocab))
    rng = np.random.RandomState(0)
    idx = np.stack([rng.randint(0, v, size=batch) for v in vocab], axis=1).astype(np.int32)
    idx2d = torch.as_tensor(idx, device=dev) + torch.as_tensor(table_offsets(vocab), device=dev)
    g = 0.01 * torch.randn(batch * len(vocab), 16, device=dev, generator=gen)
    rows, seg, is_end = rowwise_segment_sum_slotwise(idx2d, g)
    table0 = torch.randn(total, 16, device=dev, generator=gen)
    acc0 = torch.rand(total, 16, device=dev, generator=gen)
    t_p, a_p = table0.clone(), acc0.clone()
    table_update.table_update_plain(t_p, a_p, rows, seg, 0.05)
    t_k, a_k = table0.clone(), acc0.clone()
    table_update.table_update_kernel(t_k, a_k, rows, seg, 0.05)
    torch.cuda.synchronize()
    if not (torch.equal(t_k, t_p) and torch.equal(a_k, a_p)):
        raise SystemExit("table_update differs from its plain version")
    run = lambda: table_update.table_update_kernel(t_k, a_k, rows, seg, 0.05)
    emit({"kernel": "table_update", "positions": rows.numel(),
          "touched_rows": int(is_end.sum()), "bit_exact": True,
          "ms": warm_ms(run), "cold_ms": cold_ms(run, scratch)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="*", default=[46, 40, 17, 9])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--quick", action="store_true", help="the default shapes only")
    ap.add_argument("--no_table_update", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dotprod_tune: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    report = build.build_all(["dotprod", "table_update"])
    emit({"nvidia_smi": smi, "nvcc_s": {k: r["seconds"] for k, r in report.items()},
          "ptxas": {k: [l.strip() for l in r["log"].splitlines()
                        if "registers" in l or "Compiling entry" in l or "spill" in l]
                    for k, r in report.items()}})
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    for n in args.n:
        tune_dotprod(n, args.batch, args.quick, scratch)
    if not args.no_table_update:
        tune_table_update(args.batch, scratch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
