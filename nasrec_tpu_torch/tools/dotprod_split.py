"""Where the dot-product kernels spend their time.

    python -m nasrec_tpu_torch.tools.dotprod_split                  # one CUDA card

Builds copies of csrc/dotprod.cu in which one part of a kernel is cut out by a
text edit (the backward's loop below the block of rows, its loop above, all
its loops, its shared-memory loads of dz or of the operand, its asynchronous
staging, its stores to device memory; the forward's products, its stores),
times each copy at batch 32768, n = 46 and 40, with the package's default
launch shapes, and prints the full kernel's time beside each cut's.  The time
a part costs is about the full time less the time without it; with the loops
and the stores cut, what is left is the asynchronous staging, the barriers
and the writes into the staged outputs.  The cut copies compute wrong results
and are only timed.  Nothing in the package changes.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

BATCH = 32768
SIZES = (46, 40)

# Text edits of csrc/dotprod.cu: (old, new, how many times old must occur).
NO_BELOW = [("for (int jb = 0; jb < i0; jb += 4) {", "for (int jb = 0; jb < 0; jb += 4) {", 1)]
NO_ABOVE = [("for (int jb = i0 + 4; jb < n; jb += 4) {",
             "for (int jb = i0 + 4; jb < 0; jb += 4) {", 1)]
NO_BLOCK = [("const int j = i0 + jj;\n        if (j < n) {",
             "const int j = i0 + jj;\n        if (j < 0) {", 1)]
NO_BWD_STORES = [("    store_floats(ydst, ys, t.rows * kE * m);\n", "", 1),
                 ("    store_floats(xdst, xs, t.rows * kE);\n", "", 1)]
NO_FMA = [("      for (int e = 0; e < kE; ++e) {", "      for (int e = 0; e < 0; ++e) {", 1)]
NO_FWD_STORES = [("    store_floats(zdst, zs, t.rows * P);\n", "", 1)]
# The loops with a constant in place of each dz value, or of each operand load.
NO_DZ_LOADS = [("zr[base[a] + jb + jj]", "1.0f", 1), ("zr[bj + a], tv[jj]", "1.0f, tv[jj]", 1)]
NO_T_LOADS = [("const float4 q = load4(tr + y * NEB * ld + jb);",
               "const float4 q = make_float4(1.0f, 2.0f, 3.0f, 4.0f);", 1)]
# Nothing staged: the tiles hold whatever shared memory held.
NO_BWD_STAGING = [("stage_operand(st[0], x + t.b0 * kE, yt + t.b0 * kE * m, t.rows, m, ld, rs, "
                   "s.magic);\n    stage_floats(", "stage_floats(", 1),
                  ("stage_floats(sdz[0] + phase16(dz + t.b0 * P), dz + t.b0 * P, t.rows * P);",
                   "", 1),
                  ("      stage_floats(sdz[cur ^ 1] + phase16(dz + nt.b0 * P), dz + nt.b0 * P, "
                   "nt.rows * P);\n", "", 1),
                  ("if (tile + gridDim.x < ntile_b) {\n      const Tile nt = tile_at(tile + "
                   "gridDim.x, s);\n      stage_operand(st[cur ^ 1], x + nt.b0 * kE, yt + nt.b0 "
                   "* kE * m, nt.rows, m, ld, rs,\n                    s.magic);\n    }\n"
                   "    cp_async_commit();\n    cp_async_wait<1>();\n",
                   "cp_async_commit();\n    cp_async_wait<1>();\n", 1)]
BWD_VARIANTS = {
    "full": [],
    "no_loop_below": NO_BELOW,
    "no_loop_above": NO_ABOVE,
    "no_loops": NO_BELOW + NO_ABOVE + NO_BLOCK,
    "no_dz_loads": NO_DZ_LOADS,
    "no_operand_loads": NO_T_LOADS,
    "no_staging": NO_BWD_STAGING,
    "no_stores": NO_BWD_STORES,
    "no_loops_no_stores": NO_BELOW + NO_ABOVE + NO_BLOCK + NO_BWD_STORES,
}
FWD_VARIANTS = {
    "full": [],
    "fwd_no_products": NO_FMA,
    "fwd_no_stores": NO_FWD_STORES,
    "fwd_no_products_no_stores": NO_FMA + NO_FWD_STORES,
}


def build_variants(csrc: Path, nvcc: str, flags) -> dict:
    """One nvcc per variant, all started together -> {name: (CDLL, tmp dir)}."""
    procs = {}
    for name, edits in {**BWD_VARIANTS, **FWD_VARIANTS}.items():
        tmp = Path(tempfile.mkdtemp())
        text = (csrc / "dotprod.cu").read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} times, not "
                                   f"{count}: the source moved, update the edit")
            text = text.replace(old, new)
        (tmp / "dotprod.cu").write_text(text)
        cmd = [nvcc, *flags, "-o", str(tmp / "lib.so"), str(tmp / "dotprod.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    libs = {}
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(tmp / "lib.so")), tmp)
    return libs


def main() -> None:
    import numpy as np
    import torch

    from nasrec_tpu_torch.ops.kernels import build, dotprod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    def ms(fn, groups=5, per_group=5):
        for _ in range(3):
            fn()
        times = []
        for _ in range(groups):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_group):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / per_group)
        return float(np.median(times))

    libs = build_variants(build.CSRC_DIR, build._nvcc(), build.NVCC_FLAGS)
    result = {}
    for n in SIZES:
        x = torch.randn(BATCH, 16, device=dev, generator=gen)
        yt = torch.randn(BATCH, 16, n - 1, device=dev, generator=gen)
        dz = torch.randn(BATCH, dotprod.tril_size(n), device=dev, generator=gen)
        for name, (lib, _) in libs.items():
            build._LOADED["dotprod"] = lib
            for fn, argtypes in build.SIGNATURES["dotprod"].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            if name in BWD_VARIANTS:
                result[f"bwd_{name}_n{n}"] = ms(
                    lambda: dotprod.dot_scores_tril_bwd_kernel(x, yt, dz))
            if name in FWD_VARIANTS:
                key = name if name.startswith("fwd") else f"fwd_{name}"
                result[f"{key}_n{n}"] = ms(lambda: dotprod.dot_scores_tril_fwd_kernel(x, yt))
        build._LOADED.pop("dotprod", None)
    for _, tmp in libs.values():
        shutil.rmtree(tmp)
    for key, t in result.items():
        print(f"{key}: {t:.4f} ms")
    print(json.dumps({"dotprod_split_ms": result,
                      "launch_shapes": {f"n{n}": {"fwd": list(dotprod.fwd_config(n)),
                                                  "bwd": list(dotprod.bwd_config(n))}
                                        for n in SIZES}}))


if __name__ == "__main__":
    main()
