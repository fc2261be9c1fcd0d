"""Where the transformer body's backward kernel spends its time.

    python -m nasrec_tpu_torch.tools.body_bwd_split                 # one CUDA card

Builds copies of csrc/transformer_body.cu in which one part of
`body_bwd_kernel` is cut out by a text edit (the parameter-gradient products,
the attention sweep for dq, the sweep for dk and dv), times each copy at batch
32768, S = 64 and 48, and prints the full kernel's time beside each cut's.
The time a part costs is about the full time less the time without it; the
parts overlap a little, so the shares need not add to one.  The cut copies
compute wrong results and are only timed.  The training forward is timed the
same way without its attention loop, without the pass for the maximum, and
without the exponentials.  Nothing in the package changes.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

BATCH = 32768
SLOTS = (64, 48)

# Text edits of (file, old, new, how many times old must occur).
NO_PGRAD = [("transformer_body.cu", "for (int k0 = 0; k0 < 32; k0 += 8) {",
             "for (int k0 = 0; k0 < 0; k0 += 8) {", 1),
            ("transformer_body.cu", "for (int j = 0; j < 32; ++j) sum +=",
             "for (int j = 0; j < 0; ++j) sum +=", 1)]
NO_DQ = [("transformer_body.cu", "r0 + row0, r1 + row0, S, dq);",
          "r0 + row0, r1 + row0, 0, dq);", 1)]
NO_DKV = [("transformer_body.cu", "r2 + row0, S, dk, dv);", "r2 + row0, 0, dk, dv);", 1)]
# Cuts of the forward kernel: the whole attention loop, its pass for the
# maximum, its exponentials.
FWD_NO_ATTN = [("transformer_body.cu", "attn_fwd(q2, sk + row0, sv + row0, S, ov, lse2);",
                "attn_fwd(q2, sk + row0, sv + row0, 0, ov, lse2);", 1)]
FWD_NO_MAX = [("tiny_attn.cuh", "m[h] = fmaxf(m[h], dot2(q2, kj, h, 0.0f));", "m[h] = 0.0f;", 1)]
FWD_NO_EXP = [("tiny_attn.cuh", "const float p = ex2(dot2(q2, kj, h, m[h]));",
               "const float p = dot2(q2, kj, h, m[h]);", 1)]
FWD_VARIANTS = {"fwd_no_attention": FWD_NO_ATTN, "fwd_no_max_pass": FWD_NO_MAX,
                "fwd_no_exp": FWD_NO_EXP}
VARIANTS = {
    "full": [],
    "no_param_grads": NO_PGRAD,
    "no_dq_sweep": NO_DQ,
    "no_dkv_sweep": NO_DKV,
    "no_sweeps": NO_DQ + NO_DKV,
    "no_param_grads_no_sweeps": NO_PGRAD + NO_DQ + NO_DKV,
}


def build_variants(csrc: Path, nvcc: str, flags) -> dict:
    """One nvcc per variant, all started together -> {name: (CDLL, tmp dir)}."""
    procs = {}
    for name, edits in {**VARIANTS, **FWD_VARIANTS}.items():
        tmp = Path(tempfile.mkdtemp())
        for f in csrc.iterdir():
            shutil.copy(f, tmp / f.name)
        for fname, old, new, count in edits:
            text = (tmp / fname).read_text()
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} times in {fname}, "
                                   f"not {count}: the source moved, update the edit")
            (tmp / fname).write_text(text.replace(old, new))
        cmd = [nvcc, *flags, "-I", str(tmp), "-o", str(tmp / "lib.so"),
               str(tmp / "transformer_body.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    libs = {}
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling" in line and "body_bwd_kernel" in line:
                print(f"{name}:", " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)
        libs[name] = (ctypes.CDLL(str(tmp / "lib.so")), tmp)
    return libs


def main() -> None:
    import numpy as np
    import torch

    from nasrec_tpu_torch.ops.kernels import build
    from nasrec_tpu_torch.ops.kernels import transformer_body as tb

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
    for s in SLOTS:
        x = torch.randn(BATCH, s, 16, device=dev, generator=gen)
        dout = torch.randn(BATCH, s, 16, device=dev, generator=gen)
        flat = tb.flatten_params([0.3 * torch.randn(sh, device=dev, generator=gen)
                                  for sh in tb.PARAM_SHAPES])
        _, o, stats = tb.transformer_body_fwd_kernel(x, flat, True)
        for name, (lib, _) in libs.items():
            tb.build._LOADED["transformer_body"] = lib
            for fn, argtypes in build.SIGNATURES["transformer_body"].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            if name in VARIANTS:
                result[f"{name}_s{s}"] = ms(
                    lambda: tb.transformer_body_bwd_kernel(x, dout, o, stats, flat))
            if name == "full" or name in FWD_VARIANTS:
                result[f"fwd_train_{name}_s{s}"] = ms(
                    lambda: tb.transformer_body_fwd_kernel(x, flat, True))
        build._LOADED.pop("transformer_body", None)
    for _, tmp in libs.values():
        shutil.rmtree(tmp)
    for s in SLOTS:
        full = result[f"full_s{s}"]
        for name in VARIANTS:
            t = result[f"{name}_s{s}"]
            print(f"S = {s} {name}: {t:.4f} ms ({100 * (full - t) / full:.1f} % less than full)")
    for key in sorted(k for k in result if k.startswith("f")):
        print(f"{key}: {result[key]:.4f} ms")
    print(json.dumps({"body_bwd_split_ms": result}))


if __name__ == "__main__":
    main()
