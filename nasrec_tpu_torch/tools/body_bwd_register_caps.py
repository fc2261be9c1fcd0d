"""Time the transformer body's backward kernel under register caps.

    python -m nasrec_tpu_torch.tools.body_bwd_register_caps      # one CUDA card

`body_bwd_kernel` (csrc/transformer_body.cu) takes about 240 registers a
thread, which admits two 128-thread blocks a multiprocessor; its 72 KB of
shared memory a block would admit three.  This script builds copies of the
source capped by `__launch_bounds__(128, n)` for n = 2, 3 and 4 blocks, prints
what ptxas says of each (registers, spills), and times each at batch 32768,
S = 64 and 48, with a grid of n blocks a multiprocessor.  It changes nothing
in the package.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

OLD = "__launch_bounds__(kMaxThreads, kBwdBlocksPerSm)\nbody_bwd_kernel"
BATCH = 32768


def main() -> None:
    import numpy as np
    import torch

    from nasrec_tpu_torch.ops.kernels import build
    from nasrec_tpu_torch.ops.kernels import transformer_body as tb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    data = {}
    for s in (64, 48):
        x = torch.randn(BATCH, s, 16, device=dev, generator=gen)
        dout = torch.randn(BATCH, s, 16, device=dev, generator=gen)
        flat = tb.flatten_params([0.3 * torch.randn(sh, device=dev, generator=gen)
                                  for sh in tb.PARAM_SHAPES])
        data[s] = (x, dout, flat)

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

    source = (build.CSRC_DIR / "transformer_body.cu").read_text()
    assert OLD in source, "the backward kernel's launch bounds moved"
    csrc = build.CSRC_DIR
    for blocks in (2, 3, 4):
        tmp = Path(tempfile.mkdtemp())
        for f in csrc.iterdir():
            shutil.copy(f, tmp / f.name)
        (tmp / "transformer_body.cu").write_text(source.replace(
            OLD, f"__launch_bounds__(kMaxThreads, {blocks})\nbody_bwd_kernel"))
        build.CSRC_DIR = tmp
        build._LOADED.pop("transformer_body", None)
        log = build.build_all(["transformer_body"]).get("transformer_body", {}).get("log", "")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling" in line and "body_bwd_kernel" in line:
                print(f"blocks/SM {blocks}:", " | ".join(x.strip() for x in lines[i + 2:i + 4]))
        tb.BWD_BLOCKS_PER_SM = blocks
        for s, (x, dout, flat) in data.items():
            _, o, stats = tb.transformer_body_fwd_kernel(x, flat, True)
            t = ms(lambda: tb.transformer_body_bwd_kernel(x, dout, o, stats, flat))
            print(f"blocks/SM {blocks}: S = {s} backward {t:.4f} ms")
        shutil.rmtree(tmp)
    build.CSRC_DIR = csrc
    tb.BWD_BLOCKS_PER_SM = 2


if __name__ == "__main__":
    main()
