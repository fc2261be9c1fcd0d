"""The control of a training cell's comparison: the reference put in the
program's place, computed in a lower precision than the configuration states
(`tf32`: matrix products in TF32; `bf16`: bfloat16 autocast), against the
reference in float32, at the cell's own size, seed by seed.  Each line is one
seed's numbers; the comparison has to fail them.

    python3 benchmark/tools/control.py --workload xlarge.uniform --seeds 1 2 3 \\
        --precision tf32 bf16
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None, device="cuda", overrides=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", nargs="+", default=["tf32", "bf16"])
    args = ap.parse_args(argv)
    import torch

    from lib import cell as C
    from lib import compare

    cell = C.load_cell(args.workload)
    cfg = C.load_config(cell["config"])
    cell.update((overrides or {}).get("cell", {}))
    cfg.update((overrides or {}).get("config", {}))
    drv = C.driver(cell["driver"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for seed in args.seeds:
        inputs = drv.control_inputs(cfg, cell, seed, dev)
        judge = getattr(drv, "control_reference", None)
        ref = None if judge else drv.reference(cfg, cell, seed, dev, inputs)
        for p in args.precision:
            low = drv.reference(cfg, cell, seed, dev, inputs, precision=p)
            if judge:
                ref = judge(cfg, cell, seed, dev, inputs, low)
            gaps = drv.gaps(low, ref)
            ok, _ = compare.judge(gaps, {k: v for k, v in cell["limits"].items() if k in gaps})
            row = {"workload": args.workload, "seed": seed, "precision": p, "gaps": gaps,
                   "passes_limits": ok}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
