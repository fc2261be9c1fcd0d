#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  The cell's file (`benchmark/workloads/<cell>.json`) names its
configuration and its driver; the driver builds the port's system under test
from the seed, warms up every shape the window uses (set-up), measures for
`--seconds`, checks what the timed path produced against the plain reference
(`benchmark/reference/`) and returns its numbers.  `--trace 0` reports the
cell's end-to-end metrics, `--trace 1` its per-layer metrics, read from a
profiled slice after a window measured as in `--trace 0`.

The last line of standard output is one JSON object; the last lines of
standard error are the numbers that decided `correct`, each beside its limit.
Without a CUDA card, or with JAX or the JAX package loaded once the window has
closed, the run exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "nasrec_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


class Run:
    """What a driver gets: the arguments, the cell and its configuration, the
    device, the run's clock, and the per-layer readers of the cell."""

    def __init__(self, args, cell, cfg, wanted, device, clock, overrides=None):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.cell, self.cfg, self.wanted = cell, cfg, wanted
        self.device, self.clock = device, clock
        # Tests shrink a cell to a CPU's size; a run on the card never does.
        self.cell.update((overrides or {}).get("cell", {}))
        self.cfg.update((overrides or {}).get("config", {}))
        self.faults = (overrides or {}).get("faults", {})

    def read_layers(self, ctx: dict) -> dict:
        from lib import cell as C

        out = {}
        for m in self.wanted["per_layer"]:
            v = C.reader(m["name"]).read(ctx)
            if v is not None:
                out[m["name"]] = float(v)
        return out


def main(argv=None, device=None, overrides=None) -> int:
    args = parse_args(argv)
    from lib import cell as C

    C.cache_env()
    cell = C.load_cell(args.workload)
    cfg = C.load_config(cell["config"])
    wanted = C.metrics_for(args.workload, C.load_json(C.ROOT / "BENCHMARK.json"))

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                  f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    run = Run(args, cell, cfg, wanted, torch.device(device), C.Clock(T0), overrides)
    out = C.driver(cell["driver"]).run(run)
    if run.device.type == "cuda":
        # After the run, so that nvidia-smi's start is not in set-up.
        print(f"card: {C.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
              file=sys.stderr, flush=True)

    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded in this process: {found}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {m["name"]: {"value": out["layers"][m["name"]], "unit": m["unit"]}
                   for m in wanted["per_layer"] if m["name"] in out["layers"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in wanted["end_to_end"] if m["name"] in out["e2e"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        tr = out["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
