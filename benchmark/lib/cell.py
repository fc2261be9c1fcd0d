"""Finding a cell's files by name, and what a run hands its driver.

A cell is `workloads/<name>.json`; it names its configuration
(`configs/<config>.json`) and its driver (`drivers/<driver>.py`).  A per-layer
metric is read by `metrics/<metric>.py :: read(ctx)`, which returns a number
or None where the cell gives it nothing to read.  Which metrics a cell
reports is BENCHMARK.json's: every end-to-end metric without a `workloads`
key or with the cell in it, and every per-layer metric with the cell in its
`workloads`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent                                   # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    cell = load_json(HERE / "workloads" / f"{name}.json")
    if cell["name"] != name:
        raise ValueError(f"workloads/{name}.json names itself {cell['name']!r}")
    return cell


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py")


def metrics_for(cell: str, bench: dict) -> Dict[str, List[dict]]:
    """{'end_to_end': [...], 'per_layer': [...]} entries of BENCHMARK.json
    that this cell reports."""
    def mine(m, default):
        return cell in m["workloads"] if "workloads" in m else default

    return {"end_to_end": [m for m in bench["end_to_end"] if mine(m, True)],
            "per_layer": [m for m in bench["per_layer"] if mine(m, False)]}


def card_line() -> str:
    """nvidia-smi's name and power limit of the card in use."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc}"


class Clock:
    """Seconds since the run started (the run's first statement)."""

    def __init__(self, t0: float):
        self.t0 = t0

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def cache_env() -> None:
    """Fixed cache directories inside the checkout for what the program may
    compile at run time, and no JAX behind a library's back."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
