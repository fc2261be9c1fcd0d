"""Whole runs of each driver on the CPU at a tiny size, the harness's look
for a card skipped: correct comes out true on the port's plain path, and
false with the timed path broken underneath (a step that returns its state
unchanged; half of each batch left out, the mean taken over the rest; a
candidate's logits altered where they are produced).  Without a card, a run
exits non-zero and prints no result.  The controls: the reference in bf16
fails the comparison here; in TF32 (the configurations' next precision
down) on the card."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import pytest

import run as bench_run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {
    "xlarge.uniform": {"cell": {"batch": 128, "vocab_cap": 1000, "pool_batches": 6,
                                "sync_every": 4}},
    "xlarge.tsv": {"cell": {"batch": 128, "vocab_cap": 1000, "sync_every": 4,
                            "tsv": {"shards": 2, "rows_per_shard": 256, "missing_rate": 0.15,
                                    "short_rate": 0.02}}},
    "supernet.search": {"cell": {"batch": 64, "test_batch": 128, "eval_chunk": 64, "group": 2,
                                 "max_train_steps": 3, "max_eval_steps": 2, "train_batches": 2,
                                 "vocab_cap": 1000, "warmup_steps": 1},
                        "config": {"num_blocks": 2}},
}


def tiny_run(cell, faults=None, seed=4294967311):
    over = {k: dict(v) for k, v in TINY[cell].items()}
    over["faults"] = faults or {}
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                             "--trace", "0"], device="cpu", overrides=over)
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    lines = err.getvalue().strip().splitlines()
    assert lines[-1].startswith("check ") and list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    result = tiny_run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("cell,fault", [
    ("xlarge.uniform", {"step": "state_unchanged"}),
    ("xlarge.uniform", {"step": "half_batch"}),
    ("xlarge.tsv", {"step": "half_batch"}),
    ("supernet.search", {"answer": "altered"}),
    ("supernet.search", {"step": "state_unchanged"}),
    ("supernet.search", {"step": "half_batch"}),
])
def test_broken_path_is_not_correct(cell, fault):
    result = tiny_run(cell, fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_no_card_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("cell", ["xlarge.uniform", "supernet.search"])
def test_bf16_control_fails(cell):
    import control

    over = {k: dict(v) for k, v in TINY[cell].items()}
    rows = control.main(["--workload", cell, "--seeds", "5", "6", "--precision", "bf16"],
                        device="cpu", overrides=over)
    assert rows and not any(r["passes_limits"] for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["xlarge.uniform", "xlarge.tsv", "supernet.search"])
def test_tf32_control_fails_on_the_card(card, cell):
    import control

    rows = control.main(["--workload", cell, "--seeds", "5", "6", "7", "--precision", "tf32"],
                        device="cuda")
    assert not any(r["passes_limits"] for r in rows)


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "xlarge.uniform",
                        "--seed", "4294967311", "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
