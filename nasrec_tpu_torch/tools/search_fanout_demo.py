"""Cross-process fan-out of the search: the port's search CLI under two
processes against one (port of `nasrec_tpu/tools/search_fanout_demo.py`).

Runs `python -m nasrec_tpu_torch.cli.eval_subnet_from_supernet
--num_processes 2 --process_id {0,1}` and asserts that the search history
(results.pickle and all_results.pickle, written by process 0) equals a
one-process run of the same configuration: the same architectures in the
same order (every sampling, mutation, dedup and aging decision), metrics
within 1e-5 relative.  Candidate groups go round-robin to the ranks
(search/evolution.py :: Searcher._evaluate_distributed) and the metrics come
back over gloo, so the two processes may share one card (--device cuda, the
default).  A process that exits non-zero or prints an EXIT_FAULTS text
(tools/multihost_demo.py) fails the demo.

Run (spawns the processes itself):
  python -m nasrec_tpu_torch.tools.search_fanout_demo                 # on the card
  python -m nasrec_tpu_torch.tools.search_fanout_demo --device cpu    # on the CPU
Prints SEARCH_FANOUT_OK on success.
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

from nasrec_tpu_torch.tools.multihost_demo import child_env, exit_faults, free_port

CLI = [
    "-m", "nasrec_tpu_torch.cli.eval_subnet_from_supernet",
    "--data_source", "synthetic", "--config", "autoctr", "--num_blocks", "3",
    "--method", "regularized-ea",
    "--n_generations", "3", "--n_childs", "2", "--init_population", "6",
    "--sample_size", "2", "--ea_top_k", "1", "--group_size", "2",
    "--max_train_steps", "6", "--max_eval_steps", "2",
    "--train_batch_size", "64", "--test_batch_size", "128",
    "--seed", "3",
]
REL_TOL = 1e-5


def search_seconds(out: str) -> float:
    """The seconds a process spent evaluating candidates, from the search's
    "evaluated N candidates in Xs" lines (process start-up, the checkpoint's
    load and the exchange's waits left out)."""
    return sum(float(x) for x in re.findall(r"evaluated \d+ candidates in ([0-9.]+)s", out))


def run_single(cli, out_dir: str, device: str, timeout: float):
    """One process of the CLI; returns (wall seconds, [its output])."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable] + cli + ["--device", device, "--logging_dir", out_dir],
                          env=child_env(device), capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0 or exit_faults(proc.stdout + proc.stderr):
        raise SystemExit(f"single run failed:\n{proc.stdout}\n{proc.stderr}")
    return time.perf_counter() - t0, [proc.stdout]


def run_pair(cli, out_dir: str, device: str, timeout: float):
    """Two processes of the CLI on one rendezvous; returns (wall seconds,
    [each process's output])."""
    dist = ["--num_processes", "2", "--coordinator_address", f"127.0.0.1:{free_port()}",
            "--device", device, "--logging_dir", out_dir]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable] + cli + dist + ["--process_id", str(i)],
                              env=child_env(device), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in (0, 1)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode != 0 or exit_faults(o) for p, o in zip(procs, outs)):
        raise SystemExit("fan-out pair failed:\n" + "\n---\n".join(outs))
    return time.perf_counter() - t0, outs


def history(out_dir: str):
    with open(os.path.join(out_dir, "results.pickle"), "rb") as f:
        results = pickle.load(f)
    with open(os.path.join(out_dir, "all_results.pickle"), "rb") as f:
        all_results = pickle.load(f)
    return results, all_results


def compare(d_single: str, d_multi: str, rel_tol: float = REL_TOL) -> int:
    """Assert the two runs' histories agree; returns the candidate count."""
    res_s, all_s = history(d_single)
    res_m, all_m = history(d_multi)
    assert len(all_s) == len(all_m) and len(all_s) > 0, (len(all_s), len(all_m))
    assert len(res_s) == len(res_m), (len(res_s), len(res_m))
    for a, b in zip(all_s + res_s, all_m + res_m):
        assert a["choice"] == b["choice"], (a["choice"], b["choice"])
        for f in ("test_loss", "test_acc", "test_auroc"):
            assert abs(a[f] - b[f]) <= rel_tol * max(1.0, abs(a[f])), (f, a[f], b[f])
    return len(all_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    base = tempfile.mkdtemp(prefix="nasrec_fanout_")
    d_single, d_multi = os.path.join(base, "single"), os.path.join(base, "multi")
    try:
        single_s, _ = run_single(CLI, d_single, args.device, args.timeout)
        pair_s, _ = run_pair(CLI, d_multi, args.device, args.timeout)
        n = compare(d_single, d_multi)
        res_s, _ = history(d_single)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"SEARCH_FANOUT_OK candidates={n} best={res_s[0]['test_loss']:.6f} "
          f"seconds_single={single_s:.2f} seconds_pair={pair_s:.2f}", flush=True)


if __name__ == "__main__":
    main()
