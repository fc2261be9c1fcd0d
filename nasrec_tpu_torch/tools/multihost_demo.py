"""Two-process drive of the port's training CLI over the (data, model) mesh
(port of `nasrec_tpu/tools/multihost_demo.py`).

Two OS processes run `python -m nasrec_tpu_torch.cli.main_train
--num_processes 2 --process_id {0,1} --mesh_model 2 ...` (over gloo with
--device cpu, over NCCL on two cards with --device cuda; the table row-sharded over the two ranks, the batch whole on each), and
the printed train/test trajectory of process 0 must equal that of ONE process
without the mesh, to 1e-4 of the loss.  This runs the whole multi-process
stack across real process boundaries: torch.distributed bring-up from the CLI
flags, the mesh's process groups, per-rank batches
(workloads._globalize_iterators), the sharded lookup and the sparse mesh step
with its all-gathers, the gathered metrics, the end-of-run table gather and
the teardown: a process that exits non-zero or prints an EXIT_FAULTS text
fails the demo.

Run (spawns all the processes itself; the three run at once):
  python -m nasrec_tpu_torch.tools.multihost_demo --device cpu
(the default, --device cuda, needs two cards: NCCL puts one rank on a card)
Prints MULTIHOST_OK on success.
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys

STEPS = 12
CLI_ARGS = [
    "-m", "nasrec_tpu_torch.cli.main_train",
    "--net", "supernet-config", "--arch", "criteo-kaggle/xlarge",
    "--data_source", "synthetic",
    "--train_batch_size", "64", "--test_batch_size", "64",
    "--max_train_steps", str(STEPS), "--display_interval", "3",
    "--test_interval", "6", "--max_eval_steps", "2",
    "--learning_rate", "0.05",
]
REL_TOL = 1e-4
# What a process prints when it ends with a process group up: gloo's
# std::terminate at exit, or PyTorch's warning about a group it destructs.
EXIT_FAULTS = ("terminate called", "has NOT been destroyed")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(device: str) -> dict:
    """The parent's environment with the repo on the path; on the CPU one
    intra-op thread a process, so that the ranks do not contend."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


def exit_faults(out: str) -> list:
    """The EXIT_FAULTS texts in a process's output."""
    return [t for t in EXIT_FAULTS if t in out]


def losses(out: str):
    """(train losses, test losses) from a CLI's printed trajectory."""
    train = [float(m) for m in re.findall(r"step \d+ loss ([0-9.]+)", out)]
    test = [float(m) for m in re.findall(r"TEST .* loss ([0-9.]+)", out)]
    return train, test


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    env = child_env(args.device)
    base = [sys.executable] + CLI_ARGS + ["--device", args.device]
    dist = ["--num_processes", "2", "--coordinator_address", f"127.0.0.1:{free_port()}",
            "--mesh_model", "2"]
    popen = dict(env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = {
        "single": subprocess.Popen(base, **popen),
        "proc1": subprocess.Popen(base + dist + ["--process_id", "1"], **popen),
        "proc0": subprocess.Popen(base + dist + ["--process_id", "0"], **popen),
    }
    try:
        outs = {k: p.communicate(timeout=args.timeout)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    bad = {k: (p.returncode, exit_faults(outs[k])) for k, p in procs.items()
           if p.returncode != 0 or exit_faults(outs[k])}
    if bad:
        detail = "\n".join(f"--- {k} ---\n{outs[k]}" for k in outs)
        raise SystemExit(f"runs failed {bad}:\n{detail}")

    single_train, single_test = losses(outs["single"])
    multi_train, multi_test = losses(outs["proc0"])
    assert len(single_train) >= 3 and len(single_test) >= 2, (single_train, single_test)
    assert len(single_train) == len(multi_train), (single_train, multi_train)
    assert len(single_test) == len(multi_test), (single_test, multi_test)
    for a, b in zip(single_train + single_test, multi_train + multi_test):
        assert abs(a - b) <= REL_TOL * max(1.0, abs(a)), (
            (single_train, single_test), (multi_train, multi_test))
    print("MULTIHOST_OK train=" + repr([f"{x:.6f}" for x in multi_train])
          + " test=" + repr([f"{x:.6f}" for x in multi_test]), flush=True)


if __name__ == "__main__":
    main()
