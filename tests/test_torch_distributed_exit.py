"""Multi-process runs of the port's CLIs leave no process group up when they
end, whether their work returned or raised.

Each case starts two gloo rank processes on the CPU at once (this file run
as a script, one intra-op thread each, on a free localhost port); each rank
calls `cli.<name>.main` with --num_processes 2 at a few steps and small
batches.  After `main` returns, a rank prints whether torch.distributed is
still up, whether the host group is gone and which of its threads belong to
c10d or gloo.  A gloo worker thread that is still alive when the interpreter
finalizes may drop a collective's last tensor then, cannot take the GIL and
ends the process with std::terminate ("terminate called without an active
exception", SIGABRT): rare under load, so the tests look for its cause, the
live groups and threads, and not only for the abort.  The error case is a
refusal after bring-up (--mesh_model 3 under two processes): both ranks end
with Python's error status, not a signal, and do not wait for each other.

Run on the CPU:
  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_distributed_exit.py -q
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nasrec_tpu_torch.parallel import distributed
from nasrec_tpu_torch.tools.multihost_demo import child_env, exit_faults, free_port

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60
EXIT_MARK = "RANK_EXIT "
# Thread names of c10d and gloo (ProcessGroupGloo's workers, gloo's TCP
# loop, the TCPStore server, NCCL's watchdog and heartbeat).
GROUP_THREADS = ("pt_gloo", "gloo_", "pt_tcpstore", "pt_nccl")

SMALL = ["--data_source", "synthetic", "--max_eval_steps", "1", "--test_batch_size", "64"]
CASES = {
    "main_train": ("main_train", SMALL + [
        "--arch", "criteo-kaggle/autoctr", "--train_batch_size", "32",
        "--max_train_steps", "2", "--test_interval", "2", "--mesh_model", "2"]),
    "train_supernet": ("train_supernet", SMALL + [
        "--num_blocks", "2", "--train_batch_size", "32", "--max_train_steps", "2",
        "--test_interval", "2", "--mesh_model", "2"]),
    "eval_subnet_from_supernet": ("eval_subnet_from_supernet", SMALL + [
        "--num_blocks", "2", "--method", "random", "--budget", "2", "--group_size", "1",
        "--max_train_steps", "1", "--train_batch_size", "16"]),
    # make_mesh refuses a model size that does not divide the processes.
    "refusal_after_bring_up": ("main_train", SMALL + [
        "--arch", "criteo-kaggle/autoctr", "--train_batch_size", "32",
        "--max_train_steps", "2", "--mesh_model", "3"]),
}
REFUSAL = "2 processes not divisible by model=3"


def _group_threads():
    """Names of this process's threads that belong to c10d or gloo."""
    names = [Path(f"/proc/self/task/{t}/comm").read_text().strip()
             for t in os.listdir("/proc/self/task")]
    return sorted(n for n in names if n.startswith(GROUP_THREADS))


def _rank_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cli")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    args, cli_argv = ap.parse_known_args(argv)
    torch.set_num_threads(1)
    cli = importlib.import_module(f"nasrec_tpu_torch.cli.{args.cli}")
    cli.main(cli_argv + ["--device", "cpu", "--num_processes", "2",
                         "--process_id", str(args.rank),
                         "--coordinator_address", f"127.0.0.1:{args.port}"])
    print(EXIT_MARK + json.dumps({"initialized": torch.distributed.is_initialized(),
                                  "host_group_is_none": distributed.host_group() is None,
                                  "group_threads": _group_threads()}), flush=True)


@pytest.fixture(scope="module")
def runs():
    """Every case's two ranks, all started at once; {case: [(rc, output)]}."""
    env = child_env("cpu")
    procs = {}
    for case, (cli, argv) in CASES.items():
        port = free_port()
        procs[case] = [
            subprocess.Popen([sys.executable, __file__, "--cli", cli, "--rank", str(r),
                              "--port", str(port)] + argv,
                             env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]
    out = {}
    try:
        for case, pair in procs.items():
            outputs = [p.communicate(timeout=TIMEOUT_S)[0] for p in pair]
            out[case] = [(p.returncode, o) for p, o in zip(pair, outputs)]
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
    return out


@pytest.mark.parametrize("case", ["main_train", "train_supernet", "eval_subnet_from_supernet"])
def test_cli_leaves_no_process_group_up(runs, case):
    for rank, (rc, output) in enumerate(runs[case]):
        assert rc == 0, f"rank {rank} exited {rc}:\n{output}"
        assert not exit_faults(output), output
        lines = [ln for ln in output.splitlines() if ln.startswith(EXIT_MARK)]
        assert len(lines) == 1, output
        state = json.loads(lines[0][len(EXIT_MARK):])
        assert state == {"initialized": False, "host_group_is_none": True,
                         "group_threads": []}, (rank, state)


def test_a_refusal_after_bring_up_exits_with_status_1(runs):
    for rank, (rc, output) in enumerate(runs["refusal_after_bring_up"]):
        assert rc == 1, f"rank {rank} exited {rc} (a negative code is a signal):\n{output}"
        assert REFUSAL in output, output
        assert EXIT_MARK not in output, output
        assert not exit_faults(output), output


@pytest.mark.parametrize("barrier", [True, False])
def test_shutdown_joins_the_group_threads(tmp_path, barrier):
    """A group of one rank in this process: up, its gloo threads run; after
    shutdown, nothing is up and every thread of the group is joined.  A
    second shutdown is a no-op."""
    assert not torch.distributed.is_initialized()
    distributed.start(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        assert distributed.host_group() is not None
        assert distributed.fetch_array(torch.ones(3), distributed.host_group()).tolist() == [1, 1, 1]
        assert _group_threads()
    finally:
        distributed.shutdown(barrier=barrier)
    assert not torch.distributed.is_initialized() and distributed.host_group() is None
    assert _group_threads() == []
    distributed.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
