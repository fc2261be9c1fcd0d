"""Multi-process utilities: torch.distributed bring-up, gathers to the host and
sharded checkpoints (port of `nasrec_tpu/parallel/distributed.py`).

  - `initialize()` brings up torch.distributed for more than one process
    (NCCL for the card, gloo for the CPU) and is a no-op otherwise; `start()`
    is the same bring-up for any world size, one included.  Every process
    also gets a gloo group over all ranks (`host_group()`), which carries
    host (numpy) exchanges such as the search's fan-out even when training
    runs NCCL: it lets several processes share one card.  `shutdown()` takes
    every group down again, joining gloo's threads before the interpreter
    finalizes (the CLIs call it through `cli.common.distributed_run`).
  - A process on a machine with several cards uses card `rank % count`
    (`device.resolve_device`); on a one-card machine every rank uses card 0.
  - `fetch_array` / `fetch_pytree` all-gather a tensor split along its first
    axis over a group (a mesh's data ranks), so every rank gets the full value.
  - `save_sharded_checkpoint` / `load_sharded_checkpoint` write and read the
    JAX package's layout: `table-shard-{h}.pkl` per rank with `rows` in the
    global row numbering, and `replicated.pkl` from rank 0, so each package
    loads the other's files.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nasrec_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

# A gloo group over every rank for host-side exchanges (None: not brought up).
_HOST_GROUP = None
TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device: str | torch.device) -> str:
    """NCCL for the card, gloo for the CPU.  NCCL without a card raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card, and "
                               "torch.cuda.is_available() is False; pass --device cpu "
                               "for gloo on the CPU")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device!r}")


def start(init_method: str, world_size: int, rank: int,
          device: str | torch.device = "cuda") -> None:
    """init_process_group with the device's backend and an explicit address
    (`tcp://host:port` or `file://path`), world size and rank; then the gloo
    host group.  A second call with the same world size is a no-op."""
    global _HOST_GROUP
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"torch.distributed is up with {dist.get_world_size()} "
                               f"processes, not {world_size}")
        return
    if not 0 <= rank < world_size:
        raise ValueError(f"process_id {rank} is not in [0, {world_size})")
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=TIMEOUT))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str | torch.device = "cuda") -> None:
    """Bring up torch.distributed for a multi-process run (no-op for one
    process).  `coordinator_address` is process 0's host:port."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator_address or process_id is None:
        raise ValueError("a multi-process run needs --coordinator_address host:port "
                         "and --process_id on every process")
    start(f"tcp://{coordinator_address}", num_processes, process_id, device)


def shutdown(barrier: bool = False) -> None:
    """Tear down the process groups (a no-op when none is up).

    barrier=True first waits for every rank over the host group, so that
    rank 0, which serves the rendezvous store, takes it down only after every
    rank is done with it: the end of a run that succeeded.  A rank whose work
    raised passes False and does not wait, since the others may never come.

    A gloo group's worker threads drop each finished collective's tensors a
    moment after the caller sees it complete.  If that last drop comes after
    the interpreter has begun to finalize, the thread cannot take the GIL,
    is unwound by `pthread_exit` through a noexcept frame and the process
    dies of std::terminate ("terminate called without an active exception",
    SIGABRT).  A group's threads are joined when its last reference goes,
    which `destroy_process_group` drops here, so a caller must not keep a
    group (a Mesh) past this call."""
    global _HOST_GROUP
    group, _HOST_GROUP = _HOST_GROUP, None
    if not dist.is_initialized():
        return
    try:
        if barrier:
            dist.barrier(group=group)
    finally:
        del group       # a traceback of the barrier would keep this frame alive
        dist.destroy_process_group()


def host_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is up."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_group():
    """The gloo group over every rank (None when no process group is up)."""
    return _HOST_GROUP if dist.is_initialized() else None


def fetch_array(x, group=None) -> np.ndarray:
    """Tensor -> host numpy.  With a group, the tensor is this rank's slice
    along the first axis and the result is the all-gather of the slices in
    rank order, the same on every rank.  Collective: every rank of the group
    calls it in the same order."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    if group is None or not dist.is_initialized():
        return x.cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts).cpu().numpy()


def fetch_pytree(tree, group=None):
    """fetch_array over every tensor leaf of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: fetch_pytree(v, group) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):      # a NamedTuple
        return type(tree)(*(fetch_pytree(v, group) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_pytree(v, group) for v in tree)
    return fetch_array(tree, group)


def _local_rows(total_rows: int, num_hosts: int, host: int) -> Tuple[int, int]:
    """Row range of host `host`'s shard: equal parts, the last one also takes
    the rows that do not divide (JAX's loader reads any `rows` range)."""
    per = total_rows // num_hosts
    return host * per, total_rows if host == num_hosts - 1 else (host + 1) * per


def save_sharded_checkpoint(path_dir: str, state, mesh=None,
                            extra: Optional[Dict[str, Any]] = None) -> None:
    """Each rank writes its part of the table and its Adagrad accumulator in
    the global row numbering; rank 0 also writes the replicated rest.

    `state` is a sparse-step TrainState (Adagrad state, the table's slot its
    accumulator).  Under a mesh the table is row-sharded over the model ranks
    and is gathered first; the files hold the padded table as the state does."""
    from nasrec_tpu_torch.models.transplant import to_jax_opt_state, to_jax_params
    from nasrec_tpu_torch.train.loop import TABLE

    if not isinstance(state.opt_state, dict):
        raise TypeError("sharded checkpoints hold an Adagrad state (as in the JAX "
                        f"package), not {type(state.opt_state).__name__}")
    host, num_hosts = host_info()
    os.makedirs(path_dir, exist_ok=True)
    table = state.model.embedding.table.detach()
    acc = state.opt_state[TABLE]
    if mesh is not None:
        table, acc = mesh.gather_rows(table), mesh.gather_rows(acc)
    lo, hi = _local_rows(table.shape[0], num_hosts, host)
    save_checkpoint(os.path.join(path_dir, f"table-shard-{host}.pkl"),
                    {"rows": (lo, hi), "table": table[lo:hi], "acc": acc[lo:hi]})
    if host != 0:
        return
    params = to_jax_params(state.model)
    opt = to_jax_opt_state(state.model, state.opt_state)
    save_checkpoint(os.path.join(path_dir, "replicated.pkl"), {
        "params": {k: v for k, v in params.items() if k != "embedding"},
        "opt_state": {k: v for k, v in opt.items() if k != "embedding"},
        "step": int(state.step),
        "table_rows": int(table.shape[0]),
        "table_dim": int(table.shape[1]),
        "num_hosts": num_hosts,
        "extra": extra or {},
    })


def load_sharded_checkpoint(path_dir: str) -> Dict[str, Any]:
    """Reassemble the full state on the host: the JAX package's pytrees of
    numpy arrays, the table and its accumulator whole."""
    meta = load_checkpoint(os.path.join(path_dir, "replicated.pkl"))
    rows, dim = meta["table_rows"], meta["table_dim"]
    table = np.zeros((rows, dim), np.float32)
    acc = np.zeros((rows, dim), np.float32)
    for h in range(meta["num_hosts"]):
        shard = load_checkpoint(os.path.join(path_dir, f"table-shard-{h}.pkl"))
        lo, hi = shard["rows"]
        table[lo:hi] = shard["table"]
        acc[lo:hi] = shard["acc"]
    params = dict(meta["params"])
    params["embedding"] = {"table": table}
    opt = dict(meta["opt_state"])
    opt["embedding"] = {"table": acc}
    return {"params": params, "opt_state": opt, "step": meta["step"],
            "extra": meta["extra"]}
