"""The (data, model) process mesh (port of `nasrec_tpu/parallel/mesh.py`).

One process drives one device, so the mesh is laid over the ranks: rank r
sits at (data = r // model, model = r % model), the row-major
`reshape(data, model)` of the JAX package's `make_mesh`.  The batch is split
over `data` and the fused table's rows over `model`.  Each rank belongs to two
process groups: the ranks of its data row (the `model` axis, over which the
sharded lookup sums) and the ranks of its model column (the `data` axis, over
which gradients are averaged and the batch gathered).  Without a process
group (one process, nothing brought up) the mesh is 1 x 1 and every
collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nasrec_tpu_torch.parallel.distributed import fetch_array


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    rank: int = 0
    model_group: Any = None     # this rank's data row: the "model" axis
    data_group: Any = None      # this rank's model column: the "data" axis

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def sum_over_model_(self, t: torch.Tensor) -> torch.Tensor:
        if self.model_group is not None:
            dist.all_reduce(t, group=self.model_group)
        return t

    def sum_over_data_(self, t: torch.Tensor) -> torch.Tensor:
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
        return t

    def mean_over_data_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average same-dtype tensors over the data ranks, in place, in one
        all-reduce of a flat buffer."""
        if self.data_group is None or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        flat.div_(self.data)
        start = 0
        for t in tensors:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()

    def gather_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate each data rank's t along the first axis, in data order."""
        return self._gather(t, self.data_group, self.data)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole table (padded) from each model rank's row shard."""
        return self._gather(t, self.model_group, self.model)

    @staticmethod
    def _gather(t, group, n):
        if group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    def fetch(self, x) -> np.ndarray:
        """Host numpy of a batch-split tensor, gathered over the data ranks."""
        return fetch_array(x, self.data_group)


def _groups(members: List[List[int]], rank: int):
    """One process group per member list (every rank creates every group, in
    the same order); returns this rank's."""
    mine = None
    for ranks in members:
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(model: int = 1, data: Optional[int] = None) -> Mesh:
    """Mesh with axes (data, model) over every rank; data fills the rest.
    Collective when a process group is up: every rank calls it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or n % model != 0:
        raise ValueError(f"{n} processes not divisible by model={model}")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data * model} != {n} processes")
    if not dist.is_initialized():
        return Mesh(data, model)
    grid = np.arange(n).reshape(data, model)
    rows = [list(map(int, r)) for r in grid]
    cols = [list(map(int, c)) for c in grid.T]
    return Mesh(data, model, rank, _groups(rows, rank), _groups(cols, rank))
