"""Sharded training over the (data, model) mesh: placing a state on the mesh,
the dense-gradient mesh step and the mesh's eval step (port of
`nasrec_tpu/parallel/train.py`).

Layout, as in the JAX package:
  - embedding table: row-sharded over the model ranks (parallel/embedding.py),
    padded to a multiple of the model size; its optimizer slots likewise;
  - every other parameter: replicated;
  - batch: split over the data ranks (each rank feeds the rows of its data
    index; the ranks of one data row feed the same rows).

The loss is the mean over the global batch.  A rank's loss is the mean over
its own rows, so every gradient (the table shard's too, which the ranks of
one model column hold alike) is averaged over the data ranks, and the
reported loss is the data ranks' mean.  The global-norm clip sums the table
shards' squared norms over the model ranks and counts the replicated
parameters once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from nasrec_tpu_torch.parallel.embedding import (
    make_sharded_stem_lookup,
    pad_table_for_sharding,
    shard_rows,
)
from nasrec_tpu_torch.parallel.mesh import Mesh
from nasrec_tpu_torch.train.loop import TABLE, TrainState, forward_embedded, make_train_step
from nasrec_tpu_torch.train.optim import Optimizer, slot_dicts


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place a whole state on the mesh, in place: the table and each of its
    optimizer slots padded and cut to this rank's rows; the rest as it is."""
    emb = state.model.embedding
    emb.table = nn.Parameter(shard_rows(pad_table_for_sharding(emb.table.data, mesh.model),
                                        mesh), requires_grad=False)
    for slots in slot_dicts(state.opt_state):
        slots[TABLE] = shard_rows(pad_table_for_sharding(slots[TABLE], mesh.model), mesh)
    return state


def make_parallel_train_step(optimizer: Optimizer, lr_schedule: Callable[[int], float],
                             mesh: Mesh, **kw):
    """The dense-gradient step of train/loop.py (SGD, Adam, Adagrad with
    wd > 0) over the mesh, on a state placed by `shard_train_state`: the JAX
    package's name for `make_train_step(..., mesh=mesh)`."""
    return make_train_step(optimizer, lr_schedule, mesh=mesh, **kw)


def make_sharded_eval_step(mesh: Mesh, impl: str = "auto", has_masks: bool = False,
                           compute_dtype: torch.dtype = torch.float32) -> Callable:
    """eval_step(model, dense, cat[, masks]) -> this rank's float32 logits,
    the stem looked up through the table shards."""

    lookup = make_sharded_stem_lookup(mesh)

    @torch.no_grad()
    def eval_step(model, dense, cat, masks=None):
        return forward_embedded(model, dense, lookup(model, cat), masks, impl, compute_dtype,
                                has_masks)

    return eval_step
