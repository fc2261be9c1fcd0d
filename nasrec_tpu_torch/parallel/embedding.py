"""Row-sharded embedding table over the mesh's model ranks (port of
`nasrec_tpu/parallel/embedding.py`).

The fused [total_vocab, E] table is padded to a multiple of the model size
and split into equal row ranges; model rank m holds rows
[m * rows_local, (m + 1) * rows_local).  A lookup is, on each rank:

    local   = idx - m * rows_local
    partial = table_local[clip(local)] * (0 <= local < rows_local)
    stem    = sum of partial over the model ranks

The sum's backward is the identity: every model rank computes the same loss
from the summed stem, as JAX's `psum` with a replicated output differentiates,
so each rank's table gradient is the scatter-add of the stem gradient into
the rows it owns and never leaves it.  (An all-reduce in the backward, as
`torch.distributed.nn.functional.all_reduce` has, would scale that gradient
by the model size.)
"""

from __future__ import annotations

import torch

from nasrec_tpu_torch.parallel.mesh import Mesh


def pad_table_for_sharding(table: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Pad the fused table's rows with zeros to a multiple of `num_shards`
    (padding rows are never indexed; they only make the shards even)."""
    pad = -table.shape[0] % num_shards
    if not pad:
        return table
    return torch.cat([table, table.new_zeros((pad,) + tuple(table.shape[1:]))])


def shard_rows(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the (padded) table, as a copy."""
    rows_local = table.shape[0] // mesh.model
    start = mesh.model_index * rows_local
    return table[start:start + rows_local].clone()


class _SumOverModel(torch.autograd.Function):
    """Forward: sum over the model ranks.  Backward: the identity."""

    @staticmethod
    def forward(ctx, partial, mesh):
        return mesh.sum_over_model_(partial.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sharded_lookup(table_local: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, S] fused-table rows -> the flat stem [B, S*E], from the row shards
    of every model rank.  Differentiable w.r.t. `table_local`.  With one
    model rank the shard is the whole table: a plain gather."""
    if mesh.model == 1:
        return table_local.index_select(0, idx.reshape(-1)).reshape(idx.shape[0], -1)
    rows_local = table_local.shape[0]
    local = idx.long() - mesh.model_index * rows_local
    owned = (local >= 0) & (local < rows_local)
    safe = local.clamp(0, rows_local - 1).reshape(-1)
    partial = table_local.index_select(0, safe) * owned.reshape(-1, 1).to(table_local.dtype)
    return _SumOverModel.apply(partial, mesh).reshape(idx.shape[0], -1)


def make_sharded_stem_lookup(mesh: Mesh):
    """lookup(model, cat) -> [B, S*E] through the model's table shard: the
    drop-in for the model's own dense gather under the mesh."""

    def lookup(model, cat: torch.Tensor) -> torch.Tensor:
        return sharded_lookup(model.embedding.table, model.embedding.fused_index(cat), mesh)

    return lookup
