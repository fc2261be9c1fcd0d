"""Touched-row table updates under the (data, model) mesh (port of
`nasrec_tpu/parallel/sparse.py :: make_parallel_sparse_train_step`): the
sparse step of train/sparse_embedding.py, given the mesh.

Data flow of a step, on every rank:
  1. forward: the sharded lookup (parallel/embedding.py) of this rank's rows;
  2. autograd w.r.t. the looked-up stem, not the table;
  3. the other parameters' gradients averaged over the data ranks; the stem
     gradient divided by the data size and, with the indices, all-gathered
     over the data ranks: the whole batch's rows and gradients;
  4. one duplicate-row segment-sum of the whole batch
     (`rowwise_segment_sum_slotwise`: duplicates summed before squaring), the
     clip from sum(g_rest^2) + sum(seg^2), the same on every rank;
  5. each model rank updates the rows it owns through the table-update
     kernel with `row_offset = shard * rows_local`: positions of other
     shards' rows are skipped, so the shards' results are the one-device
     update's rows.

The TPU's sweep-packed layout (`pack_table_for_mesh`, `sweep_rows_per_shard`,
`make_sharded_packed_stem_lookup`) exists for its lane tiling and is not
ported: the workloads' table_update "sweep" and "scatter" both run the
plain-layout kernel, as on one device.
"""

from __future__ import annotations

from typing import Callable

from nasrec_tpu_torch.parallel.mesh import Mesh
from nasrec_tpu_torch.train.sparse_embedding import make_sparse_embedding_train_step


def make_parallel_sparse_train_step(lr_schedule: Callable[[int], float], mesh: Mesh, **kw):
    """step(state, dense, cat, y[, masks]) -> (state, metrics), in place, on a
    sparse-step state placed by `parallel.train.shard_train_state`: the JAX
    package's name for `make_sparse_embedding_train_step(..., mesh=mesh)`,
    which takes the same keywords (`microbatch` included)."""
    return make_sparse_embedding_train_step(lr_schedule, mesh=mesh, **kw)
