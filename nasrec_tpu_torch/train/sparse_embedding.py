"""Sparse (touched-rows-only) embedding training step (port of
`nasrec_tpu/train/sparse_embedding.py`, with micro-batches).

The step differentiates w.r.t. the looked-up stem [B, S*E] instead of the
table, sums duplicate rows' gradients (sort + segment-sum), and
updates only the touched rows of the table and its Adagrad accumulator:

    rows, seg = aggregate(idx, d_stem)      # seg = per-unique-row summed grad
    acc'   = acc   + seg^2                  # duplicates summed BEFORE squaring
    table' = table - lr * seg / (sqrt(acc') + eps)

which is torch's dense Adagrad exactly, global-norm clip included (the
clip sees each row's summed gradient once).  On the card the update is the
hand-written kernel of ops/kernels/table_update.py.  The table is
[vocab, E] with E = 16 (NASRec's models) or 128 (DLRM-DCNv2's), the widths
the kernels are built for.

With multi-hot `bag_sizes` (models/dcn.py) the stem is the sum-pooled bags
[B, S*E] (`EmbeddingStem.pool`), and each lookup's gradient is its bag's
pooled gradient: the segment-sum reads it through the lookup-to-bag map,
over all B*H lookups of the step (`segment_sum_bags`).  One-hot (every bag
size 1, or none given) keeps the slotwise gather and segment-sum; which of
the two a step runs is decided when it is built.

With `has_masks=True` (the supernet) the step takes the choice's masks as a
`ChoiceMasks` of device tensors or as the `(buffer, idx)` pair that
`sampling.DeviceMaskBuffer` hands out, selected on the device.  `trainable`
(`train/loop.py :: freeze_mask`) trains a subset: a frozen parameter keeps
its value and accumulator, as the JAX step's zeroed gradient leaves them,
and a frozen table is neither differentiated nor updated.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.ops.kernels.dense_adagrad import clip_scale
from nasrec_tpu_torch.ops.kernels.segment_sum import segment_sum, segment_sum_bags
from nasrec_tpu_torch.ops.kernels.table_update import table_update
from nasrec_tpu_torch.parallel.embedding import sharded_lookup
from nasrec_tpu_torch.parallel.mesh import Mesh
from nasrec_tpu_torch.train.loop import (
    TABLE,
    TrainState,
    forward_embedded,
    init_train_state,
    resolve_masks,
)
from nasrec_tpu_torch.train.metrics import bce_with_logits
from nasrec_tpu_torch.train.optim import (
    Optimizer,
    l2_penalty,
    make_optimizer,
    slot_dicts,
)


def rowwise_segment_sum_slotwise(idx2d: torch.Tensor, g: torch.Tensor, impl: str = "auto"):
    """Sum the gradients of duplicate rows, for slot-partitioned indices.

    idx2d: [B, S] fused-table rows, column s confined to slot s's row range
    (disjoint and ascending with s), so sorting each column and concatenating
    the columns gives a globally sorted stream.  g: [B*S, E] in (b, s)
    row-major order.  Returns (rows [B*S] sorted, seg [B*S, E], is_end [B*S]):
    seg holds each row's full sum at its segment's LAST position and exact
    zeros elsewhere; is_end marks those positions.  The sort is a PyTorch op,
    as it is an XLA op outside Pallas in the JAX package; the sums are the
    kernel of ops/kernels/segment_sum.py on the card, and on the CPU (or with
    impl='plain') its plain version, the JAX package's cumsum composite.
    """
    return segment_sum(idx2d, g, impl)


def sparse_adagrad_table_update(table, acc, rows, seg, lr: float, eps: float = 1e-2,
                                row_offset: int = 0, impl: str = "auto", written=None):
    """Touched-row Adagrad on the [vocab, E] table (E = 16 or 128), in place
    (the kernel on the card; its plain version on the CPU or by name); the
    rows it writes are added to `written` where one is given."""
    return table_update(table, acc, rows.to(torch.int32).contiguous(),
                        seg.contiguous(), lr, eps, row_offset, impl, written)


def init_sparse_train_state(model: torch.nn.Module,
                            optimizer: Optional[Optimizer] = None) -> TrainState:
    """Zero optimizer state (Adagrad's unless `optimizer` says otherwise) for
    every parameter, the table's included.  The table's slot of the state's
    first slot dict (Adagrad's accumulators, SGD's momenta, Adam's mu) holds
    its Adagrad accumulator, which only the touched-row update reads and
    writes; its other slots stay zero."""
    return init_train_state(model, optimizer or make_optimizer("adagrad"))


def table_accumulator(opt_state) -> torch.Tensor:
    """The table's Adagrad accumulator inside a sparse step's optimizer state."""
    return slot_dicts(opt_state)[0][TABLE]


def make_sparse_embedding_train_step(
    lr_schedule: Callable[[int], float],
    *,
    optimizer: Optional[Optimizer] = None,
    grad_clip: Optional[float] = 5.0,
    adagrad_eps: float = 1e-2,
    l2_reg: float = 0.0,            # applied to non-embedding params only
    l2_exclude: Optional[str] = None,
    impl: str = "auto",
    has_masks: bool = False,
    trainable: Optional[Mapping[str, bool]] = None,
    microbatch: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    table_impl: Optional[str] = None,
    mesh: Optional[Mesh] = None,
    bag_sizes: Optional[Sequence[int]] = None,
):
    """step(state, dense, cat, y[, masks]) -> (state, metrics), updating in place.

    `state.model` is a FixedModel (or, with has_masks=True, a SuperNet that
    takes `masks`) whose `embedding.table` is trained here by the touched-row
    Adagrad update; every other parameter by `optimizer` (Adagrad by
    default), on the state of `init_sparse_train_state(model, optimizer)`.
    The global-norm clip takes all those parameters' gradients as one list
    (`ops/kernels/dense_adagrad.py :: clip_scale`) and hands its scale to the
    optimizer, which applies it inside the update (Adagrad's list kernel on
    the card) or to each gradient (SGD, Adam).
    A frozen parameter (`trainable`) keeps its value and its slots.
    impl='auto' runs the hand-written kernels on the card and their plain
    versions on the CPU; impl='plain' names the plain versions.  `table_impl`
    picks the segment-sum's and the table update's apart from the model's
    (None: `impl`).

    microbatch > 1 runs the forward and backward one slice of B/m rows at a
    time (one slice's activations in memory) and keeps the update math of
    the full batch: the other parameters' gradients are averaged before the
    clip, and the stem gradients of all slices are concatenated, so that
    duplicate rows are summed across the whole batch before squaring, in one
    segment-sum and one table update a step.  B must divide by m.

    `compute_dtype` is the activations' dtype (train/loop.py); the stem's
    gradient comes back through the model's cast as float32, so the
    segment-sum, the clip and the table update stay float32.

    With a `mesh` (parallel/mesh.py; the JAX package's
    `make_parallel_sparse_train_step`) the state is one placed by
    `parallel.train.shard_train_state` and B is this rank's rows.  The stem
    is looked up through the table shards (`parallel.embedding
    .sharded_lookup`); the other gradients are averaged over the data ranks;
    the stem gradients (divided by the data size: the loss is the global
    batch's mean) and the indices are all-gathered over the data ranks, so
    that one segment-sum and one clip see the whole batch, the same on every
    rank; and each model rank updates the rows it owns through the kernel's
    `row_offset`, skipping the other shards' positions.  Without one (or on
    a 1 x 1 mesh) every collective is the identity.

    `bag_sizes` (one a slot) are the model's multi-hot bags
    (`model.embedding.bag_sizes`; DLRM-DCNv2): `cat` is then [B, H] ids,
    the stem the pooled bags, and the segment-sum runs over the B*H lookups.
    Bags run on one device only: a mesh of more than one rank raises."""
    optimizer = optimizer or make_optimizer("adagrad")
    table_impl = impl if table_impl is None else table_impl
    mesh = mesh or Mesh(1, 1)
    bags = tuple(int(h) for h in bag_sizes) if bag_sizes is not None else None
    bagged = bags is not None and any(h != 1 for h in bags)
    if bagged and mesh.data * mesh.model > 1:
        raise ValueError(f"multi-hot bags run on one device; got a {mesh.data} x "
                         f"{mesh.model} mesh (row-sharding bags over ranks is not ported)")

    def step(state: TrainState, dense, cat, y, masks=None):
        with tracing.span("train.step"):
            return _step(state, dense, cat, y, masks)

    def _step(state: TrainState, dense, cat, y, masks):
        masks = resolve_masks(masks, has_masks)
        model = state.model
        table = model.embedding.table
        named = [(n, p) for n, p in model.named_parameters() if n != TABLE]
        rest = [(n, p) for n, p in named if trainable is None or trainable[n]]
        train_table = trainable is None or trainable[TABLE]
        idx = model.embedding.fused_index(cat)                       # [B, S] int32
        b = idx.shape[0]
        if bagged and model.embedding.bag_sizes != bags:
            raise ValueError(f"the step was built for bags {bags}, the model has "
                             f"{model.embedding.bag_sizes}")
        if b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch {microbatch}")
        rows_per = b // microbatch

        def forward_backward(sl):
            with torch.no_grad():
                if bagged:
                    with tracing.span("train.lookup", device=True):
                        tracing.count("train.bag_positions", idx[sl].numel())
                        looked = model.embedding.pool(table, idx[sl])    # [b, S*E]
                else:
                    looked = sharded_lookup(table, idx[sl], mesh)        # [b, S*E]
            stem = looked.requires_grad_(train_table)
            logits = forward_embedded(model, dense[sl], stem, masks, impl, compute_dtype,
                                      has_masks)
            bce = bce_with_logits(logits, y[sl])
            l2 = l2_penalty(named, l2_reg, l2_exclude)
            # A block whose outputs no later block reads leaves its parameters
            # out of the graph: their gradient is zero, as in the JAX step.
            wrt = [p for _, p in rest] + ([stem] if train_table else [])
            grads = torch.autograd.grad(bce + l2, wrt, allow_unused=True,
                                        materialize_grads=True)
            return bce.detach(), l2.detach(), logits.detach(), grads

        with tracing.span("train.forward_backward"):
            slices = [forward_backward(slice(i * rows_per, (i + 1) * rows_per))
                      for i in range(microbatch)]
            with torch.no_grad():
                n_rest = len(rest)
                if microbatch == 1:
                    bce, l2, logits, grads = slices[0]
                    g_rest, d_stem = grads[:n_rest], grads[n_rest:]
                else:
                    inv_m = 1.0 / microbatch
                    bce = torch.stack([x[0] for x in slices]).mean()
                    l2 = slices[0][1]
                    logits = torch.cat([x[2] for x in slices])
                    g_rest = [g.clone() for g in slices[0][3][:n_rest]]
                    for *_, more in slices[1:]:
                        for acc, g in zip(g_rest, more[:n_rest]):
                            acc.add_(g)
                    g_rest = [g * inv_m for g in g_rest]
                    # Slices stack in the full batch's row order, as idx does.
                    d_stem = ([torch.cat([x[3][n_rest] for x in slices]) * inv_m]
                              if train_table else [])
                mesh.mean_over_data_(g_rest)
        with torch.no_grad():
            if train_table:
                with tracing.span("train.segment_sum", device=True):
                    d_all = d_stem[0]
                    if mesh.data > 1:
                        d_all = mesh.gather_over_data(d_all / mesh.data)
                    if bagged:
                        rows, seg, _ = segment_sum_bags(
                            idx.reshape(-1), model.embedding.bag_index(b),
                            d_all.reshape(-1, table.shape[1]), table_impl)
                    else:
                        rows, seg, _ = rowwise_segment_sum_slotwise(
                            mesh.gather_over_data(idx), d_all.reshape(-1, table.shape[1]),
                            table_impl)
            scale = None
            if grad_clip is not None:
                with tracing.span("train.clip"):
                    # sum(seg^2) is the dense table gradient's squared norm:
                    # seg holds each vocab row's summed gradient once.
                    scale = clip_scale(g_rest, grad_clip, seg if train_table else None, impl)
                    if train_table:
                        seg = seg * scale
            with tracing.span("train.dense_update"):
                lr = float(lr_schedule(state.step))
                optimizer.update_(state.opt_state, [n for n, _ in rest],
                                  [p for _, p in rest], g_rest, lr, scale, impl)
            if train_table:
                with tracing.span("train.table_update", device=True):
                    # On the bag path, while a profiler runs, the update counts
                    # the rows it writes: it skips a row whose summed gradient
                    # is zero.
                    written = (tracing.device_counter("train.rows_updated", table.device)
                               if bagged else None)
                    sparse_adagrad_table_update(table.data, table_accumulator(state.opt_state),
                                                rows, seg, lr, adagrad_eps,
                                                row_offset=mesh.model_index * table.shape[0],
                                                impl=table_impl, written=written)
            if mesh.data > 1:
                bce = bce.clone()
                mesh.mean_over_data_([bce])
        state.step += 1
        metrics = {"loss": bce, "l2": l2, "lr": lr, "logits": logits}
        return state, metrics

    return step
