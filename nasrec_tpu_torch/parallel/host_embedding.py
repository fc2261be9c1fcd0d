"""Host-offloaded embedding training (port of
`nasrec_tpu/parallel/host_embedding.py`; the reference's
place_embedding_on_cpu, ref: nasrec/supernet/supernet.py:253-254, :826-840,
"expect 10~100x slow down").

The fused table and its Adagrad accumulator live in host RAM as numpy arrays.
A step looks the batch's rows up on the host, copies the stem [B, S, E] to the
device, runs the model's forward and backward there through the kernels and
copies the stem's gradient back; the host then sums duplicate rows'
gradients (before squaring, as torch's dense Adagrad sees them) and updates
the touched rows.  Only 2 * B * S * E floats cross the bus a step; the table
never moves.

Global-norm clip: the device computes the squared norm of the other
parameters' gradients, the host that of the summed row gradients; one scale
from both scales the device update and the host update alike, so offloaded
training matches on-device training.  L2 covers the device parameters only,
as the on-device sparse step's does.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from nasrec_tpu_torch.train.loop import TABLE, TrainState, forward_embedded, resolve_masks
from nasrec_tpu_torch.train.metrics import bce_with_logits
from nasrec_tpu_torch.train.optim import Optimizer, l2_penalty


class HostEmbedding:
    """Fused embedding table + Adagrad accumulator in host RAM."""

    def __init__(self, table: np.ndarray, offsets: np.ndarray, eps: float = 1e-2):
        self.table = np.asarray(table, np.float32).copy()
        self.acc = np.zeros_like(self.table)
        self.offsets = np.asarray(offsets, np.int32)
        self.eps = eps

    def lookup(self, cat_x: np.ndarray) -> np.ndarray:
        idx = np.asarray(cat_x) + self.offsets[None, :]
        return self.table[idx]  # [B, S, E]

    def grad_rows(self, cat_x: np.ndarray, stem_grad: np.ndarray):
        """Scatter-add the stem gradient into unique rows.
        Returns (unique_rows, row_grads, sq_norm)."""
        idx = (np.asarray(cat_x) + self.offsets[None, :]).ravel()
        g = np.asarray(stem_grad, np.float32).reshape(-1, self.table.shape[1])
        rows, inv = np.unique(idx, return_inverse=True)
        dense_g = np.zeros((len(rows), g.shape[1]), np.float32)
        np.add.at(dense_g, inv, g)
        return rows, dense_g, float(np.sum(dense_g.astype(np.float64) ** 2))

    def apply_grad(self, rows: np.ndarray, row_grads: np.ndarray, lr: float,
                   scale: float = 1.0) -> None:
        g = row_grads * scale
        self.acc[rows] += g * g
        self.table[rows] -= lr * g / (np.sqrt(self.acc[rows]) + self.eps)


def detach_table(model: torch.nn.Module) -> np.ndarray:
    """Move the model's table to host RAM: returns it as numpy and leaves an
    empty [0, E] table on the device in its place."""
    emb = model.embedding
    table = emb.table.detach().cpu().numpy().copy()
    emb.table = torch.nn.Parameter(emb.table.new_empty((0, table.shape[1])),
                                   requires_grad=False)
    return table


def make_host_offload_train_step(
    optimizer: Optimizer,
    lr_schedule: Callable[[int], float],
    host_emb: HostEmbedding,
    *,
    grad_clip: Optional[float] = 5.0,
    l2_reg: float = 0.0,
    l2_exclude: Optional[str] = None,
    impl: str = "auto",
    has_masks: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    timings: Optional[dict] = None,
):
    """step(state, dense, cat, y[, masks]) -> (state, metrics), advancing the
    device parameters in place and the host table.  `state.model` has its
    table in `host_emb` (`detach_table`); `state.opt_state` covers the device
    parameters (its slot for the empty table is not touched).  The host table
    is trained with Adagrad whatever `optimizer` is, so callers refuse other
    optimizers (as the JAX package's workloads do).

    With a `timings` dict, each step adds its seconds to "lookup" (host
    gather), "to_device", "device" (forward and backward), "to_host" and
    "update" (host segment-sum and update, with the device update), which
    synchronises the card between the parts."""

    def now():
        if timings is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter()

    def mark(key, t0):
        """Add the seconds since t0 to timings[key]; returns the time now."""
        if timings is None:
            return t0
        t = now()
        timings[key] = timings.get(key, 0.0) + t - t0
        return t

    def step(state: TrainState, dense, cat, y, masks=None):
        masks = resolve_masks(masks, has_masks)
        model = state.model
        named = [(n, p) for n, p in model.named_parameters() if n != TABLE]
        t0 = now()
        cat_np = cat.cpu().numpy()
        looked = torch.from_numpy(host_emb.lookup(cat_np))
        t0 = mark("lookup", t0)
        stem = looked.to(dense.device).reshape(cat_np.shape[0], -1).requires_grad_(True)
        t0 = mark("to_device", t0)
        logits = forward_embedded(model, dense, stem, masks, impl, compute_dtype, has_masks)
        bce = bce_with_logits(logits, y)
        l2 = l2_penalty(named, l2_reg, l2_exclude)
        grads = torch.autograd.grad(bce + l2, [p for _, p in named] + [stem],
                                    allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            g_rest, g_stem = list(grads[:-1]), grads[-1]
            sq_dense = float(torch.stack([torch.sum(torch.square(g)) for g in g_rest]).sum())
            t0 = mark("device", t0)
            g_host = g_stem.cpu().numpy()
            t0 = mark("to_host", t0)
            rows, row_grads, sq_emb = host_emb.grad_rows(cat_np, g_host)
            if grad_clip is not None:
                total_norm = float(np.sqrt(sq_dense + sq_emb))
                scale = min(1.0, grad_clip / (total_norm + 1e-6))
            else:
                scale = 1.0
            lr = float(lr_schedule(state.step))
            scale_f32 = float(np.float32(scale))
            optimizer.update_(state.opt_state, [n for n, _ in named], [p for _, p in named],
                              [g * scale_f32 for g in g_rest], lr, impl=impl)
            host_emb.apply_grad(rows, row_grads, lr, scale)
            mark("update", t0)
        state.step += 1
        return state, {"loss": bce.detach(), "l2": l2.detach(), "lr": lr,
                       "logits": logits.detach()}

    return step


def make_host_offload_eval_step(host_emb: HostEmbedding, impl: str = "auto",
                                has_masks: bool = False,
                                compute_dtype: torch.dtype = torch.float32) -> Callable:
    """eval_step(model, dense, cat[, masks]): the host lookup feeds the
    device forward."""

    @torch.no_grad()
    def eval_step(model, dense, cat, masks=None):
        stem = torch.from_numpy(host_emb.lookup(cat.cpu().numpy())).to(dense.device)
        return forward_embedded(model, dense, stem.reshape(stem.shape[0], -1), masks, impl,
                                compute_dtype, has_masks)

    return eval_step
