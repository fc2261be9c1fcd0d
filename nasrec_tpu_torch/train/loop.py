"""Train/eval loops and the dense-gradient train step (port of
`nasrec_tpu/train/loop.py`).

Reference hot loop: nasrec/utils/train_utils.py:181-390.  Metrics are read
back to the host only on display and test boundaries, so the card keeps
working while the host prepares the next batch.  A NaN loss returns the
reference's sentinel logs (loss 999.99 / AUROC -1, ref: train_utils.py:294-301).
In supernet mode a `sampler` gives every train step its masks, and
`eval_masks` (masks, or a callable sampled once per eval batch) the eval.
`freeze_mask` selects the trainable parameters of the search's fine-tune
modes.  `make_train_step` is the step every optimizer runs (SGD, Adam, or
Adagrad with wd > 0): autograd through the whole model, the table included,
whose gradient is dense; the sparse-embedding step
(train/sparse_embedding.py) is the Adagrad, wd = 0 special case.  Both steps
and the eval step take `compute_dtype`, the activations' dtype (float32 or
bfloat16, the JAX package's rule: ops/common.py); the parameters, gradients,
optimizer state, loss and metrics stay float32, and there is no loss scaling.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from nasrec_tpu_torch.parallel.embedding import sharded_lookup
from nasrec_tpu_torch.parallel.mesh import Mesh
from nasrec_tpu_torch.train.metrics import auc_exact, bce_with_logits, binary_accuracy, stable_sigmoid
from nasrec_tpu_torch.train.optim import Optimizer, global_norm_scale, l2_penalty

TABLE = "embedding.table"


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer state
    keyed by parameter name (train/optim.py), and the host step counter."""

    model: torch.nn.Module
    opt_state: Any
    step: int = 0


def init_train_state(model: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    """Zero optimizer state for every parameter, the table's included."""
    return TrainState(model, optimizer.init(model.named_parameters()), 0)


FREEZE_MODES = ("normal", "final-only", "no-embedding", "layernorm-calibrate")


def freeze_mask(model: torch.nn.Module, mode: str) -> Dict[str, bool]:
    """Parameter name -> trainable, for the reference's fine-tune switches
    (ref: nasrec/supernet/supernet.py:850-873; `nasrec_tpu/train/loop.py ::
    freeze_mask_bools`):

      normal               everything trainable
      final-only           only the final linear ("finetune last only")
      no-embedding         everything but the embedding table
      layernorm-calibrate  only LayerNorm scales and biases inside blocks

    The rule is the JAX package's, on the port's names (which mirror its
    pytree): a LayerNorm parameter is one held by a module named `ln` or
    ending in `_ln`, so `blocks.0.nodes.5.attn_ln.weight` is one and
    `final.weight` is not."""
    if mode not in FREEZE_MODES:
        raise ValueError(f"unknown freeze mode {mode}")

    def decide(name: str) -> bool:
        keys = name.split(".")
        if mode == "normal":
            return True
        if mode == "final-only":
            return keys[0] == "final"
        if mode == "no-embedding":
            return keys[0] != "embedding"
        return keys[0] == "blocks" and any(k == "ln" or k.endswith("_ln") for k in keys[:-1])

    return {name: decide(name) for name, _ in model.named_parameters()}


def resolve_masks(masks, has_masks: bool):
    """A step's masks as the model takes them: a `ChoiceMasks`, or the
    `(buffer, idx)` pair of a DeviceMaskBuffer selected on the device."""
    if has_masks and masks is None:
        raise ValueError("this step was made with has_masks=True: pass masks")
    if isinstance(masks, tuple):      # (device mask buffer, index)
        buffer, buf_idx = masks
        return buffer.select(buf_idx)
    return masks


def forward_embedded(model, dense, stem, masks, impl, compute_dtype, has_masks: bool):
    """The model's forward from a looked-up stem, with masks for a supernet."""
    if has_masks:
        return model.forward_embedded(dense, stem, masks, impl, compute_dtype)
    return model.forward_embedded(dense, stem, impl, compute_dtype)


def make_train_step(
    optimizer: Optimizer,
    lr_schedule: Callable[[int], float],
    *,
    l2_reg: float = 0.0,
    l2_exclude: Optional[str] = None,
    grad_clip: Optional[float] = 5.0,
    impl: str = "auto",
    has_masks: bool = False,
    trainable: Optional[Mapping[str, bool]] = None,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional[Mesh] = None,
):
    """step(state, dense, cat, y[, masks]) -> (state, metrics), updating in
    place: BCE plus `l2_reg` times the squared norm of every parameter with
    ndim >= 2, the table included (`l2_exclude` leaves out names that start
    with it); gradients of the frozen parameters (`trainable`, from
    `freeze_mask`) zeroed; the global-norm clip; `optimizer.update_` on every
    parameter.  As in the JAX step, a frozen parameter still goes through the
    update with a zero gradient (it moves only where its SGD momentum or Adam
    moments are nonzero).

    The table's gradient is dense [vocab, 16]: the lookup's backward
    (index_select -> index_add_) plus the L2 term.  `masks` as in the sparse
    step: a `ChoiceMasks` or the `(buffer, idx)` pair of a DeviceMaskBuffer.
    impl='auto' runs the hand-written kernels on the card and their plain
    versions on the CPU; impl='plain' names the plain versions.

    With a `mesh` (parallel/mesh.py) the state is one placed by
    `parallel.train.shard_train_state`: the table is this rank's row shard,
    looked up through `parallel.embedding.sharded_lookup`, and its gradient
    stays local.  Every gradient is averaged over the data ranks (the loss is
    the global batch's mean), the clip sums the table shards' squared norms
    over the model ranks and counts the replicated parameters once, and the
    reported loss and L2 are the global ones.  Without one (or on a 1 x 1
    mesh) every collective is the identity."""
    mesh = mesh or Mesh(1, 1)

    def step(state: TrainState, dense, cat, y, masks=None):
        masks = resolve_masks(masks, has_masks)
        model = state.model
        named = list(model.named_parameters())
        # The table's Parameter is not differentiated by the sparse step; here
        # a leaf that shares its storage takes its place in the graph.
        table = model.embedding.table.detach().requires_grad_(
            trainable is None or trainable[TABLE])
        leaves = [(n, table if n == TABLE else p) for n, p in named]
        stem = sharded_lookup(table, model.embedding.fused_index(cat), mesh)
        logits = forward_embedded(model, dense, stem, masks, impl, compute_dtype, has_masks)
        bce = bce_with_logits(logits, y)
        # The table's L2 term apart: under a mesh each rank holds a shard.
        l2_rest = l2_penalty([(n, p) for n, p in leaves if n != TABLE], l2_reg, l2_exclude)
        l2_table = l2_penalty([(TABLE, table)], l2_reg, l2_exclude)
        live = [i for i, (n, _) in enumerate(leaves) if trainable is None or trainable[n]]
        # A block whose outputs no later block reads leaves its parameters out
        # of the graph: their gradient is zero, as in the JAX step.
        got = torch.autograd.grad(bce + l2_rest + l2_table, [leaves[i][1] for i in live],
                                  allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            grads = dict(zip(live, got))
            grads = [grads[i] if i in grads else torch.zeros_like(p)
                     for i, (_, p) in enumerate(leaves)]
            mesh.mean_over_data_(grads)
            scale = None
            if grad_clip is not None:
                ti = [n for n, _ in leaves].index(TABLE)
                sq_rest = torch.stack([torch.sum(torch.square(g))
                                       for i, g in enumerate(grads) if i != ti]).sum()
                sq_table = mesh.sum_over_model_(torch.sum(torch.square(grads[ti])).reshape(1))
                scale = global_norm_scale(sq_rest + sq_table[0], grad_clip)
            lr = float(lr_schedule(state.step))
            optimizer.update_(state.opt_state, [n for n, _ in named],
                              [p for _, p in named], grads, lr, scale, impl)
            loss = bce.detach().clone()
            mesh.mean_over_data_([loss])
            l2 = l2_rest.detach() + mesh.sum_over_model_(l2_table.detach().reshape(1).clone())[0]
        state.step += 1
        metrics = {"loss": loss, "l2": l2, "lr": lr, "logits": logits.detach()}
        return state, metrics

    return step


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor (logits of any float dtype, labels) as float32 host numpy."""
    return t.detach().float().cpu().numpy()


def snapshot_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Host copy of the parameters (best-model keep)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def make_eval_step(impl: str = "auto", has_masks: bool = False,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """eval_step(model, dense, cat[, masks]) -> float32 logits, without autograd."""

    @torch.no_grad()
    def eval_step(model, dense, cat, masks=None):
        if has_masks:
            return model(dense, cat, masks, impl, compute_dtype)
        return model(dense, cat, impl, compute_dtype)

    return eval_step


def evaluate_one_epoch(
    eval_step,
    model,
    test_iter: Iterable,
    *,
    masks=None,
    max_steps: int = -1,
    fetch: Optional[Callable] = None,
) -> Tuple[float, float, float]:
    """Full-split eval -> (accuracy, auroc, logloss) (ref: train_utils.py:129-178).
    `masks`: None (fixed mode), masks, or a callable sampled once per batch.
    `fetch` (tensor -> host numpy; `host_array` by default) is what a mesh
    replaces to gather the logits and labels of every data rank."""
    fetch = fetch or host_array
    all_logits, all_labels = [], []
    for i, (dense, cat, y) in enumerate(test_iter):
        if max_steps != -1 and i >= max_steps:
            break
        m = masks() if callable(masks) else masks
        logits = eval_step(model, dense, cat) if m is None else eval_step(model, dense, cat, m)
        all_logits.append(fetch(logits).ravel())
        all_labels.append(fetch(y).ravel())
    if not all_logits:
        raise ValueError(
            "eval iterator produced no batches — is test_batch_size larger "
            "than the eval split (batches are dropped when short)?"
        )
    logits = np.concatenate(all_logits)
    labels = np.concatenate(all_labels)
    probs = stable_sigmoid(logits)
    # Example-weighted mean BCE over the concatenated split (ref :174-177).
    eps = 1e-12
    logloss = float(
        -(labels * np.log(probs + eps) + (1 - labels) * np.log(1 - probs + eps)).mean()
    )
    return binary_accuracy(probs, labels), auc_exact(labels, probs), logloss


def train_and_test_one_epoch(
    train_step,
    eval_step,
    state: TrainState,
    train_iter: Iterable,
    make_test_iter: Callable[[], Iterable],
    *,
    epoch: int = 0,
    sampler: Optional[Callable] = None,   # () -> masks for one step (supernet mode)
    eval_masks=None,                       # masks, or () -> masks per eval batch
    display_interval: int = 100,
    test_interval: int = 2000,
    max_train_steps: int = -1,
    max_eval_steps: int = -1,
    test_only_at_last_step: bool = False,
    keep_best: bool = True,
    log_fn: Callable[[str], None] = print,
    metrics_writer=None,                   # optional train.logging.MetricsWriter
    fetch: Optional[Callable] = None,      # tensor -> host numpy (evaluate_one_epoch)
) -> Tuple[TrainState, Dict[str, list], Optional[Any]]:
    """One epoch of interleaved train/eval -> (state, logs, best_params)."""
    fetch = fetch or host_array
    logs: Dict[str, list] = {
        "train_loss": [], "train_AUROC": [], "train_Accuracy": [],
        "test_loss": [], "test_AUROC": [], "test_Accuracy": [],
        "epoch": [], "iters": [],
    }
    best_params = None
    best_test_loss = float("inf")
    # The rate counts the training steps' time only (perf_counter), from the
    # loop's start to each displayed step's end: the display's host work and
    # the evals are taken out.
    train_s = 0.0
    t_start = time.perf_counter()
    examples = 0
    batch_num = -1

    for batch_num, (dense, cat, y) in enumerate(train_iter):
        if sampler is not None:
            state, metrics = train_step(state, dense, cat, y, sampler())
        else:
            state, metrics = train_step(state, dense, cat, y)
        examples += len(y)

        is_last = batch_num == max_train_steps - 1
        if batch_num % display_interval == 0 or is_last:
            loss = float(metrics["loss"])             # waits for the step
            train_s += time.perf_counter() - t_start
            if not np.isfinite(loss):
                log_fn("Loss NaN. Exiting...")
                logs["test_loss"].append(999.99)
                logs["test_AUROC"].append(-1)
                logs["test_Accuracy"].append(-1)
                return state, logs, best_params
            logits = fetch(metrics["logits"]).ravel()
            labels = fetch(y).ravel()
            probs = stable_sigmoid(logits)
            train_auroc = auc_exact(labels, probs)
            train_acc = binary_accuracy(probs, labels)
            log_fn(
                f"epoch {epoch} step {batch_num} loss {loss:.6f} "
                f"l2 {float(metrics['l2']):.6f} lr {float(metrics['lr']):.6f} "
                f"acc {train_acc:.4f} auroc {train_auroc:.4f} "
                f"({examples / max(train_s, 1e-9):.0f} ex/s)"
            )
            logs["train_loss"].append(loss)
            logs["train_AUROC"].append(train_auroc)
            logs["train_Accuracy"].append(train_acc)
            logs["epoch"].append(epoch)
            logs["iters"].append(batch_num)
            if metrics_writer is not None:
                # Tag scheme of the reference (train_utils.py:334-338).
                metrics_writer.scalar(f"Loss/train/epoch{epoch}", loss, batch_num)
                metrics_writer.scalar(f"Acc/train/epoch{epoch}", train_acc, batch_num)
                metrics_writer.scalar(f"AUROC/train/epoch{epoch}", train_auroc, batch_num)
                metrics_writer.scalar(f"lr/epoch{epoch}", float(metrics["lr"]), batch_num)
            t_start = time.perf_counter()

        if (batch_num % test_interval == 0 or is_last) and (
                not test_only_at_last_step or is_last):
            float(metrics["loss"])                     # waits for the steps queued
            train_s += time.perf_counter() - t_start
            t0 = time.time()
            acc, auroc, tloss = evaluate_one_epoch(
                eval_step, state.model, make_test_iter(), masks=eval_masks,
                max_steps=max_eval_steps, fetch=fetch,
            )
            log_fn(f"TEST acc {acc:.4f} auroc {auroc:.4f} loss {tloss:.6f} "
                   f"({time.time() - t0:.1f}s)")
            logs["test_loss"].append(tloss)
            logs["test_AUROC"].append(auroc)
            logs["test_Accuracy"].append(acc)
            if metrics_writer is not None:
                metrics_writer.scalar(f"Loss/test/epoch{epoch}", tloss, batch_num)
                metrics_writer.scalar(f"Acc/test/epoch{epoch}", acc, batch_num)
                metrics_writer.scalar(f"AUROC/test/epoch{epoch}", auroc, batch_num)
            if keep_best and tloss < best_test_loss:
                best_test_loss = tloss
                best_params = snapshot_params(state.model)
            t_start = time.perf_counter()

        if max_train_steps != -1 and batch_num >= max_train_steps - 1:
            return state, logs, best_params

    log_fn(f"Batch counter total: {batch_num}")
    return state, logs, best_params
