"""Weight-shared candidate evaluation (port of `nasrec_tpu/search/worker.py`).

Reference flow (ref: nasrec/eval_subnet_from_supernet.py:71-207): per
candidate, pin the choice on the trained supernet, freeze everything but the
final linear, run a short fine-tune (default 500 steps at lr 0.04, Adagrad
eps 1e-2, cosine schedule with warmup steps // 10, clip 5.0) and a 150-step
eval.  The three fine-tune modes of the JAX package:

  - "final-only" (the reference's default EA mode): the supernet's body is
    frozen and shared, and the K candidates of a group advance together on
    one shared batch (`FinalOnlyGroup`).  Each owns a copy of the final
    linear and its Adagrad accumulator, held stacked as one [K, head_width, 1]
    weight and one [K, 1] bias.  A step looks the batch up in the table once,
    runs the frozen body for the whole group under `torch.no_grad()` through
    a forward of its own, each candidate's GEMMs cut to what its choice
    leaves non-zero (`search/pruned_body.py`), then takes the K logits as one
    batched product, the K losses and their gradients, clips each
    candidate's gradient by its own global norm and applies Adagrad.
  - "whole" and "layernorm-calibrate" with `batch_candidates` (the default):
    each candidate owns a copy of every trainable parameter and its Adagrad
    accumulator, stacked on a leading K axis, and the group advances as one
    step (`BatchedWholeGroup`, the JAX package's
    `_make_batched_whole_evaluator`).  The table and its accumulator, where
    they are trained, are K stacked tables held as one [K V, 16] pair, so
    that the step's duplicate-row segment-sum and touched-row update (the
    table kernel on the card) run once for the group; at wd 0 the update is
    the JAX package's dense Adagrad exactly.  Frozen parameters stay one
    shared copy.  Each candidate's gradient is clipped by its own global
    norm over all its parameters, the table rows included.
  - the same modes with batch_candidates=False: one candidate at a time
    (`SequentialCandidate`).  The supernet's weights are reloaded for each,
    and the trainable set (`train/loop.py :: freeze_mask`) goes through the
    sparse-embedding step under the candidate's masks.

The group as one program.  The JAX package vmaps one candidate's function
over the K candidates' masks (and parameters); this module does the same
with `torch.func.vmap` (and `torch.func.functional_call` for the stacked
parameters).  Each hand-written kernel's autograd Function has a vmap rule
(`ops/kernels/candidates.py`) that folds the K candidates into its batch
axis and launches once for the group: the dot-product and attention kernels
at batch K B, the transformer body's one-candidate kernel over K B rows where
the candidates share its parameters (final-only) and its K-candidate kernel
where each has its own (whole, layernorm-calibrate).  The loss that is
differentiated is the sum of the K candidates' losses, whose gradient with
respect to each candidate's parameters is that candidate's own (the
candidates share none); so the backward runs outside the transform, on the
folded tensors, and each kernel's backward launches once for the group too.
No Python loop over the candidates is left around a launch of a kernel of
this repository; the final-only body's cut cuBLAS GEMMs are one a candidate,
since their shapes differ between candidates.  No value is
read back to the host inside the fine-tune loop, except the mean loss
logged every 100 steps.

Eval runs `max_eval_steps` test batches in chunks of `eval_batch_chunk`
(a group's folded forward takes K x eval_batch_chunk rows), keeps the
logits on the device until the split is done, then computes the
sigmoid, logloss (eps 1e-12), accuracy and exact AUROC on the host; a
non-finite loss gives the divergence sentinel (ref: train_utils.py:294-301).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np
import torch

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.choices import Choice, ChoiceMasks, choice_to_masks
from nasrec_tpu_torch.models.supernet import SuperNet, SuperNetConfig
from nasrec_tpu_torch.search.pruned_body import PrunedBody
from nasrec_tpu_torch.train.loop import TABLE, freeze_mask
from nasrec_tpu_torch.train.metrics import auc_exact, binary_accuracy, stable_sigmoid
from nasrec_tpu_torch.train.optim import adagrad_update_, global_norm_scale, make_lr_schedule
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
    rowwise_segment_sum_slotwise,
    sparse_adagrad_table_update,
)

FINETUNE_MODES = {"final-only": "final-only", "whole": "normal",
                  "layernorm-calibrate": "layernorm-calibrate"}
SENTINEL = {"test_acc": -1, "test_auroc": -1, "test_loss": 999.99}


def _host_masks(supernet: SuperNet, choices: Sequence[Choice]) -> ChoiceMasks:
    cfg = supernet.cfg
    return ChoiceMasks.stack([choice_to_masks(c, cfg.space, cfg.num_blocks) for c in choices])


def _stacked_masks(supernet: SuperNet, choices: Sequence[Choice]) -> ChoiceMasks:
    return _host_masks(supernet, choices).to(supernet.final.weight.device)


def _bce_per_candidate(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[K, B, 1] logits -> the K mean BCE-with-logits losses (train/metrics.py)."""
    x, yf = logits.float(), y.float()
    return torch.mean(torch.clamp(x, min=0) - x * yf + torch.log1p(torch.exp(-torch.abs(x))),
                      dim=(1, 2))


class FinalOnlyGroup:
    """K candidates' final linears over the frozen, shared supernet body."""

    def __init__(self, supernet: SuperNet, choices: Sequence[Choice], schedule: Callable,
                 grad_clip: float, adagrad_eps: float, impl: str):
        self.k = len(choices)
        self.supernet, self.schedule, self.impl = supernet, schedule, impl
        self.grad_clip, self.adagrad_eps = grad_clip, adagrad_eps
        host = _host_masks(supernet, choices)
        self.masks = host.to(supernet.final.weight.device)
        self.body = PrunedBody(supernet, host, self.masks, impl)
        # The JAX layout: w [K, head_width, 1], b [K, 1].
        final = supernet.final
        self.weight = final.weight.detach().t().expand(self.k, -1, -1).clone()
        self.bias = final.bias.detach().expand(self.k, -1).clone()
        self.acc_weight = torch.zeros_like(self.weight)
        self.acc_bias = torch.zeros_like(self.bias)

    @torch.no_grad()
    def features(self, dense: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
        """[K, B, head_width]: the frozen body under each candidate's choice,
        from one table lookup, its GEMMs cut to each choice
        (`search/pruned_body.py`)."""
        return self.body.features(dense, self.supernet.embedding(cat))

    def _logits(self, feats, weight, bias) -> torch.Tensor:
        out = torch.baddbmm(bias[:, None, :], feats, weight)          # [K, B, 1]
        return torch.sigmoid(out) if self.supernet.cfg.use_final_sigmoid else out

    def step(self, dense, cat, y, step_idx: int) -> torch.Tensor:
        """One fine-tune step of the K finals on a shared batch -> the K
        losses (on the device)."""
        feats = self.features(dense, cat)
        w = self.weight.detach().requires_grad_(True)
        b = self.bias.detach().requires_grad_(True)
        losses = _bce_per_candidate(self._logits(feats, w, b), y)
        gw, gb = torch.autograd.grad(losses.sum(), [w, b])
        with torch.no_grad():
            # Each candidate's gradient is clipped by its own global norm.
            sq = gw.square().sum(dim=(1, 2)) + gb.square().sum(dim=1)
            scale = global_norm_scale(sq, self.grad_clip)
            gw, gb = gw * scale[:, None, None], gb * scale[:, None]
            adagrad_update_([self.weight, self.bias], [self.acc_weight, self.acc_bias],
                            [gw, gb], float(self.schedule(step_idx)), self.adagrad_eps)
        return losses.detach()

    @torch.no_grad()
    def logits(self, dense, cat) -> torch.Tensor:
        """[K, B] logits of the K fine-tuned candidates."""
        return self._logits(self.features(dense, cat), self.weight, self.bias)[..., 0]


def _trainable(model: SuperNet, mode: str) -> Dict[str, bool]:
    trainable = freeze_mask(model, mode)
    if not any(trainable.values()):
        raise ValueError(f"fine-tune mode {mode!r} leaves nothing to train "
                         "(a supernet without LayerNorm?)")
    return trainable


class _FromStem(torch.nn.Module):
    """The supernet's forward from a looked-up stem, as functional_call calls
    a module: its parameters are the supernet's under the prefix "net."."""

    def __init__(self, net: SuperNet):
        super().__init__()
        self.net = net

    def forward(self, dense, stem, masks, impl):
        return self.net.forward_embedded(dense, stem, masks, impl)


class BatchedWholeGroup:
    """Whole-net or LayerNorm-calibrate fine-tune of K candidates as one step
    (the counterpart of the JAX package's `_make_batched_whole_evaluator`):
    each trainable parameter as one [K, ...] tensor with its accumulator,
    the trained table as one [K V, 16] table with its accumulator (candidate
    k's rows at k V), the frozen parameters shared."""

    def __init__(self, supernet: SuperNet, choices: Sequence[Choice], mode: str,
                 schedule: Callable, grad_clip: float, adagrad_eps: float, impl: str):
        k = self.k = len(choices)
        self.supernet, self.schedule, self.impl = supernet, schedule, impl
        self.grad_clip, self.adagrad_eps = grad_clip, adagrad_eps
        self.masks = _stacked_masks(supernet, choices)
        self.module = _FromStem(supernet)
        trainable = _trainable(supernet, mode)
        named = [(n, p.detach()) for n, p in supernet.named_parameters() if n != TABLE]
        self.params = {n: p.expand(k, *p.shape).clone().requires_grad_(True)
                       for n, p in named if trainable[n]}
        self.frozen = {"net." + n: p for n, p in named if not trainable[n]}
        self.accs = {n: torch.zeros_like(p) for n, p in self.params.items()}
        table = supernet.embedding.table.detach()
        self.train_table = trainable[TABLE]
        if self.train_table:
            self.table = table.repeat(k, 1)
            self.table_acc = torch.zeros_like(self.table)
            self.first_rows = (torch.arange(k, dtype=torch.int32, device=table.device)
                               * table.shape[0])[:, None, None]
        else:
            self.table = table

    def _rows(self, cat: torch.Tensor) -> torch.Tensor:
        """[K, B, S] rows of the stacked table (or [B, S] of the shared one)."""
        idx = self.supernet.embedding.fused_index(cat)
        return idx[None] + self.first_rows if self.train_table else idx

    def _forward(self, dense: torch.Tensor, stem: torch.Tensor) -> torch.Tensor:
        """[K, B, 1] float32 logits; stem [K, B, S*E] (or [B, S*E], shared)."""
        def one(params, stem, masks):
            named = {"net." + n: p for n, p in params.items()}
            return torch.func.functional_call(
                self.module, {**named, **self.frozen},
                (dense, stem, masks, self.impl))

        return torch.func.vmap(one, in_dims=(0, 0 if self.train_table else None, 0))(
            self.params, stem, self.masks)

    def _stem(self, rows: torch.Tensor) -> torch.Tensor:
        return self.table.index_select(0, rows.reshape(-1)).reshape(*rows.shape[:-1], -1)

    def step(self, dense, cat, y, step_idx: int) -> torch.Tensor:
        """One fine-tune step of the K candidates on a shared batch -> the K
        losses (on the device)."""
        k, e = self.k, self.table.shape[1]
        rows = self._rows(cat)
        stem = self._stem(rows).requires_grad_(self.train_table)
        losses = _bce_per_candidate(self._forward(dense, stem), y)
        names = list(self.params)
        wrt = [self.params[n] for n in names] + ([stem] if self.train_table else [])
        # A block whose outputs no later block reads leaves its parameters out
        # of the graph: their gradient is zero, as in the JAX step.
        grads = torch.autograd.grad(losses.sum(), wrt, allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            g = list(grads[:len(names)])
            sq = torch.zeros(k, device=losses.device)
            for gg in g:
                sq = sq + gg.square().reshape(k, -1).sum(dim=1)
            if self.train_table:
                # All K B S looked-up rows in one segment-sum: column (k, s) of
                # [B, K S] holds candidate k's rows of slot s, so the columns'
                # row ranges ascend, and seg lists the candidates' positions
                # one candidate after another (sum(seg^2) over a candidate's
                # is its dense table gradient's squared norm).
                b, s = rows.shape[1], rows.shape[2]
                d_stem = grads[-1].reshape(k, b, s, e).transpose(0, 1).reshape(b * k * s, e)
                pos, seg, _ = rowwise_segment_sum_slotwise(
                    rows.transpose(0, 1).reshape(b, k * s), d_stem, self.impl)
                seg = seg.reshape(k, b * s, e)
                sq = sq + seg.square().sum(dim=(1, 2))
            scale = global_norm_scale(sq, self.grad_clip)
            g = [gg * scale.reshape(-1, *[1] * (gg.dim() - 1)) for gg in g]
            lr = float(self.schedule(step_idx))
            adagrad_update_([self.params[n] for n in names], [self.accs[n] for n in names], g,
                            lr, self.adagrad_eps)
            if self.train_table:
                sparse_adagrad_table_update(self.table, self.table_acc, pos,
                                            (seg * scale[:, None, None]).reshape(-1, e), lr,
                                            self.adagrad_eps, impl=self.impl)
        return losses.detach()

    @torch.no_grad()
    def logits(self, dense, cat) -> torch.Tensor:
        """[K, B] logits of the K fine-tuned candidates."""
        return self._forward(dense, self._stem(self._rows(cat)))[..., 0]

    def candidate_params(self, i: int) -> Dict[str, torch.Tensor]:
        """Candidate i's parameters by the supernet's names, the table's included."""
        out = {n[len("net."):]: p for n, p in self.frozen.items()}
        out.update({n: p[i].detach() for n, p in self.params.items()})
        v = self.supernet.embedding.table.shape[0]
        out[TABLE] = self.table[i * v:(i + 1) * v] if self.train_table else self.table
        return out


class SequentialCandidate:
    """Whole-net or LayerNorm-calibrate fine-tune of one candidate at a time,
    on a working copy of the supernet that is reloaded for each."""

    def __init__(self, supernet: SuperNet, mode: str, schedule: Callable, grad_clip: float,
                 adagrad_eps: float, impl: str):
        self.supernet, self.impl = supernet, impl
        self.model = copy.deepcopy(supernet)
        trainable = None if mode == "normal" else _trainable(self.model, mode)
        self.train_step = make_sparse_embedding_train_step(
            schedule, grad_clip=grad_clip, adagrad_eps=adagrad_eps, impl=impl,
            has_masks=True, trainable=trainable)
        self.state = init_sparse_train_state(self.model)
        self.masks = None

    @torch.no_grad()
    def reset(self, choice: Choice) -> None:
        """The supernet's weights, zero accumulators, step 0, `choice`'s masks."""
        for p, src in zip(self.model.parameters(), self.supernet.parameters()):
            p.copy_(src)
        for a in self.state.opt_state.values():
            a.zero_()
        self.state.step = 0
        cfg = self.supernet.cfg
        self.masks = choice_to_masks(choice, cfg.space, cfg.num_blocks).to(
            self.supernet.final.weight.device)

    def step(self, dense, cat, y, step_idx: int) -> torch.Tensor:
        self.state, metrics = self.train_step(self.state, dense, cat, y, self.masks)
        return metrics["loss"]

    @torch.no_grad()
    def logits(self, dense, cat) -> torch.Tensor:
        return self.model(dense, cat, self.masks, self.impl)[None, :, 0]


def _finetune(step: Callable, train_iter_fn: Callable[[], Iterable], max_train_steps: int,
              log_fn: Callable[[str], None]) -> None:
    """max_train_steps steps on the shared stream, restarted when it ends."""
    with tracing.span("search.finetune"):
        step_idx = 0
        train_iter = iter(train_iter_fn())
        while step_idx < max_train_steps:
            try:
                dense, cat, y = next(train_iter)
            except StopIteration:
                train_iter = iter(train_iter_fn())
                continue
            losses = step(dense, cat, y, step_idx)
            step_idx += 1
            if step_idx % 100 == 0:
                log_fn(f"finetune step {step_idx}: loss {float(losses.mean()):.5f}")


def _eval_logits(forward: Callable, test_iter_fn: Callable[[], Iterable], max_eval_steps: int,
                 chunk: int):
    """forward(dense, cat) -> [K, n] over the test stream in chunks ->
    (logits [K, N], labels [N]) on the host."""
    all_logits, all_labels = [], []
    with tracing.span("search.eval"):
        for i, (dense, cat, y) in enumerate(test_iter_fn()):
            if max_eval_steps != -1 and i >= max_eval_steps:
                break
            all_logits.extend(forward(dense[s:s + chunk], cat[s:s + chunk])
                              for s in range(0, len(y), chunk))
            all_labels.append(y.reshape(-1))
    if not all_logits:
        raise ValueError("eval iterator produced no batches — is test_batch_size larger "
                         "than the eval split (batches are dropped when short)?")
    with tracing.span("search.fetch"):
        return (torch.cat(all_logits, dim=1).float().cpu().numpy(),
                torch.cat(all_labels).float().cpu().numpy())


def _score(choices: Sequence[Choice], logits: np.ndarray, labels: np.ndarray) -> List[Dict]:
    with tracing.span("search.score"):
        probs = stable_sigmoid(logits)
        eps = 1e-12
        results = []
        for i, choice in enumerate(choices):
            p = probs[i]
            logloss = float(-(labels * np.log(p + eps)
                              + (1 - labels) * np.log(1 - p + eps)).mean())
            if not np.isfinite(logloss):
                results.append({"choice": choice, **SENTINEL})
                continue
            results.append({"choice": choice, "test_acc": binary_accuracy(p, labels),
                            "test_auroc": auc_exact(labels, p), "test_loss": logloss})
    return results


class CandidateEvaluator:
    """`evaluate(choices, train_iter_fn, test_iter_fn, log_fn) -> [results]`;
    see `make_candidate_evaluator`.  After a call that ran a group,
    `last_group` holds it (a FinalOnlyGroup's fine-tuned finals, a
    BatchedWholeGroup's parameters); after a sequential one, `model` holds
    the last candidate's weights."""

    def __init__(self, supernet: SuperNet, *, learning_rate, max_train_steps, max_eval_steps,
                 lr_schedule, grad_clip, adagrad_eps, eval_batch_chunk, finetune_mode,
                 batch_candidates, impl):
        self.supernet = supernet
        self.max_train_steps, self.max_eval_steps = max_train_steps, max_eval_steps
        self.eval_batch_chunk, self.impl = eval_batch_chunk, impl
        self.grad_clip, self.adagrad_eps = grad_clip, adagrad_eps
        self.mode = FINETUNE_MODES[finetune_mode]
        self.schedule = make_lr_schedule(lr_schedule, learning_rate, max_train_steps,
                                         max_train_steps // 10)
        self.last_group = None
        self.sequential = None
        if self.mode != "final-only" and not batch_candidates:
            self.sequential = SequentialCandidate(supernet, self.mode, self.schedule,
                                                  grad_clip, adagrad_eps, impl)
        elif self.mode != "final-only":
            _trainable(supernet, self.mode)        # refuse an empty trainable set up front

    @property
    def model(self):
        return self.sequential.model

    def group(self, choices: Sequence[Choice]):
        """A fresh group of `choices` that runs as one program: final-only
        (the supernet's final in each), or whole / layernorm-calibrate with
        batch_candidates (the supernet's weights in each)."""
        if self.mode == "final-only":
            return FinalOnlyGroup(self.supernet, choices, self.schedule, self.grad_clip,
                                  self.adagrad_eps, self.impl)
        return BatchedWholeGroup(self.supernet, choices, self.mode, self.schedule,
                                 self.grad_clip, self.adagrad_eps, self.impl)

    def __call__(self, choices: Sequence[Choice], train_iter_fn: Callable[[], Iterable],
                 test_iter_fn: Callable[[], Iterable],
                 log_fn: Callable[[str], None] = lambda s: None) -> List[Dict]:
        with tracing.span("search.group"):
            return self._evaluate(choices, train_iter_fn, test_iter_fn, log_fn)

    def _evaluate(self, choices, train_iter_fn, test_iter_fn, log_fn) -> List[Dict]:
        if self.sequential is None:
            self.last_group = None          # a whole-net group's copies go before the next's
            group = self.group(choices)
            _finetune(group.step, train_iter_fn, self.max_train_steps, log_fn)
            logits, labels = _eval_logits(group.logits, test_iter_fn, self.max_eval_steps,
                                          self.eval_batch_chunk)
            self.last_group = group
            return _score(choices, logits, labels)
        results = []
        cand = self.sequential
        for ci, choice in enumerate(choices):
            cand.reset(choice)
            _finetune(cand.step, train_iter_fn, self.max_train_steps, lambda s: None)
            logits, labels = _eval_logits(cand.logits, test_iter_fn, self.max_eval_steps,
                                          self.eval_batch_chunk)
            results.extend(_score([choice], logits, labels))
            log_fn(f"candidate {ci + 1}/{len(choices)}: loss {results[-1]['test_loss']:.5f}")
        return results


def make_candidate_evaluator(
    cfg: SuperNetConfig,
    supernet_params: SuperNet,
    *,
    learning_rate: float = 0.04,
    max_train_steps: int = 500,
    max_eval_steps: int = 150,
    lr_schedule: str = "cosine",
    grad_clip: float = 5.0,
    adagrad_eps: float = 1e-2,
    eval_batch_chunk: int = 1024,
    finetune_mode: str = "final-only",  # final-only | whole | layernorm-calibrate
    batch_candidates: bool = True,
    impl: str = "auto",
) -> CandidateEvaluator:
    """Build `evaluate(choices, train_iter_fn, test_iter_fn) -> [results]`
    over the trained supernet `supernet_params` (a SuperNet built from
    `cfg`, on the device the batches come on; its parameters are read and
    never changed).  impl='auto' runs the kernels on the card and their
    plain versions on the CPU; 'plain' names the plain versions.
    batch_candidates (the default) runs the whole and layernorm-calibrate
    modes as one K-candidate step a group; False, one candidate at a time
    (see the module docstring)."""
    if supernet_params.cfg != cfg:
        raise ValueError("make_candidate_evaluator: the supernet was built from another config")
    if finetune_mode not in FINETUNE_MODES:
        raise ValueError(f"unknown finetune_mode {finetune_mode!r}")
    return CandidateEvaluator(
        supernet_params, learning_rate=learning_rate, max_train_steps=max_train_steps,
        max_eval_steps=max_eval_steps, lr_schedule=lr_schedule, grad_clip=grad_clip,
        adagrad_eps=adagrad_eps, eval_batch_chunk=eval_batch_chunk,
        finetune_mode=finetune_mode, batch_candidates=batch_candidates, impl=impl)


def finetune_and_eval_candidates(
    cfg: SuperNetConfig,
    supernet_params: SuperNet,
    choices: Sequence[Choice],
    train_iter_fn,
    test_iter_fn,
    **kwargs,
) -> List[Dict]:
    """Convenience wrapper: build an evaluator and run it once."""
    evaluator = make_candidate_evaluator(cfg, supernet_params, **kwargs)
    return evaluator(choices, train_iter_fn, test_iter_fn)
