"""Driver `search_groups`: the weight-shared search's candidate groups, one
after another, through the port's `search/worker.py ::
make_candidate_evaluator` in the final-only mode (the canonical search's):
each group of `group` candidates, drawn by the port's `ChoiceSampler` from the
seed, gets `max_train_steps` fine-tune steps of its finals over the frozen
supernet on the fine-tune batches (used in turn, restarted when they end)
and is scored on `max_eval_steps` test batches in chunks of `eval_chunk`.
The supernet's weights and every batch are made on the card from the seed.

A unit of the window is a group: the window closes at the end of the first
group that finishes after `--seconds`.  The answers are the candidates'
logits on the test rows, from which the search scores them; the logits of
one group of the window, drawn from the seed, are kept as the program hands
them to its scoring.  After the window that group is judged: the reference
fine-tunes each of its candidates' finals itself, one candidate at a time
over the reference supernet's features under the candidate's masks (which it
makes from the choice), and scores the test rows.  The comparison holds the
two stages apart: each candidate's fine-tune by the change of its finals
against the reference's, and the scoring by the program's logits against
the reference's features under the program's fine-tuned finals.  The worst
candidate's fine-tune and the logits against the reference's own finals are
printed, not compared: the 25 clipped Adagrad steps carry a rounding
difference of the features into some candidates' finals many times over, in
the reference in float32 against float64 as much as in the program; the
median candidate's change is steady from seed to seed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from lib import compare, faults, roofline, traffic, training, window
from lib.weights import make_weights, sub_seed
from reference import nasrec_ref


def _vocab(cfg, cell):
    cap = cell.get("vocab_cap", cfg["vocab_cap"])
    return [min(int(v), cap) for v in cfg["vocab_sizes"]]


def _pools(cfg, cell, seed, dev, vocab):
    train = [traffic.device_batch(seed, i, cell["batch"], vocab, cfg["num_dense"],
                                  cell["label_rate"], dev) for i in range(cell["train_batches"])]
    test = [traffic.device_batch(seed, 10_000 + i, cell["test_batch"], vocab, cfg["num_dense"],
                                 cell["label_rate"], dev) for i in range(cell["max_eval_steps"])]
    return train, test


def _sampler(cfg, seed):
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.sampling import ChoiceSampler

    return ChoiceSampler(OPS_CONFIG_LIB[cfg["space"]["name"]], cfg["num_blocks"],
                         strategy=cfg["strategy"], anypath_choice=cfg["anypath_choice"],
                         supernet_training_steps=0, seed=sub_seed(seed, "candidates") % 2 ** 32)


def run(rt):
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.ops.kernels import build
    from nasrec_tpu_torch.search.worker import make_candidate_evaluator

    cell, cfg, dev, seed = rt.cell, rt.cfg, rt.device, rt.seed
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    vocab = _vocab(cfg, cell)
    training.setup_mark(rt, "imports")
    if dev.type == "cuda":
        build.build_all()
    training.setup_mark(rt, "kernels built or loaded")
    sncfg = SuperNetConfig(
        space=OPS_CONFIG_LIB[cfg["space"]["name"]], num_blocks=cfg["num_blocks"],
        num_dense=cfg["num_dense"], num_sparse=cfg["num_sparse"], vocab_sizes=tuple(vocab),
        emb_dim=cfg["emb_dim"], use_layernorm=cfg["use_layernorm"], activation=cfg["activation"])
    supernet = supernet_init(sncfg, seed=0, device=dev)
    model_fn = lambda: nasrec_ref.SuperNetRef(cfg, vocab)
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(model_fn), vocab)
    weights = make_weights(specs, seed, dev)
    supernet.load_state_dict(weights, strict=True)
    del weights
    training.setup_mark(rt, "model and weights")
    kw = dict(learning_rate=cfg["search_learning_rate"], eval_batch_chunk=cell["eval_chunk"],
              finetune_mode=cfg["search_finetune_mode"], grad_clip=cfg["grad_clip"],
              adagrad_eps=cfg["adagrad_eps"], lr_schedule=cfg["lr_schedule"], impl="auto")
    evaluator = make_candidate_evaluator(sncfg, supernet, max_train_steps=cell["max_train_steps"],
                                         max_eval_steps=cell["max_eval_steps"], **kw)
    train_pool, test_pool = _pools(cfg, cell, seed, dev, vocab)
    if rt.faults.get("step") == "state_unchanged":
        faults.broken_groups(evaluator, "state_unchanged")
    if rt.faults.get("step") == "half_batch":
        train_pool = faults.half_batches(train_pool)
    if rt.faults.get("answer") == "altered":
        faults.altered_logits(evaluator)
    training.setup_mark(rt, "traffic")
    sampler = _sampler(cfg, seed)
    k = cell["group"]
    spans = window.Spans()
    marks = {}

    def train_iter():
        return iter(train_pool)

    def test_iter():
        marks.setdefault("eval_from", time.perf_counter())
        return iter(test_pool)

    kept = {}
    timing = []
    sample = int(np.random.default_rng(sub_seed(seed, "judged-group")).integers(
        0, cell["judged_group_below"]))
    judged = {"on": False, "logits": []}
    make_group = evaluator.group

    def group(choices):
        """The program's group; the judged group's logits are kept as its
        forward hands them to the scoring."""
        grp = make_group(choices)
        if judged["on"]:
            forward = grp.logits

            def logits(dense, cat):
                out = forward(dense, cat)
                judged["logits"].append(out.detach().clone())
                return out
            grp.logits = logits
        return grp
    evaluator.group = group

    def body(g):
        t0 = time.perf_counter()
        with spans("sampler"):
            choices = [sampler() for _ in range(k)]
        marks.clear()
        judged["on"] = g == sample
        with spans("group"):
            results = evaluator(choices, train_iter, test_iter)
        judged["on"] = False
        t1 = time.perf_counter()
        timing.append((t0, marks.get("eval_from", t1), t1))
        if g == sample:
            grp = evaluator.last_group
            kept.update(choices=choices, losses=[r["test_loss"] for r in results],
                        weight=grp.weight[..., 0].detach().clone(),
                        bias=grp.bias[:, 0].detach().clone())
        return None, 0.0, t1 - t0

    # Set-up: every shape of a group (fine-tune steps and eval chunks of the
    # group's size) once, through a short evaluator of the same mode.
    warm = make_candidate_evaluator(sncfg, supernet, max_train_steps=cell["warmup_steps"],
                                    max_eval_steps=1, **kw)
    warm([sampler() for _ in range(k)], train_iter, test_iter)
    del warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = rt.clock()
    training.say(f"setup_s {setup_s:.3f}; judged group {sample}")

    w = window.run_window(body, rt.seconds, 1, dev, 0)
    peak = training.peak_bytes(dev)
    e2e = {"search_candidates_per_s": w["units"] * k / w["seconds"], "setup_s": setup_s}
    training.say(f"window: {w['units']} groups of {k} in {w['seconds']:.4f} s; peak {peak} bytes")
    if w["units"] <= sample:
        raise RuntimeError(f"the window ran {w['units']} groups; group {sample} was to be judged")
    layers, trace = {}, None
    if rt.trace:
        wt = timing[:w["units"]]
        rows = cell["max_train_steps"] * cell["batch"] + cell["max_eval_steps"] * cell["test_batch"]
        flops = _candidate_flops(cfg, vocab, [c for c in _window_choices(cfg, seed, k, w["units"])],
                                 cell)
        smax, dmax = max(cfg["space"]["sparse_node_dims"]), max(cfg["space"]["dense_node_dims"])
        n = 1 + round((2 * dmax) ** 0.5)
        nb = cfg["num_blocks"]
        chunks = cell["max_eval_steps"] * (cell["test_batch"] // cell["eval_chunk"])
        bound = (cell["max_train_steps"] * nb * (
            roofline.body_eval_bound(k * cell["batch"], smax)
            + roofline.dot_bounds(k * cell["batch"], n)["dot_fwd"])
            + chunks * nb * (roofline.body_eval_bound(k * cell["eval_chunk"], smax)
                             + roofline.dot_bounds(k * cell["eval_chunk"], n)["dot_fwd"]))
        ctx = {"window": w, "window_flops": flops, "device": dev, "cell": cell["name"],
               "bounds_per_unit_s": bound,
               "eval_share": sum(t1 - te for _, te, t1 in wt) / sum(t1 - t0 for t0, _, t1 in wt)}
        training.say(f"model FLOPs of the window's {w['units'] * k} candidates {flops:.6g} "
                     f"({rows} rows each, forward; the finals' gradients); bound a group "
                     f"{bound * 1e3:.6f} ms")
        trace = window.profile_slice(body, cell["trace_groups"], spans, dev, w["units"])
        ctx["trace"] = trace
        training.say(window.slice_summary(trace, w))
        layers = rt.read_layers(ctx)
        del ctx
    final0 = (supernet.final.weight[0].detach().clone(), supernet.final.bias.detach().clone())
    del evaluator, supernet, train_pool, test_pool, body
    training.free_device()
    t_ref = time.perf_counter()
    ref = reference(cfg, cell, seed, dev, kept["choices"], finals=(kept["weight"], kept["bias"]))
    logits = torch.cat(judged["logits"], dim=1).float().cpu()
    prog = {"losses": kept["losses"], "logits": list(logits),
            "change": [float(torch.linalg.vector_norm(torch.cat([
                kept["weight"][i] - final0[0], kept["bias"][i:i + 1] - final0[1]])))
                for i in range(k)]}
    values = _gaps(prog, ref)
    correct, checks = compare.judge(values, cell["limits"])
    training.say("readings by candidate: eval logit gap " + " ".join(
        f"{_rel(a, b):.3g}" for a, b in zip(prog["logits"], ref["program_finals_logits"]))
        + "; logit gap " + " ".join(
        f"{_rel(a, b):.3g}" for a, b in zip(prog["logits"], ref["logits"]))
        + "; the program's finals over the reference's features " + " ".join(
        f"{_rel(a, b):.3g}" for a, b in zip(ref["program_finals_logits"], ref["logits"]))
        + "; reference logits rms " + " ".join(
        f"{float(b.double().square().mean().sqrt()):.4g}" for b in ref["logits"]))
    training.say("readings: program test losses " + " ".join(f"{x:.9g}" for x in prog["losses"])
                 + "; reference " + " ".join(f"{x:.9g}" for x in ref["losses"]))
    training.say("readings not compared: " + ", ".join(
        f"{n} {v!r}" for n, v in values.items() if n not in cell["limits"]))
    training.say(f"reference and comparison: {time.perf_counter() - t_ref:.2f} s")
    return {"correct": correct, "checks": checks, "attempted": w["units"] * k, "failed": 0,
            "e2e": e2e, "layers": layers, "trace": trace, "memory_peak_bytes": peak}


def _gaps(prog, ref):
    """eval_logit_gap: the worst candidate's |logits - the reference's
    features under the program's finals| over the latter's norm (norms over
    the test rows): the scoring forward alone; final_change_median_gap: the
    median candidate's gap of the finals' change, against the larger of its
    own and the median candidate's: the fine-tune alone.  Printed only:
    final_change_gap, the worst candidate's; logit_gap, the worst candidate's
    logits against the reference's own finals (both stages); score_gap, the
    worst candidate's relative gap of the test loss."""
    names = ("eval_logit_gap", "final_change_gap", "logit_gap", "final_change_median_gap",
             "score_gap")
    pairs = [(prog["logits"], ref["logits"]), (prog["logits"], ref["program_finals_logits"])]
    if any(len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)) for a, b in pairs):
        return dict.fromkeys(names, math.inf)
    logit = max(_rel(a, b) for a, b in zip(prog["logits"], ref["logits"]))
    evalg = max(_rel(a, b) for a, b in zip(prog["logits"], ref["program_finals_logits"]))
    score = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = float(np.median(ref["change"]))
    changes = [abs(a - b) / max(b, med) for a, b in zip(prog["change"], ref["change"])]
    out = dict(zip(names, (evalg, max(changes), logit, float(np.median(changes)), score)))
    if not all(math.isfinite(x) for x in prog["losses"] + prog["change"] + [logit, evalg]):
        out = dict.fromkeys(names, math.inf)
    return out


def _rel(a, b) -> float:
    """|a - b| / |b|, norms over the rows."""
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


def _window_choices(cfg, seed, k, groups):
    """The candidates of the window's groups, drawn again (after the warm-up
    group's)."""
    s = _sampler(cfg, seed)
    draws = [s() for _ in range(k * (groups + 1))]
    return draws[k:]


def _candidate_flops(cfg, vocab, choices, cell) -> float:
    """Matmul FLOPs of the window's candidates: each candidate's own subnet
    forward (its nodes at their chosen widths) over every fine-tune and test
    row, and its final's weight gradient over the fine-tune rows; counted on
    the meta device at one row and scaled."""
    from torch.utils.flop_counter import FlopCounterMode

    rows = cell["max_train_steps"] * cell["batch"] + cell["max_eval_steps"] * cell["test_batch"]
    total = 0.0
    for c in choices:
        ref = nasrec_ref.shapes_of(lambda: nasrec_ref.FixedRef(cfg, vocab, c))
        with torch.device("meta"):
            dense = torch.empty(1, cfg["num_dense"])
            stem = torch.empty(1, cfg["num_sparse"] * cfg["emb_dim"])
        with FlopCounterMode(display=False) as fc:
            with torch.no_grad():
                ref.forward_stem(dense, stem)
        total += float(fc.get_total_flops()) * rows
        total += 2.0 * ref.final.in_features * cell["max_train_steps"] * cell["batch"]
    return total


def reference(cfg, cell, seed, dev, choices, precision="f32", finals=None):
    """Each candidate's finals fine-tuned and scored by the reference, one
    candidate at a time: {'losses': [test loss], 'logits': [float32 logits
    over the test rows], 'change': [norm of the finals' change], 'finals':
    (weight [K, D], bias [K]) fine-tuned}; with another side's fine-tuned
    `finals` (the same layout), also 'program_finals_logits': those finals
    over the reference's features."""
    vocab = _vocab(cfg, cell)
    model_fn = lambda: nasrec_ref.SuperNetRef(cfg, vocab)
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(model_fn), vocab)
    net = nasrec_ref.build(model_fn, make_weights(specs, seed, dev))
    train_pool, test_pool = _pools(cfg, cell, seed, dev, vocab)
    steps = cell["max_train_steps"]
    lr_fn = lambda s: nasrec_ref.cosine_lr(s, steps, steps // 10, cfg["search_learning_rate"])
    losses, changes, all_logits, with_finals, tuned = [], [], [], [], []
    for ci, c in enumerate(choices):
        nasrec_ref.check_choice(cfg, c)
        mk = nasrec_ref.choice_masks(cfg, c, dev)

        def feats(b):
            with torch.no_grad(), nasrec_ref.lower_precision(precision, dev):
                stem = net.embedding.table[net.embedding.rows(b[1]).reshape(-1)].reshape(
                    b[1].shape[0], -1)
                return net.features(b[0], stem, mk).float()

        w0, b0 = net.final.weight.detach()[0].clone(), net.final.bias.detach().clone()
        wt, bt = w0.clone(), b0.clone()
        aw, ab = torch.zeros_like(wt), torch.zeros_like(bt)
        train_feats = [feats(b) for b in train_pool]
        for i in range(steps):
            y = train_pool[i % len(train_pool)][2]
            f = train_feats[i % len(train_pool)]
            wg, bg = wt.clone().requires_grad_(True), bt.clone().requires_grad_(True)
            with nasrec_ref.lower_precision(precision, dev):
                loss = nasrec_ref.bce(f @ wg[:, None] + bg, y)
                gw, gb = torch.autograd.grad(loss, [wg, bg])
            with torch.no_grad():
                gw, gb = gw.float(), gb.float()
                sq = gw.square().sum() + gb.square().sum()
                scale = torch.clamp(cfg["grad_clip"] / (torch.sqrt(sq) + 1e-6), max=1.0)
                lr = lr_fn(i)
                for p, a, g in ((wt, aw, gw * scale), (bt, ab, gb * scale)):
                    a.addcmul_(g, g)
                    p.addcdiv_(g, a.sqrt().add_(cfg["adagrad_eps"]), value=-lr)
        logits, labels, other = [], [], []
        for b in test_pool:
            with torch.no_grad(), nasrec_ref.lower_precision(precision, dev):
                f = feats(b)
                logits.append((f @ wt[:, None] + bt)[:, 0].float().cpu())
                if finals is not None:
                    fw, fb = finals[0][ci].to(dev), finals[1][ci].to(dev)
                    other.append((f @ fw[:, None] + fb)[:, 0].float().cpu())
            labels.append(b[2][:, 0].cpu())
        if finals is not None:
            with_finals.append(torch.cat(other))
        # The score as the search computes it: a float32 logit's sigmoid and
        # the log loss in float64.
        all_logits.append(torch.cat(logits))
        x = all_logits[-1].numpy().astype(np.float32).astype(np.float64)
        yv = torch.cat(labels).numpy().astype(np.float32)
        p = np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))),
                     np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x))))
        eps = 1e-12
        losses.append(float(-(yv * np.log(p + eps) + (1 - yv) * np.log(1 - p + eps)).mean()))
        changes.append(float(torch.linalg.vector_norm(torch.cat([wt - w0, bt - b0]))))
        tuned.append((wt.cpu(), bt.cpu()))
    del net, train_pool, test_pool
    training.free_device()
    out = {"losses": losses, "logits": all_logits, "change": changes,
           "finals": (torch.stack([w for w, _ in tuned]), torch.cat([b for _, b in tuned]))}
    if finals is not None:
        out["program_finals_logits"] = with_finals
    return out


def control_inputs(cfg, cell, seed, dev):
    """A group of candidates drawn as the program's sampler draws them."""
    s = _sampler(cfg, seed)
    return [s() for _ in range(cell["group"])]


def control_reference(cfg, cell, seed, dev, inputs, low):
    """The reference that judges the control `low` (a lower-precision
    reference in the program's place): its scoring is held under the
    control's own fine-tuned finals, as the program's is under the
    program's."""
    return reference(cfg, cell, seed, dev, inputs, finals=low["finals"])


gaps = _gaps
