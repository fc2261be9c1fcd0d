"""Driver `dcn_train`: DLRM-DCNv2's training step in the port
(`nasrec_tpu_torch/models/dcn.py`), fed by multi-hot batches made on the
device (`lib/multihot.py`).

The step is the one `workloads._make_steps` builds for `main_train --net
dcnv2`: `make_sparse_embedding_train_step` with the model's bags, Adagrad at
the configuration's constant rate and eps for the dense parameters and the
table (the table through the 128-wide segment-sum and touched-row update),
no clip, the kernels on the card, on the state of `init_sparse_train_state`.
The loss comes back to the host every `sync_every` steps, as the port's
training loop reads it.

Set-up makes the weights and `pool_batches` batches from the seed
(`reference/dcnv2_ref.py` draws the weights, the table a chunk at a time
straight into the model's own), runs the first `checked_steps` steps
through the window's own call and feed (read for the comparison), then
`warmup_steps` more, and more until `warmup_seconds` have passed; the window
follows.  After it, with the program's state
freed, the reference runs the checked steps again from the same weights and
batches.  The readings are those of `lib/compare.py`: each step's loss, each
leaf's first gradient as its Adagrad accumulator holds it after one step,
and each leaf's change over the checked steps; at 51 M rows of 128 the
table's are summed a chunk of rows at a time, in float64.
"""

from __future__ import annotations

import math
import time

import torch

from lib import compare, faults, multihot, roofline_wide, training, window
from reference import dcnv2_ref


def _batches(cfg, cell, seed, dev, n):
    return [multihot.device_batch(seed, i, cell["batch"], cfg["vocab_sizes"],
                                  cfg["multi_hot_sizes"], cfg["num_dense"], cell["label_rate"],
                                  dev) for i in range(n)]


@torch.no_grad()
def _change(params, cfg, seed, dev):
    """Each leaf's distance from the weights the seed made."""
    w0 = dcnv2_ref.make_dense(cfg, seed, dev)
    out = {n: math.sqrt(float((params[n].double() - w0[n].double()).square().sum()))
           for n in w0}
    out[dcnv2_ref.TABLE] = math.sqrt(dcnv2_ref.table_change_sq(params[dcnv2_ref.TABLE], cfg,
                                                                seed))
    return out


def run(rt):
    # Imported first: a port without the model fails here, before any work.
    from nasrec_tpu_torch.models.dcn import DCNv2Config, dcnv2_init
    from nasrec_tpu_torch.ops.kernels import build
    from nasrec_tpu_torch.train.optim import make_optimizer, slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    cell, cfg, dev, seed = rt.cell, rt.cfg, rt.device, rt.seed
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    batch, sizes = cell["batch"], cfg["multi_hot_sizes"]
    training.setup_mark(rt, "imports")
    if dev.type == "cuda":
        build.build_all()
    training.setup_mark(rt, "kernels built or loaded")

    # The program: the port's model, given the benchmark's weights.
    mcfg = DCNv2Config(vocab_sizes=tuple(cfg["vocab_sizes"]), bag_sizes=tuple(sizes),
                       num_dense=cfg["num_dense"], emb_dim=cfg["embedding_dim"],
                       dense_arch=tuple(cfg["dense_arch_layer_sizes"]),
                       cross_layers=cfg["dcn_num_layers"], cross_rank=cfg["dcn_low_rank_dim"],
                       over_arch=tuple(cfg["over_arch_layer_sizes"][:-1]),
                       init_rows=tuple(cfg["published_vocab_sizes"]))
    model = dcnv2_init(mcfg, seed=0, device=dev)
    dcnv2_ref.fill_table(model.embedding.table.data, cfg, seed)
    missing, unexpected = model.load_state_dict(dcnv2_ref.make_dense(cfg, seed, dev),
                                                strict=False)
    if missing != [dcnv2_ref.TABLE] or unexpected:
        raise RuntimeError(f"the reference's parameters do not fit the port's model: "
                           f"missing {missing}, unexpected {unexpected}")
    training.setup_mark(rt, "model and weights")
    opt = make_optimizer(cfg["optimizer"], cfg["adagrad_eps"])
    state = init_sparse_train_state(model, opt)
    step = make_sparse_embedding_train_step(
        lambda s: cfg["learning_rate"], optimizer=opt, grad_clip=cfg["grad_clip"],
        adagrad_eps=cfg["adagrad_eps"], l2_reg=cfg["wd"], impl="auto", table_impl="auto",
        compute_dtype=torch.float32, bag_sizes=mcfg.bag_sizes)
    if "step" in rt.faults:
        step = faults.broken_step(step, rt.faults["step"])
    pool = _batches(cfg, cell, seed, dev, cell["pool_batches"])
    spans = window.Spans()

    def body(pos):
        t0 = time.perf_counter()
        with spans("next_batch"):
            b = pool[pos % len(pool)]
        t1 = time.perf_counter()
        with spans("step"):
            _, m = step(state, *b)
        return m["loss"], t1 - t0, time.perf_counter() - t1

    training.setup_mark(rt, "traffic")
    # Set-up: the checked steps, then the warm-up.
    losses, grad = [], None
    for i in range(cell["checked_steps"]):
        loss, _, _ = body(i)
        losses.append(float(loss))
        if i == 0:
            grad = {n: math.sqrt(dcnv2_ref.total(a))
                    for n, a in slot_dicts(state.opt_state)[0].items()}
    prog = {"losses": losses, "grad": grad,
            "change": _change(dict(model.named_parameters()), cfg, seed, dev)}
    training.setup_mark(rt, "checked steps")
    # The warm-up: `warmup_steps` steps and at least `warmup_seconds`, so that
    # the window opens on a card that has run the step for a while.
    first, t_warm = cell["checked_steps"], time.perf_counter()
    while (first < cell["checked_steps"] + cell["warmup_steps"]
           or time.perf_counter() - t_warm < cell["warmup_seconds"]):
        body(first)
        first += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = rt.clock()
    training.say(f"setup_s {setup_s:.3f}")

    w = window.run_window(body, rt.seconds, cell["sync_every"], dev, first)
    peak = training.peak_bytes(dev)
    first += w["units"]
    e2e = training.train_e2e(w, batch, cell["metric_prefix"])
    e2e["setup_s"] = setup_s
    ends = w["unit_end_ms"]
    drift = (f"; card ms a step, first / last 30: {sum(ends[:30]) / len(ends[:30]):.3f} / "
             f"{sum(ends[-30:]) / len(ends[-30:]):.3f}" if ends else "")
    training.say(f"window: {w['units']} steps in {w['seconds']:.4f} s; peak {peak} bytes; "
                 f"{window.host_summary(w)}{drift}")

    layers, trace = {}, None
    if rt.trace:
        flops = dcnv2_ref.step_flops(cfg, batch)
        uniq = [multihot.unique_rows(b[1], cfg["vocab_sizes"], sizes) for b in pool]
        n = cell["trace_steps"]
        ctx = {"window": w, "flops_per_unit": flops, "examples_per_unit": batch, "device": dev,
               "cell": cell["name"], "bags_per_unit": batch * len(sizes),
               "unique_rows_slice": sum(uniq[(first + i) % len(pool)] for i in range(n))}
        positions = batch * sum(sizes)
        u = sum(uniq) / len(uniq)
        training.say(
            f"model FLOPs a step {flops:.6g} (forward and backward, batch {batch}); "
            f"{positions} lookups and {u:.0f} touched rows a step (mean of {len(uniq)} "
            f"batches); bounds a step: lookup "
            f"{roofline_wide.bound_s(roofline_wide.lookup_bytes(positions, u, batch * len(sizes))) * 1e3:.6f} ms, "
            f"segment-sum "
            f"{roofline_wide.bound_s(roofline_wide.segment_sum_bytes(positions, u, batch * len(sizes))) * 1e3:.6f} ms, "
            f"table update, every touched row written, "
            f"{roofline_wide.bound_s(roofline_wide.table_update_bytes(positions, u, u)) * 1e3:.6f} ms")
        trace = window.profile_slice(body, n, spans, dev, first)
        ctx["trace"] = trace
        training.say(window.slice_summary(trace, w))
        layers = rt.read_layers(ctx)
        del ctx
    attempted, failed = w["units"], w["nonfinite"]

    # The program's state goes; the reference follows the checked steps.
    del state, model, step, body, pool, opt
    training.free_device()
    t_ref = time.perf_counter()
    refr = reference(cfg, cell, seed, dev, _batches(cfg, cell, seed, dev, cell["checked_steps"]))
    correct, checks = training.judge_training(prog, refr, cell["limits"])
    training.say(f"reference and comparison: {time.perf_counter() - t_ref:.2f} s")
    return {"correct": correct, "checks": checks, "attempted": attempted, "failed": failed,
            "e2e": e2e, "layers": layers, "trace": trace, "memory_peak_bytes": peak}


def reference(cfg, cell, seed, dev, batches, precision="f32"):
    """The reference's readings over `batches` from the seed's weights."""
    trainer = dcnv2_ref.RefTrainer(cfg, dcnv2_ref.make_weights(cfg, seed, dev),
                                   cfg["learning_rate"], cfg["adagrad_eps"], precision)
    losses = [trainer.step(*b) for b in batches]
    out = {"losses": losses, "grad": trainer.first_grad,
           "change": _change(trainer.params, cfg, seed, dev)}
    del trainer
    training.free_device()
    return out


def control_inputs(cfg, cell, seed, dev):
    """The checked steps' batches."""
    return _batches(cfg, cell, seed, dev, cell["checked_steps"])


gaps = compare.training_gaps
