"""Driver `fixed_train`: the port's sparse-embedding training step of a fixed
subnet, fed by batches made on the device (`"source": "device"`) or by
Criteo-format TSV text through the port's own input pipeline
(`"source": "tsv"`: `batch_iterator` over the shards with the C++ parser,
its `prefetch` thread and `device_prefetch`, as main_train streams an epoch).
The TSV stream is one stream over the shards read again and again: one
prefetch thread and one `device_prefetch` for the whole run, so a pass's end
costs what the parser's next pass costs and no new thread, as in main_train,
whose stream restarts once an epoch (about 1,259 steps of 32768 rows of
Criteo's trainval), that is less than once in a window.

The step is the one `workloads._make_steps` builds for main_train:
`make_sparse_embedding_train_step` with Adagrad, the global-norm clip, the
kernels on the card (`impl="auto"`, `table_impl="auto"`), on the state of
`init_sparse_train_state`; the learning rate follows the launcher's cosine
schedule over an epoch of the cell's batch, 10 % of it warm-up.  The loss
comes back to the host every `sync_every` steps, as the port's training loop
reads it.

Set-up makes the weights and the batches from the seed, runs the first
`checked_steps` steps through the window's own call and feed (read for the
comparison), then `warmup_steps` more; the window follows.  After it, with the
program's state freed, the reference runs the checked steps again from the
same weights and batches; for TSV, the reference also parses the text of the
checked batches and of one batch of the window, drawn from the seed, and the
program's batches must equal its parse.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import time

import numpy as np
import torch

from lib import compare, faults, roofline, traffic, training, window
from lib.weights import make_weights, sub_seed
from reference import nasrec_ref, tsv_ref


def _vocab(cfg, cell):
    cap = cell.get("vocab_cap")
    return [min(int(v), cap) if cap else int(v) for v in cfg["vocab_sizes"]]


def run(rt):
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
    from nasrec_tpu_torch.ops.kernels import build
    from nasrec_tpu_torch.train.optim import make_lr_schedule, make_optimizer, slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    cell, cfg, dev, seed = rt.cell, rt.cfg, rt.device, rt.seed
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    batch, vocab = cell["batch"], _vocab(cfg, cell)
    training.setup_mark(rt, "imports")
    if dev.type == "cuda":
        build.build_all()
    training.setup_mark(rt, "kernels built or loaded")

    # The program: the published subnet through the port's own plan and
    # model, given the benchmark's weights.
    plan = build_fixed_plan(cfg["choice"], OPS_CONFIG_LIB[cfg["space"]["name"]],
                            cfg["num_blocks"], cfg["num_dense"], cfg["num_sparse"], vocab,
                            emb_dim=cfg["emb_dim"], use_layernorm=cfg["use_layernorm"],
                            activation=cfg["activation"])
    model = fixed_init(plan, seed=0, device=dev)
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(lambda: nasrec_ref.FixedRef(cfg, vocab)),
                                  vocab)
    weights = make_weights(specs, seed, dev)
    model.load_state_dict(weights, strict=True)
    del weights
    training.setup_mark(rt, "model and weights")
    epoch_steps = cfg["train_examples"] // batch
    sched = make_lr_schedule(cfg["lr_schedule"], cfg["learning_rate"], epoch_steps,
                             int(epoch_steps * cfg["warmup_fraction"]))
    state = init_sparse_train_state(model, make_optimizer(cfg["optimizer"]))
    step = make_sparse_embedding_train_step(
        sched, optimizer=make_optimizer(cfg["optimizer"]), grad_clip=cfg["grad_clip"],
        l2_reg=cfg["wd"], impl="auto", table_impl="auto", compute_dtype=torch.float32)
    if "step" in rt.faults:
        step = faults.broken_step(step, rt.faults["step"])

    # The feed.
    spans = window.Spans()
    tmp = None
    sample_pos = None
    kept = {}
    if cell["source"] == "device":
        pool = [traffic.device_batch(seed, i, batch, vocab, cfg["num_dense"],
                                     cell["label_rate"], dev) for i in range(cell["pool_batches"])]

        def feed(pos):
            return pool[pos % len(pool)]
    else:
        from nasrec_tpu_torch.data.pipeline import (
            batch_iterator,
            device_prefetch,
            prefetch,
            shard_paths,
        )
        from nasrec_tpu_torch.data.transforms import get_transform

        t0 = time.perf_counter()
        shards = traffic.tsv_shards(seed, cell["tsv"], cfg["num_dense"], cfg["num_sparse"],
                                    cell["label_rate"], dev)
        tmp = tempfile.TemporaryDirectory(prefix="bench-tsv-")
        for s, text in enumerate(shards):
            os.makedirs(os.path.join(tmp.name, f"shard-{s}"))
            with open(os.path.join(tmp.name, f"shard-{s}", "trainval.txt"), "wb") as f:
                f.write(text)
        training.say(f"tsv: {sum(map(len, shards))} bytes in {len(shards)} shards, "
                     f"{time.perf_counter() - t0:.2f} s")
        paths = shard_paths(tmp.name, "trainval")
        transform = get_transform(cfg["dataset"], cell.get("vocab_cap"))
        passes = itertools.chain.from_iterable(
            batch_iterator(paths, batch, transform, use_native=True) for _ in itertools.count())
        host_stream = prefetch(passes)
        stream = device_prefetch(host_stream, dev)
        per_pass = cell["tsv"]["shards"] * (cell["tsv"]["rows_per_shard"] // batch)
        # One of the window's batches, in its first two passes, is held to the
        # reference's parse too.
        rng = np.random.default_rng(sub_seed(seed, "tsv-sample"))
        sample_pos = (cell["checked_steps"] + cell["warmup_steps"]
                      + int(rng.integers(0, 2 * per_pass)))

        def feed(pos):
            b = next(stream)
            if pos < cell["checked_steps"] or pos == sample_pos:
                kept[pos] = tuple(t.to("cpu", non_blocking=True) for t in b)
            return b

    def body(pos):
        t0 = time.perf_counter()
        with spans("next_batch"):
            b = feed(pos)
        t1 = time.perf_counter()
        with spans("step"):
            _, m = step(state, *b)
        return m["loss"], t1 - t0, time.perf_counter() - t1

    training.setup_mark(rt, "traffic")
    # Set-up: the checked steps, the warm-up, the FLOPs and bounds of a step.
    prog = training.checked_steps(
        body, lambda: slot_dicts(state.opt_state)[0],
        lambda: dict(model.named_parameters()), specs, seed, dev, cell["checked_steps"])
    training.setup_mark(rt, "checked steps")
    first = cell["checked_steps"]
    for i in range(cell["warmup_steps"]):
        body(first + i)
    first += cell["warmup_steps"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = rt.clock()
    training.say(f"setup_s {setup_s:.3f}")

    w = window.run_window(body, rt.seconds, cell["sync_every"], dev, first)
    peak = training.peak_bytes(dev)
    first += w["units"]
    e2e = training.train_e2e(w, batch, cell["metric_prefix"])
    e2e["setup_s"] = setup_s
    training.say(f"window: {w['units']} steps in {w['seconds']:.4f} s; peak {peak} bytes; "
                 f"{window.host_summary(w)}")

    layers, trace = {}, None
    if rt.trace:
        ref_meta = nasrec_ref.shapes_of(lambda: nasrec_ref.FixedRef(cfg, vocab))
        flops = _step_flops(ref_meta, cfg, batch)
        training.say(f"model FLOPs a step {flops:.6g} (forward and backward, batch {batch})")
        bodies, dots = _kernel_shapes(ref_meta)
        ctx = {"window": w, "flops_per_unit": flops, "examples_per_unit": batch,
               "device": dev, "cell": cell["name"]}
        # One checked batch's fused rows: the table update's touched rows.
        rows_b = (pool[0] if cell["source"] == "device" else kept[0])[1].to(dev)
        fused = rows_b + torch.as_tensor(ref_meta.embedding.offsets, device=dev,
                                         dtype=torch.int32)[None, :]
        unique = int(torch.unique(fused).numel())
        ctx["bounds_per_unit_s"] = sum(roofline.step_bounds(
            bodies, dots, batch, fused.numel(), unique).values())
        ctx["fused_rows"] = fused
        trace = window.profile_slice(body, cell["trace_steps"], spans, dev, first)
        ctx["trace"] = trace
        training.say(window.slice_summary(trace, w) + f"; bound a step "
                     f"{ctx['bounds_per_unit_s'] * 1e3:.6f} ms (bodies S={bodies}, dot "
                     f"n={dots}, {unique} touched rows)")
        layers = rt.read_layers(ctx)
        del ctx, fused
    attempted, failed = w["units"], w["nonfinite"]

    # The program's state goes; the reference follows the checked steps.
    kept_host = {k: tuple(t.clone() for t in v) for k, v in kept.items()}
    del state, model, step, body, feed
    if cell["source"] == "device":
        del pool
    else:
        stream.close()
        host_stream.close()
        del stream, host_stream
    training.free_device()
    t_ref = time.perf_counter()
    extra = {}
    if cell["source"] == "device":
        batches = [traffic.device_batch(seed, i, batch, vocab, cfg["num_dense"],
                                        cell["label_rate"], dev)
                   for i in range(cell["checked_steps"])]
    else:
        if sample_pos not in kept_host:
            raise RuntimeError(f"the window ended before its batch {sample_pos}, the one to "
                               "be checked against the reference's parse")
        batches, mismatch = [], 0
        for pos in sorted(kept_host):
            lines = traffic.tsv_batch_lines(shards, pos % per_pass, batch)
            ref_b = tsv_ref.parse(lines, cfg["num_dense"], vocab)
            mismatch += sum(int((torch.from_numpy(r) != p).sum())
                            for r, p in zip(ref_b, kept_host[pos]))
            if pos < cell["checked_steps"]:
                batches.append(tuple(torch.from_numpy(r).to(dev) for r in ref_b))
        extra["parse_mismatch"] = float(mismatch)
        tmp.cleanup()
    refr = reference(cfg, cell, seed, dev, batches)
    correct, checks = training.judge_training(prog, refr, cell["limits"], extra)
    training.say(f"reference and comparison: {time.perf_counter() - t_ref:.2f} s")
    return {"correct": correct, "checks": checks, "attempted": attempted, "failed": failed,
            "e2e": e2e, "layers": layers, "trace": trace, "memory_peak_bytes": peak}


def _step_flops(ref_meta, cfg, batch) -> float:
    """Matmul FLOPs of one training step of the reference at the cell's batch
    (forward and backward; blocks that nothing reads are not run), counted on
    the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        dense = torch.empty(batch, cfg["num_dense"])
        stem = torch.empty(batch, cfg["num_sparse"] * cfg["emb_dim"], requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        ref_meta.forward_stem(dense, stem).sum().backward()
    return float(fc.get_total_flops())


def _kernel_shapes(ref_meta):
    """The S of each live transformer node and the n of each live dot
    product: the launches a step of this subnet needs."""
    bodies, dots = [], []
    for blk, live in zip(ref_meta.blocks, ref_meta.live):
        if not live:
            continue
        for node in blk.nodes.values():
            if isinstance(node, nasrec_ref.Transformer):
                bodies.append(node.proj.out_features)
            elif isinstance(node, nasrec_ref.DotProduct):
                dots.append(1 + (node.slot_proj.out_features if node.slot_proj is not None
                                 else node.s_in))
    return bodies, dots


def reference(cfg, cell, seed, dev, batches, precision="f32"):
    """The reference's readings over `batches` from the seed's weights."""
    vocab = _vocab(cfg, cell)
    model_fn = lambda: nasrec_ref.FixedRef(cfg, vocab)
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(model_fn), vocab)
    epoch_steps = cfg["train_examples"] // cell["batch"]
    lr = lambda s: nasrec_ref.cosine_lr(s, epoch_steps, int(epoch_steps * cfg["warmup_fraction"]),
                                        cfg["learning_rate"])
    trainer = nasrec_ref.RefTrainer(nasrec_ref.build(model_fn, make_weights(specs, seed, dev)), lr,
                                    cfg["grad_clip"], cfg["adagrad_eps"], precision=precision)
    out = training.reference_readings(trainer, batches, specs, seed, dev)
    del trainer
    training.free_device()
    return out


def control_inputs(cfg, cell, seed, dev):
    """The checked steps' batches, as the reference makes or parses them."""
    vocab = _vocab(cfg, cell)
    if cell["source"] == "device":
        return [traffic.device_batch(seed, i, cell["batch"], vocab, cfg["num_dense"],
                                     cell["label_rate"], dev) for i in range(cell["checked_steps"])]
    shards = traffic.tsv_shards(seed, cell["tsv"], cfg["num_dense"], cfg["num_sparse"],
                                cell["label_rate"], dev)
    return [tuple(torch.from_numpy(a).to(dev) for a in tsv_ref.parse(
        traffic.tsv_batch_lines(shards, k, cell["batch"]), cfg["num_dense"], vocab))
        for k in range(cell["checked_steps"])]


gaps = compare.training_gaps
