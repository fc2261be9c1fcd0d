"""The port's span-and-counter recorder (`nasrec_tpu_torch/tracing.py`) on the
CPU: off outside a profiler; under a CPU `torch.profiler`, the phases of the
sparse step, the search group and the TSV input path with their parents,
the prefetch thread's parse spans and row counts, each span's start against
the profiler's own event of the same name, and the trace that `--profile_dir`
writes; and the training loop's rate line."""

import contextlib
import json
import re
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
from nasrec_tpu_torch.train.optim import make_lr_schedule
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)

STEP_SPANS = ["train.forward_backward", "train.segment_sum", "train.clip",
              "train.dense_update", "train.table_update"]


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def _fixed_step(microbatch=1):
    vocab = [30] * 26
    plan = build_fixed_plan(get_best_arch("criteo-kaggle", "autoctr"), OPS_CONFIG_LIB["autoctr"],
                            7, 13, 26, vocab)
    model = fixed_init(plan, seed=0, device="cpu")
    state = init_sparse_train_state(model)
    step = make_sparse_embedding_train_step(make_lr_schedule("constant", 0.05, 10, 0),
                                            microbatch=microbatch)
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randn(16, 13).astype(np.float32)),
             torch.from_numpy(np.stack([rng.randint(0, 30, 16) for _ in vocab], 1)
                              .astype(np.int32)),
             torch.from_numpy(rng.randint(0, 2, (16, 1)).astype(np.float32)))
    return lambda: step(state, *batch)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing():
    assert not tracing.enabled()
    cm = tracing.span("train.step", device=True)
    assert isinstance(cm, contextlib.nullcontext)
    with cm as got:
        tracing.count("data.rows_parsed", 5)
    assert got is None
    _fixed_step()()
    assert tracing.spans() == []


def test_device_counter_only_under_a_profiler():
    """Off, there is no counter; on, one int64 a name and device, kept until
    `clear`, read by `device_counts`; the one-hot step asks for none."""
    assert tracing.device_counter("train.rows_updated", "cpu") is None
    with profile(activities=[ProfilerActivity.CPU]):
        c = tracing.device_counter("train.rows_updated", "cpu")
        c += 3
        assert tracing.device_counter("train.rows_updated", "cpu") is c
        _fixed_step()()
    assert c.dtype == torch.int64 and c.shape == (1,)
    assert tracing.device_counts() == {"train.rows_updated": 3}
    tracing.clear()
    assert tracing.device_counts() == {}


def test_parser_thread_sees_the_profiler():
    """A thread started before the profiler, as the prefetch thread is,
    learns that the recorder is on from torch's process-wide flag; the
    profiler's own state is the profiling thread's alone."""
    go, done, seen = threading.Event(), threading.Event(), {}

    def worker():
        go.wait()
        seen["recorder"] = tracing.enabled()
        seen["profiler_state"] = torch.autograd._profiler_enabled()
        with tracing.span("data.parse"):
            tracing.count("data.rows_parsed", 7)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled() and torch.autograd._profiler_enabled()
        go.set()
        done.wait(30)
    t.join()
    assert seen == {"recorder": True, "profiler_state": False}
    (s,) = tracing.spans()
    assert s.name == "data.parse" and s.thread == t.ident and s.parent is None
    assert s.counts == {"data.rows_parsed": 7}
    assert not tracing.enabled()


@pytest.mark.parametrize("microbatch", [1, 2])
def test_step_spans_nest_and_match_the_profiler(microbatch):
    """The step's phases nest under `train.step`, and each span starts within
    1 ms of the profiler's own event of the same name: one clock.  A shared
    CPU can preempt the step between the two stamps, so the step is profiled
    up to three times, and one of them must hold every span within 1 ms."""
    run = _fixed_step(microbatch)
    run()                                           # warm, not recorded
    for _ in range(3):
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        by = _by_name(tracing.spans())
        (top,) = by.pop("train.step")
        assert top.parent is None
        assert sorted(by) == sorted(STEP_SPANS)
        children = [by[n][0] for n in STEP_SPANS]
        assert all(len(by[n]) == 1 and by[n][0].parent is top for n in STEP_SPANS)
        assert [c.start_ns for c in children] == sorted(c.start_ns for c in children)
        assert all(top.start_ns <= c.start_ns <= c.end_ns <= top.end_ns for c in children)
        assert children[1].device_ms() is None           # no CUDA events on the CPU
        events = {e.name(): e for e in prof.profiler.kineto_results.events()}
        apart = {s.name: abs(events[s.name].start_ns() - s.start_ns) for s in [top] + children}
        if max(apart.values()) < 1_000_000:
            break
    assert max(apart.values()) < 1_000_000, apart


def test_search_group_spans():
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.sampling import ChoiceSampler
    from nasrec_tpu_torch.search.worker import make_candidate_evaluator

    cfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], num_blocks=2, num_dense=13,
                         num_sparse=26, vocab_sizes=(40,) * 26)
    net = supernet_init(cfg, 0, "cpu")
    sampler = ChoiceSampler(cfg.space, 2, anypath_choice="binomial-0.5", seed=1)
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn(32, 13, generator=g), torch.randint(0, 40, (32, 26), generator=g,
                                                             dtype=torch.int32),
             torch.randint(0, 2, (32, 1), generator=g).float())
    ev = make_candidate_evaluator(cfg, net, max_train_steps=2, max_eval_steps=1,
                                  eval_batch_chunk=16)
    with profile(activities=[ProfilerActivity.CPU]):
        ev([sampler() for _ in range(2)], lambda: iter([batch]), lambda: iter([batch]))
    by = _by_name(tracing.spans())
    (top,) = by.pop("search.group")
    phases = ["search.finetune", "search.eval", "search.fetch", "search.score"]
    assert sorted(by) == sorted(phases)
    got = [by[n][0] for n in phases]
    assert all(s.parent is top for s in got)
    assert [s.start_ns for s in got] == sorted(s.start_ns for s in got)
    assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("which", ["hand-written", "all-on"])
def test_search_gemm_macs_counters(which):
    """`search.gemm_macs_run` and `search.gemm_macs_masked` in the group's
    fine-tune and eval spans: the multiply-adds of the pruned body's cut
    GEMMs and of the same GEMMs in the masked forward, a forward's rows
    times each candidate's products, written out here for a 2-block xlarge
    supernet (block 0: 13 dense columns and 26 slots in; block 1: 13 + 1024
    and 26 + 64 + 8).  For the all-on choice the two are equal."""
    from nasrec_tpu_torch.choices import full_path_choice
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.search.worker import make_candidate_evaluator

    cfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], num_blocks=2, num_dense=13,
                         num_sparse=26, vocab_sizes=(40,) * 26)
    net = supernet_init(cfg, 0, "cpu")
    d1, s1 = 13 + 1024, 26 + 64 + 8
    masked = (13 * 1024 + 13 * 1024 + 13 * 13 + 1024 * 13 + 16 * 26 * 64 + 128 * 1024
              + 1024 * 16
              + d1 * 1024 + d1 * 1024 + d1 * d1 + 1024 * d1 + 16 * s1 * 64 + 128 * 1024
              + 1024 * 16)
    if which == "all-on":
        choice, run = full_path_choice(cfg.space, 2), masked
    else:
        # block 0: linear-2d over the 13 dense inputs at width 64, linear-3d
        # over the 26 stem slots, the merge on, no deep-fm; block 1:
        # sigmoid-gating of the dense input (13 columns) by block 0's 64
        # columns, the transformer, deep-fm on, no merge
        choice = {"macro": [
            {"dense_idx": [0], "sparse_idx": [0], "dense_left_idx": [0], "dense_right_idx": [0]},
            {"dense_idx": [1], "sparse_idx": [0, 1], "dense_left_idx": [0],
             "dense_right_idx": [1]}],
            "micro": [
            {"active_nodes": [0, 5], "dense_in_dims": 64, "sparse_in_dims": 16,
             "dense_sparse_interact": 1, "deep_fm": 0},
            {"active_nodes": [2, 4], "dense_in_dims": 128, "sparse_in_dims": 32,
             "dense_sparse_interact": 0, "deep_fm": 1}]}
        run = (13 * 1024 + 16 * 26 * 64 + 64 * 128
               + 64 * 13 + 1024 * 64 + 1024 * 16)
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn(32, 13, generator=g), torch.randint(0, 40, (32, 26), generator=g,
                                                             dtype=torch.int32),
             torch.randint(0, 2, (32, 1), generator=g).float())
    ev = make_candidate_evaluator(cfg, net, max_train_steps=2, max_eval_steps=1,
                                  eval_batch_chunk=16)
    with profile(activities=[ProfilerActivity.CPU]):
        ev([choice], lambda: iter([batch]), lambda: iter([batch]))
    by = _by_name(tracing.spans())
    for name, rows in (("search.finetune", 2 * 32), ("search.eval", 32)):
        (span,) = by[name]
        assert dict(span.counts) == {"search.gemm_macs_run": rows * run,
                                     "search.gemm_macs_masked": rows * masked}, name
    assert by["search.group"][0].counts is None


def test_tsv_path_spans_and_counts(tmp_path):
    from nasrec_tpu_torch.data.native import binding
    from nasrec_tpu_torch.data.pipeline import batch_iterator, prefetch, shard_paths
    from nasrec_tpu_torch.data.synthetic import write_tsv_shards
    from nasrec_tpu_torch.data.transforms import get_transform

    assert binding.native_available(), binding.build_error()
    write_tsv_shards(str(tmp_path), 13, 26, {"trainval": 300}, 2)
    paths = shard_paths(str(tmp_path), "trainval")
    with profile(activities=[ProfilerActivity.CPU]):
        stream = prefetch(batch_iterator(paths, 50, get_transform("criteo-kaggle", 1000),
                                         use_native=True))
        got = sum(len(b[2]) for b in stream)
    assert got == 300
    by = _by_name(tracing.spans())
    main = threading.get_ident()
    parser = {s.thread for n in ("data.read", "data.parse") for s in by[n]}
    assert len(parser) == 1 and main not in parser
    assert len(by["data.parse"]) == 2 and len(by["data.read"]) == 4   # a chunk, then EOF
    assert sum(s.counts["data.rows_parsed"] for s in by["data.parse"]) == 300
    assert all(s.counts is None for n in ("data.read", "data.queue_wait") for s in by[n])
    waits = by["data.queue_wait"]
    assert len(waits) == 6 + 1 and all(s.thread == main and s.parent is None for s in waits)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    from nasrec_tpu_torch.workloads import _MaybeProfile

    run = _fixed_step()
    with _MaybeProfile(str(tmp_path)):
        run()
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert {"train.step", *STEP_SPANS} <= names


@pytest.mark.parametrize("display_interval", [1, 3])
def test_rate_line_counts_training_steps_only(monkeypatch, display_interval):
    """The epoch loop's ex/s: the eval's time is taken out, and the steps
    queued before an eval that no display step synced are counted."""
    from nasrec_tpu_torch.train import loop

    clock = {"t": 0.0, "queued": 0.0}
    monkeypatch.setattr(loop.time, "perf_counter", lambda: clock["t"])

    def sync():
        clock["t"] += clock["queued"]
        clock["queued"] = 0.0

    class Loss:                                              # reading it waits for the card
        def __float__(self):
            sync()
            return 0.5

    def train_step(state, dense, cat, y):
        clock["queued"] += 0.5                               # a step: 0.5 s on the card
        return state, {"loss": Loss(), "l2": 0.0, "lr": 0.1,
                       "logits": torch.zeros(len(y), 1)}

    def evaluate(*a, **k):
        sync()
        clock["t"] += 100.0                                  # an eval: 100 s
        return 0.5, 0.5, 0.5

    monkeypatch.setattr(loop, "evaluate_one_epoch", evaluate)
    monkeypatch.setattr(loop, "snapshot_params", lambda m: None)
    y = torch.tensor([[0.0], [1.0]] * 5)
    batches = [(None, None, y)] * 4
    lines = []
    loop.train_and_test_one_epoch(train_step, None, loop.TrainState(None, None, 0), batches,
                                  lambda: [], display_interval=display_interval, test_interval=2,
                                  max_train_steps=4, log_fn=lines.append)
    rates = [float(m) for m in re.findall(r"\((\d+) ex/s\)", "\n".join(lines))]
    assert rates == [20.0] * len(range(0, 4, display_interval))  # 10 examples a 0.5 s step
