"""DLRM-DCNv2's cell (`dcnv2.multihot`): its traffic (shapes, each column's
range, one batch from one seed), the 128-wide roofline arithmetic worked by
hand, its nine readers on a hand-made slice, and whole runs of its driver on
the CPU at a tiny size (correct on the port's plain path; not correct with
the step broken underneath, nor with the table alone left unchanged; the
reference in bf16 fails the comparison).
Marked `cuda`: the TF32 control at the cell's own size fails it, on the
card."""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import pytest
import torch

import run as bench_run
from lib import cell as C
from lib import multihot
from lib import roofline_wide as W

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CFG = json.loads((BENCH / "configs" / "criteo1tb-dcnv2.json").read_text())
MAIN = threading.main_thread().ident
TINY = {"cell": {"batch": 32, "pool_batches": 4, "sync_every": 4, "warmup_seconds": 0},
        "config": {"vocab_sizes": [min(v, 40) for v in CFG["vocab_sizes"]],
                   "dense_arch_layer_sizes": [64, 128], "dcn_low_rank_dim": 32,
                   "over_arch_layer_sizes": [64, 1]}}


def test_config_is_the_published_model_cut_to_a_4_way_row_share():
    assert sum(CFG["published_vocab_sizes"]) == 204_184_588
    assert CFG["vocab_sizes"] == [-(-v // 4) for v in CFG["published_vocab_sizes"]]
    assert sum(CFG["vocab_sizes"]) == 51_046_153 and sum(CFG["multi_hot_sizes"]) == 214
    assert (CFG["embedding_dim"], CFG["dcn_num_layers"], CFG["dcn_low_rank_dim"]) == (128, 3, 512)
    assert CFG["dense_arch_layer_sizes"] == [512, 256, 128]
    assert CFG["over_arch_layer_sizes"] == [1024, 1024, 512, 256, 1]


def test_traffic_shapes_and_slot_ranges():
    vocab, sizes = [5, 1, 40, 3], [1, 3, 7, 2]
    dense, ids, y = multihot.device_batch(7, 2, 500, vocab, sizes, 13, 0.25, "cpu")
    assert dense.shape == (500, 13) and ids.shape == (500, 13) and y.shape == (500, 1)
    assert ids.dtype == torch.int32 and set(y.unique().tolist()) <= {0.0, 1.0}
    rows = torch.as_tensor(multihot.column_rows(vocab, sizes))
    assert bool((ids >= 0).all()) and bool((ids < rows).all())
    assert bool((ids[:, 4:11].amax(0) == 39).all())          # the 40-row slot's ids reach its end
    again = multihot.device_batch(7, 2, 500, vocab, sizes, 13, 0.25, "cpu")
    other = multihot.device_batch(7, 3, 500, vocab, sizes, 13, 0.25, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((dense, ids, y), again))
    assert not torch.equal(ids, other[1])
    # Distinct rows: a slot's ids are its own rows.
    ids = torch.tensor([[0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2]], dtype=torch.int32)
    assert multihot.unique_rows(ids, vocab, sizes) == 4


def test_roofline_wide_by_hand():
    # 10 lookups, 4 touched rows, 3 bags: 4 * 512 + 40 + 3 * 512.
    assert W.lookup_bytes(10, 4, 3) == 3624
    assert W.segment_sum_bytes(10, 4, 3) == 3 * 512 + 40 + 4 * 512
    assert W.table_update_bytes(10, 4, 3) == 40 + 4 * 512 + 3 * 2048
    # The cell's step: 16384 rows, 3,506,176 lookups, 2.55 M touched rows.
    b, p, u = 16384, 3_506_176, 2_550_000
    assert W.bound_s(W.segment_sum_bytes(p, u, b * 26)) * 1e3 == pytest.approx(0.460, abs=0.005)
    assert W.bound_s(W.table_update_bytes(p, u, u)) * 1e3 == pytest.approx(1.953, abs=0.005)
    kernels = [("void (anonymous namespace)::segsum_tile128_kernel(int const*)", 0, 3000),
               ("void (anonymous namespace)::segsum_walk128_kernel(float const*)", 5000, 5500),
               ("void (anonymous namespace)::segsum_tile_kernel(int const*)", 6000, 9000),
               ("void (anonymous namespace)::table_update128_kernel(float*)", 9000, 9900)]
    assert W.kernels_s(kernels, W.SEGMENT_SUM_KERNELS) == pytest.approx(3.5e-6)
    assert W.kernels_s(kernels, W.TABLE_UPDATE_KERNELS) == pytest.approx(0.9e-6)


class Span:
    def __init__(self, name, start, end, parent=None, counts=None, dev=None):
        self.name, self.start_ns, self.end_ns = name, start, end
        self.parent, self.thread, self.counts, self._dev = parent, MAIN, counts, dev

    def device_ms(self):
        return self._dev


def _slice():
    """Two steps, each 1000 ns on the host; device ms by span."""
    log = []
    for k in range(2):
        t = k * 1000
        st = Span("train.step", t, t + 1000)
        fb = Span("train.forward_backward", t + 10, t + 600, st)
        log += [Span("train.lookup", t + 10, t + 50, fb, counts={"train.bag_positions": 100},
                     dev=0.02), Span("model.cross", t + 60, t + 200, fb, dev=0.5), fb,
                Span("train.segment_sum", t + 600, t + 700, st, dev=0.04),
                Span("train.table_update", t + 800, t + 900, st, dev=0.08), st]
    return log


KERNELS = [("segsum_tile128_kernel", 600, 630), ("segsum_walk128_kernel", 630, 640),
           ("table_update128_kernel", 800, 860), ("segsum_tile128_kernel", 1600, 1630),
           ("segsum_walk128_kernel", 1630, 1640), ("table_update128_kernel", 1800, 1860)]


def _ctx():
    return {"trace": {"kernels": KERNELS, "units": 2, "window_s": 2e-6, "busy_s": 1.5e-6,
                      "idle_gaps": [["step", 5e-7]]},
            "window": {"units": 10, "seconds": 0.5}, "flops_per_unit": 3.35e11,
            "unique_rows_slice": 120, "bags_per_unit": 26}


def test_readers_by_hand(monkeypatch):
    from nasrec_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", _slice)
    monkeypatch.setattr(tracing, "device_counts", lambda: {"train.rows_updated": 100})
    ctx = _ctx()
    read = {m: C.reader(m).read(ctx) for m in (
        "lookup_device_ms.dcn", "segment_sum_device_ms.dcn", "table_update_device_ms.dcn",
        "cross_device_ms.dcn", "lookup_roofline.dcn", "segment_sum_roofline.dcn",
        "table_update_roofline.dcn", "mfu.dcn", "idle_share.dcn")}
    assert read["lookup_device_ms.dcn"] == pytest.approx(0.02)
    assert read["segment_sum_device_ms.dcn"] == pytest.approx(0.04)
    assert read["table_update_device_ms.dcn"] == pytest.approx(0.08)
    assert read["cross_device_ms.dcn"] == pytest.approx(0.5)
    # 200 lookups, 120 touched rows, 52 bags over the slice.
    hbm = W.HBM_BYTES_S
    assert read["lookup_roofline.dcn"] == pytest.approx(
        100 * (120 * 512 + 800 + 52 * 512) / hbm / 40e-6)
    assert read["segment_sum_roofline.dcn"] == pytest.approx(
        100 * (52 * 512 + 800 + 120 * 512) / hbm / 80e-9)
    # 100 rows written of the 120 touched.
    assert read["table_update_roofline.dcn"] == pytest.approx(
        100 * (800 + 120 * 512 + 100 * 2048) / hbm / 120e-9)
    assert read["mfu.dcn"] == pytest.approx(100 * 3.35e12 / 0.5 / 67e12)
    assert read["idle_share.dcn"] == pytest.approx(25.0)


def test_readers_without_spans(monkeypatch):
    from nasrec_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "device_counts", lambda: {})
    ctx = _ctx()
    for name in ("lookup_device_ms.dcn", "segment_sum_device_ms.dcn",
                 "table_update_device_ms.dcn", "cross_device_ms.dcn", "lookup_roofline.dcn",
                 "segment_sum_roofline.dcn", "table_update_roofline.dcn"):
        assert C.reader(name).read(ctx) is None, name


def tiny_run(faults=None, seed=4294967311):
    over = {k: dict(v) for k, v in TINY.items()}
    over["faults"] = faults or {}
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", "dcnv2.multihot", "--seed", str(seed), "--seconds",
                             "0.5", "--trace", "0"], device="cpu", overrides=over)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct():
    result = tiny_run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_broken_step_is_not_correct(fault):
    assert not tiny_run({"step": fault})["correct"]


def test_table_left_unchanged_is_not_correct(monkeypatch):
    """The table update at lr 0 under the timed path: the accumulator moves
    and the table does not, so the first gradients agree.  The dense leaves'
    later steps see another table: the median leaf's change fails."""
    from nasrec_tpu_torch.train import sparse_embedding as se

    update = se.sparse_adagrad_table_update
    monkeypatch.setattr(se, "sparse_adagrad_table_update",
                        lambda t, a, r, s, lr, *x, **k: update(t, a, r, s, 0.0, *x, **k))
    result = tiny_run()
    check = result["checks"]["change_median_gap"]
    assert not result["correct"] and check["value"] > 10 * check["limit"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dcnv2.multihot",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bf16_control_fails():
    import control

    rows = control.main(["--workload", "dcnv2.multihot", "--seeds", "5", "6", "--precision",
                         "bf16"], device="cpu", overrides={k: dict(v) for k, v in TINY.items()})
    assert rows and not any(r["passes_limits"] for r in rows)


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(card):
    import control

    rows = control.main(["--workload", "dcnv2.multihot", "--seeds", "5", "6", "--precision",
                         "tf32"], device="cuda")
    assert not any(r["passes_limits"] for r in rows)
