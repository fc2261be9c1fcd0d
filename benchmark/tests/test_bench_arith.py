"""The yardstick's arithmetic on small shapes, against numbers worked out by
hand: roofline bounds, FLOP counts, percentiles, and the reduction of a
device trace to busy time, top operations and idle gaps."""

import math
from types import SimpleNamespace

import pytest
import torch

from lib import compare, roofline, window
from reference import nasrec_ref


def test_body_ops_by_hand():
    # S = 64: 3072 + 88 * 64 + 230 forward, 3 * 3072 + 200 * 64 + 500 backward.
    assert roofline.body_ops(64) == (3072 + 5632 + 230, 9216 + 12800 + 500)
    assert roofline.BODY_PARAM_FLOATS == 1696


def test_body_bound_by_hand():
    b, s = 32768, 64
    pos = b * s
    fwd_ops = (3072 + 88 * 64 + 230) * pos
    want = max(fwd_ops / 67e12, 8 * s * pos / (132 * 16 * 1.98e9),
               (2 * pos * 64 + pos * 96 + 2 * 1696 * 4) / 3.35e12)
    assert roofline.body_bounds(b, s)["body_fwd_train"] == pytest.approx(want)
    # The forward is bound by its operations at S = 64: 0.2796 ms.
    assert roofline.body_bounds(b, s)["body_fwd_train"] * 1e3 == pytest.approx(0.2796, abs=1e-4)


def test_dot_bound_by_hand():
    # n = 46 at batch 32768: bytes bind; forward reads 46 x 16 and writes 1035
    # floats a row: (736 + 1035) * 4 * 32768 / 3.35e12 s = 0.0693 ms.
    assert roofline.dot_bounds(32768, 46)["dot_fwd"] * 1e3 == pytest.approx(0.0693, abs=1e-4)
    assert roofline.dot_bounds(32768, 46)["dot_bwd"] * 1e3 == pytest.approx(0.0981, abs=1e-4)


def test_table_update_bound_by_hand():
    # 851,968 positions, 826,000 touched rows: 851968 * 68 + 826000 * 256 bytes.
    want = (851968 * 68 + 826000 * 256) / 3.35e12
    assert roofline.table_update_bound(851968, 826000) == pytest.approx(want)


def test_flop_count_of_a_linear_step():
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        lin = torch.nn.Linear(10, 20)
        x = torch.empty(4, 10)
    with FlopCounterMode(display=False) as fc:
        lin(x).sum().backward()
    assert fc.get_total_flops() == 2 * 4 * 10 * 20 * 2   # forward and the weight gradient


def test_dot_scores_lower_triangle():
    x = torch.tensor([[1.0, 0.0]])
    yt = torch.tensor([[[2.0, 0.0], [0.0, 3.0]]])          # two slots: (2, 0), (0, 3)
    # vectors (1, 0), (2, 0), (0, 3): pairs (1,0) 2, (2,0) 0, (2,1) 0
    assert nasrec_ref.dot_scores(x, yt).tolist() == [[2.0, 0.0, 0.0]]


def test_percentile():
    assert window.percentile([1, 2, 3, 4, 5], 50) == 3
    assert window.percentile(list(range(101)), 95) == 95
    assert window.percentile([10.0, 20.0], 95) == pytest.approx(19.5)


def _ev(name, start, end, cuda):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                           device_type=lambda: dt, is_user_annotation=lambda: False)


def test_trace_reduction():
    # Host clock: the slice from 1000 to 2000 ns; the trace's clock is 5000
    # ahead, tied by the synchronize calls that end the slice's two ends.
    events = [_ev("cudaDeviceSynchronize", 5900, 6000, False),
              _ev("k1", 6100, 6300, True), _ev("k2", 6200, 6400, True),
              _ev("k1", 6700, 6800, True), _ev("cudaDeviceSynchronize", 6850, 7000, False)]
    spans = [("step", 1000, 1600), ("next_batch", 1600, 2000)]
    r = window.reduce_trace(events, 2, spans, 1000, 2000)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(400e-9)           # [100, 400] and [700, 800]
    assert r["device_ops"][0] == ["k1", pytest.approx(300e-9)]
    assert r["anchor_drift_us"] == pytest.approx(0.0)
    gaps = dict(r["idle_gaps"])                            # 0-100, 400-700 in step, 800-1000
    assert gaps["step"] == pytest.approx(400e-9)
    assert gaps["next_batch"] == pytest.approx(200e-9)


def test_trace_without_device_work_fails():
    with pytest.raises(RuntimeError):
        window.reduce_trace([_ev("cudaDeviceSynchronize", 0, 10, False)], 1, [], 0, 10)


def test_leaf_gaps():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.001, "b": 2.0, "c": 5.0}
    counted = compare.counted_leaves(ref)
    assert counted == ["a", "b"]                           # c is under 1e-3 of the median
    assert compare.leaf_gap(prog, ref, counted) == pytest.approx(1e-3 / 1.5)
    ok, checks = compare.judge({"x": math.nan}, {"x": 1.0})
    assert not ok and math.isnan(checks["x"]["value"])
