"""The readers of the program's spans against a hand-made span log and
device trace whose idle attribution, self time and per-unit values are
worked out by hand (`lib/program_spans.py`, the five readers that use it)."""

import threading

import pytest

from lib import cell as C
from lib import program_spans as P

MAIN = threading.main_thread().ident
PARSER = MAIN + 1


class Span:
    def __init__(self, name, start, end, parent=None, thread=MAIN, counts=None, dev=None):
        self.name, self.start_ns, self.end_ns = name, start, end
        self.parent, self.thread, self.counts, self._dev = parent, thread, counts, dev

    def device_ms(self):
        return self._dev


def _train_log():
    a = Span("train.step", 100, 1000)
    e = Span("train.step", 1100, 1200)
    return [Span("train.forward_backward", 110, 500, a),
            Span("train.segment_sum", 500, 700, a, dev=0.2), a,
            Span("data.queue_wait", 1000, 1060),
            Span("train.segment_sum", 1120, 1150, e, dev=0.4), e,
            Span("data.parse", 0, 1075, thread=PARSER, counts={"data.rows_parsed": 300}),
            Span("data.parse", 1090, 1590, thread=PARSER, counts={"data.rows_parsed": 200})]


TRAIN_KERNELS = [("k1", 150, 300), ("k2", 250, 400), ("k3", 600, 650), ("k4", 800, 1020),
                 ("k5", 1070, 1078), ("k6", 1082, 1095), ("k7", 1150, 1180), ("k8", 1250, 1300)]


def _search_log():
    g = Span("search.group", 0, 1000)
    f = Span("search.finetune", 10, 400, g)
    return [Span("train.step", 50, 100, f), f, Span("search.eval", 400, 600, g),
            Span("search.fetch", 600, 800, g), Span("search.score", 800, 990, g), g]


SEARCH_KERNELS = [("gemm", 20, 60), ("gemm", 70, 200), ("gemm", 250, 300), ("gemm", 420, 500),
                  ("Memcpy DtoH (Device -> Pageable)", 610, 650),
                  ("Memcpy DtoH (Device -> Pageable)", 700, 760)]


def _ctx(kernels, units):
    return {"trace": {"kernels": kernels, "units": units, "window_s": 2e-6, "busy_s": 1e-6,
                      "idle_gaps": [["step", 5e-7]]}}


def test_idle_attribution_by_hand():
    # The union [150,400] [600,650] [800,1020] [1070,1078] [1082,1095]
    # [1150,1180] [1250,1300], inside the main thread's spans, 100 to 1200; a
    # gap goes to the main thread's innermost span open where it begins, else
    # to another thread's, else to none.
    gaps = P.idle_gaps(TRAIN_KERNELS, _train_log(), MAIN)
    assert [(a, b, P.label(s, MAIN)) for a, b, s in gaps] == [
        (100, 150, "train.step"), (400, 600, "train.forward_backward"),
        (650, 800, "train.segment_sum"), (1020, 1070, "data.queue_wait"),
        (1078, 1082, P.OUTSIDE), (1095, 1150, "data.parse (another thread)"),
        (1180, 1200, "train.step")]
    assert P.idle_by_span(gaps, MAIN) == pytest.approx({
        "train.step": 70e-9, "train.forward_backward": 200e-9, "train.segment_sum": 150e-9,
        "data.queue_wait": 50e-9, P.OUTSIDE: 4e-9, "data.parse (another thread)": 55e-9})


def test_self_time_by_hand():
    # The steps 900 + 100 ns less their children 390 + 200 + 30.
    assert P.self_time(_train_log()) == pytest.approx({
        "train.step": 380e-9, "train.forward_backward": 390e-9, "train.segment_sum": 230e-9,
        "data.queue_wait": 60e-9, "data.parse": 1575e-9})


def test_train_readers_by_hand(monkeypatch, capsys):
    from nasrec_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", _train_log)
    ctx = _ctx(TRAIN_KERNELS, 2)
    assert C.reader("segment_sum_device_ms.train").read(ctx) == pytest.approx(0.3)
    assert C.reader("queue_wait_ms.tsv").read(ctx) == pytest.approx(1e3 * 60e-9 / 2)
    # 500 rows in 1575 ns of whole parse spans.
    assert C.reader("parse_rows_per_s.tsv").read(ctx) == pytest.approx(500 / 1575e-9)
    assert C.reader("score_ms.search").read(ctx) is None
    err = capsys.readouterr().err
    assert err.count("idle s by span") == 1                     # one block a slice
    # 525 ns in program spans against the benchmark's 500.
    assert "s (105.0 %)" in err


def test_search_readers_by_hand(monkeypatch, capsys):
    from nasrec_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", _search_log)
    ctx = _ctx(SEARCH_KERNELS, 1)
    # Gaps begun under search.finetune: 60-70 (its child), 200-250, 300-420.
    assert C.reader("finetune_idle_ms.search").read(ctx) == pytest.approx(180e-6)
    assert C.reader("score_ms.search").read(ctx) == pytest.approx(190e-6)
    assert C.reader("segment_sum_device_ms.train").read(ctx) is None
    # search.fetch ends at 800, its last copy at 760.
    assert P.fetch_offsets_us(SEARCH_KERNELS, _search_log()) == [pytest.approx(0.04)]
    assert "search.fetch ends 0.0 to 0.0 us" in capsys.readouterr().err
    # With the score opened at 810: a copy that the trace places after the
    # fetch's end, before the score, is the fetch's (800 - 805 reads -0.005
    # us); one after the score's start is not.
    log = [sp for sp in _search_log() if sp.name != "search.score"]
    log.append(Span("search.score", 810, 990, log[-1]))
    late = SEARCH_KERNELS + [("Memcpy DtoH (Device -> Pageable)", 801, 805),
                             ("Memcpy DtoH (Device -> Pageable)", 900, 910)]
    assert P.fetch_offsets_us(late, log) == [pytest.approx(-0.005)]


def test_h2d_offsets_by_hand():
    spans = [Span("data.h2d", 100, 150), Span("data.h2d", 300, 350)]
    copies = [("Memcpy HtoD (Pinned -> Device)", s, s + 5) for s in (110, 120, 130, 320, 330, 340)]
    assert P.h2d_offsets_us(copies, spans) == pytest.approx([0.01, 0.02, 0.03, 0.02, 0.03, 0.04])
    assert P.h2d_offsets_us(copies[:5], spans) is None


def test_readers_without_spans(monkeypatch):
    from nasrec_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [])
    ctx = _ctx(TRAIN_KERNELS, 2)
    for name in ("queue_wait_ms.tsv", "parse_rows_per_s.tsv", "segment_sum_device_ms.train",
                 "score_ms.search", "finetune_idle_ms.search"):
        assert C.reader(name).read(ctx) is None
