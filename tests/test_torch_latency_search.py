"""The port's latency-aware search, the profiling flags of its training CLIs
and its device checks, on the host (mirrors tests/test_workloads.py's
latency tests of the JAX package).

- The regularized EA with criterion "test_loss_penalty_lat" and beta 0.5,
  once per estimator: every result carries a positive finite latency; the
  chip is calibrated once a process and the estimator called once a distinct
  plan; "measured" times the forward only in its own mode; the Searcher's
  objective on the same result dicts equals the JAX Searcher's.
- `--report_flops 1` prints the JAX package's FLOPS line (Params equal to the
  JAX count) and writes model_graph/; `--profile_dir` writes a trace;
  `--attention_impl xla` trains as `auto` does on the CPU, `pallas` raises.
- Both device checks refuse to run without a card.

Tolerance: none.  Counts, objectives and losses must be equal.
"""

import pickle
import re

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu import profiling as jprof
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import fixed as jfixed
from nasrec_tpu.search import SearchConfig as JaxSearchConfig
from nasrec_tpu.search import Searcher as JaxSearcher
from nasrec_tpu.search import Tokenizer as JaxTokenizer

from nasrec_tpu_torch import profiling, workloads
from nasrec_tpu_torch.cli import main_train
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.models.fixed import build_fixed_plan
from nasrec_tpu_torch.search import SearchConfig, Searcher, Tokenizer
from nasrec_tpu_torch.tools import body_device_check, sweep_device_check

BETA, TARGET = 0.5, 1e-3


def _data():
    return workloads.DataOptions(data_source="synthetic", train_batch_size=32,
                                 test_batch_size=64, synthetic_train_examples=256,
                                 synthetic_test_examples=128)


def _options(estimator="cost-model", **kw):
    return workloads.SearchOptions(
        method="regularized-ea", config="autoctr", num_blocks=2, max_train_steps=2,
        max_eval_steps=1, n_generations=2, n_childs=2, init_population=3, sample_size=2,
        ea_top_k=2, group_size=2, criterion="test_loss_penalty_lat", beta=BETA,
        target_latency=TARGET, latency_batch_size=32, latency_trials=8,
        latency_estimator=estimator, device="cpu", **kw)


@pytest.fixture
def counted(monkeypatch):
    """The profiling calls of the search, counted; calibration answers one
    fixed dict, and the process's calibration cache starts empty."""
    calls = {"calibrate": 0, "estimate": 0, "measure": 0}
    real_estimate, real_measure = (profiling.estimate_latency_cost_model,
                                   profiling.measure_latency)

    def calibrate(**kw):
        calls["calibrate"] += 1
        return {"matmul_flops_per_s": 1e12, "copy_bytes_per_s": 1e11}

    def estimate(*a, **k):
        calls["estimate"] += 1
        return real_estimate(*a, **k)

    def measure(*a, **k):
        calls["measure"] += 1
        return real_measure(*a, **k)

    monkeypatch.setattr(profiling, "calibrate_chip", calibrate)
    monkeypatch.setattr(profiling, "estimate_latency_cost_model", estimate)
    monkeypatch.setattr(profiling, "measure_latency", measure)
    monkeypatch.setattr(workloads, "_CALIBRATION", {})
    return calls


def _plan(result, so):
    return build_fixed_plan(result["choice"], OPS_CONFIG_LIB[so.config], so.num_blocks, 13, 26,
                            (1000,) * 26, use_layernorm=so.use_layernorm)


def _search(so, tmp_path):
    top = workloads.search_from_supernet(so, _data(), logging_dir=str(tmp_path),
                                         log_fn=lambda s: None)
    with open(tmp_path / "all_results.pickle", "rb") as f:
        return top, pickle.load(f)


@pytest.mark.parametrize("estimator", ["cost-model", "measured"])
def test_latency_search_runs_with_each_estimator(estimator, counted, tmp_path):
    so = _options(estimator)
    top, explored = _search(so, tmp_path)
    assert len(top) == 4 and len(explored) == 3 + 2 * 2
    for r in explored:
        assert np.isfinite(r["test_loss"])
        assert np.isfinite(r["latency"]) and r["latency"] > 0.0
    # Equal plans share a latency: the cache holds one number a plan.
    by_plan = {}
    for r in explored:
        assert by_plan.setdefault(_plan(r, so), r["latency"]) == r["latency"]
    if estimator == "cost-model":
        assert counted == {"calibrate": 1, "estimate": len(by_plan), "measure": 0}
    else:
        assert counted == {"calibrate": 0, "estimate": 0, "measure": len(by_plan)}


def test_calibration_runs_once_a_process(counted, tmp_path):
    _search(_options(), tmp_path / "a")
    _search(_options(seed=1), tmp_path / "b")
    assert counted["calibrate"] == 1


def test_latency_objective_equals_the_jax_searchers(counted, tmp_path):
    _, explored = _search(_options(), tmp_path)
    port = Searcher(lambda c: [], Tokenizer(2, OPS_CONFIG_LIB["autoctr"]),
                    SearchConfig(criterion="test_loss_penalty_lat", beta=BETA,
                                 target_latency=TARGET))
    jax_side = JaxSearcher(lambda c: [], JaxTokenizer(2, JAX_OPS["autoctr"]),
                           JaxSearchConfig(criterion="test_loss_penalty_lat", beta=BETA,
                                           target_latency=TARGET))
    assert [port._objective(r) for r in explored] == \
        [jax_side._objective(r) for r in explored]
    assert port._sort(explored) == jax_side._sort(explored)


def test_latency_estimator_rejects_unknown():
    with pytest.raises(ValueError, match="latency_estimator"):
        workloads.search_from_supernet(_options("bogus"), _data(), log_fn=lambda s: None)


def test_attention_impl_rejects_unknown():
    with pytest.raises(ValueError, match="attention_impl"):
        workloads.search_from_supernet(_options(attention_impl="triton"), _data(),
                                       log_fn=lambda s: None)


# --------------------------------------------------------------------------
# The training CLIs' profiling flags
# --------------------------------------------------------------------------

CLI = ["--arch", "criteo-kaggle/xlarge", "--data_source", "synthetic", "--device", "cpu",
       "--max_train_steps", "2", "--max_eval_steps", "1", "--train_batch_size", "32",
       "--test_batch_size", "64", "--display_interval", "1", "--test_interval", "2",
       "--learning_rate", "0.02"]


def test_report_flops_prints_the_jax_line_and_dumps_the_graph(tmp_path, capsys):
    out = main_train.main(CLI + ["--report_flops", "1", "--logging_dir", str(tmp_path)])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("FLOPS:")]
    assert len(lines) == 1
    m = re.fullmatch(r"FLOPS: ([0-9.]+) M/example \t Params: ([0-9.]+) M", lines[0])
    assert m is not None, lines[0]
    choice = jax_best_arch("criteo-kaggle", "xlarge")
    jplan = jfixed.build_fixed_plan(choice, JAX_OPS["xlarge"], 7, 13, 26, (1000,) * 26)
    jax_params = jprof.count_params(jfixed.fixed_init(jax.random.PRNGKey(0), jplan))
    assert m.group(2) == f"{jax_params / 1e6:.4f}"
    model = out["state"].model
    flops = profiling.count_flops(
        lambda d, c: model(d, c, impl="plain"), torch.zeros(1, 13),
        torch.zeros(1, 26, dtype=torch.int32))
    assert m.group(1) == f"{flops / 1e6:.4f}"
    graph = tmp_path / "model_graph"
    assert (graph / "modules.txt").read_text().startswith("FixedModel(")
    names = [l.split("\t")[0] for l in (graph / "parameters.txt").read_text().splitlines()]
    assert names == [n for n, _ in model.named_parameters()]


def test_profile_dir_writes_a_trace(tmp_path):
    out = main_train.main(CLI + ["--profile_dir", str(tmp_path / "prof")])
    assert out["state"].step == 2
    trace = tmp_path / "prof" / "trace.json"
    assert trace.is_file() and trace.stat().st_size > 0


def test_attention_impl_xla_trains_as_auto_on_the_cpu():
    logs = {impl: main_train.main(CLI + ["--attention_impl", impl])["logs"][0]
            for impl in ("auto", "xla")}
    assert logs["xla"]["train_loss"] == logs["auto"]["train_loss"]
    assert logs["xla"]["test_loss"] == logs["auto"]["test_loss"]


def test_attention_impl_pallas_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA kernel needs CUDA tensors"):
        main_train.main(CLI + ["--attention_impl", "pallas"])


@pytest.mark.parametrize("tool", [body_device_check, sweep_device_check])
def test_device_checks_refuse_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the check")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main()
