"""The port's experiment launchers against the JAX package's: every shell
launcher under scripts/ has a counterpart under nasrec_tpu_torch/scripts/
with the same relative path and the same flags, run by the port's module;
each port launcher's flags parse with its CLI's parser (nothing is run); no
port launcher names a module of the JAX package.  The top-k script
(nasrec_tpu_torch/tools/eval_best_candidates_topk.py) against the JAX one
(scripts/eval_best_candidate/eval_best_candidates_topk.py) on the CPU: the
same two candidates, synthetic kdd data, batch 64, 3 train and 2 eval steps;
the same ranking, each val_loss within 1e-4 relative.
"""

import argparse
import importlib
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from nasrec_tpu_torch.choices import choice_to_json
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.tools import eval_best_candidates_topk as topk
from nasrec_tpu_torch.tools.launchers import LAUNCHER_DIR, launcher_commands, launchers

ROOT = Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "scripts"
JAX_LAUNCHERS = sorted(JAX_DIR.rglob("*.sh"))
SMOKE = "smoke_synthetic.sh"
# The port's smoke launcher writes into a fresh temporary directory where the
# JAX one writes into /tmp/nasrec_tpu_smoke.
SMOKE_DIRS = {"/tmp/nasrec_tpu_smoke": "$SMOKE_DIR",
              "/tmp/nasrec_tpu_smoke/supernet_checkpoint.pkl": "$SMOKE_DIR/supernet_checkpoint.pkl"}


def _rel(path):
    return path.relative_to(JAX_DIR).as_posix()


def _ported(module):
    return module.replace("nasrec_tpu.", "nasrec_tpu_torch.", 1)


def test_every_jax_launcher_has_a_port_counterpart():
    assert len(JAX_LAUNCHERS) == 18
    port = {p.relative_to(LAUNCHER_DIR).as_posix() for p in launchers()}
    missing = [_rel(p) for p in JAX_LAUNCHERS if _rel(p) not in port]
    assert not missing, missing
    # The one launcher more: the top-k script's, beside the JAX script's .py.
    assert port - {_rel(p) for p in JAX_LAUNCHERS} == {
        "eval_best_candidate/eval_best_candidates_topk.sh"}


@pytest.mark.parametrize("path", [p for p in JAX_LAUNCHERS if p.name != SMOKE], ids=_rel)
def test_port_launcher_has_the_jax_launchers_flags(path):
    (module, args), = launcher_commands(path)
    (port_module, port_args), = launcher_commands(LAUNCHER_DIR / _rel(path))
    assert module.startswith("nasrec_tpu.cli.")
    assert port_module == _ported(module)
    assert port_args == args


def test_smoke_launcher_runs_the_jax_smokes_commands_but_the_bench():
    jax_cmds = launcher_commands(JAX_DIR / SMOKE)
    port_cmds = launcher_commands(LAUNCHER_DIR / SMOKE)
    assert jax_cmds[-1] == ("bench.py", ["--smoke"])
    assert len(port_cmds) == len(jax_cmds) - 1 == 6
    for (module, args), (port_module, port_args) in zip(jax_cmds, port_cmds):
        assert port_module == _ported(module)
        assert port_args == [SMOKE_DIRS.get(a, a) for a in args]
    assert "bench.py" not in (LAUNCHER_DIR / SMOKE).read_text().replace(
        "`bench.py --smoke`", "")


@pytest.mark.parametrize("path", launchers(), ids=lambda p: p.relative_to(LAUNCHER_DIR).as_posix())
def test_port_launcher_flags_parse_with_the_ports_parser(path):
    for module, args in launcher_commands(path):
        assert module.startswith("nasrec_tpu_torch."), module
        mod = importlib.import_module(module)
        if args == ["$@"]:                   # the top-k launcher passes its own
            args = ["--ea_dir", "x"]
        if hasattr(mod, "build_parser"):
            ns = mod.build_parser().parse_args(args)
            assert ns.device == "cuda"       # the card is the default
        else:
            assert not args and callable(mod.main), module


@pytest.mark.parametrize("path", launchers(), ids=lambda p: p.relative_to(LAUNCHER_DIR).as_posix())
def test_no_port_launcher_names_the_jax_package(path):
    text = path.read_text()
    code = "\n".join(l for l in text.splitlines() if not l.lstrip().startswith("#"))
    assert "nasrec_tpu." not in code and "nasrec_tpu/" not in code
    assert "python -u -m nasrec_tpu_torch." in code


def _flags(parser):
    return {a.dest: (a.option_strings, a.default, a.type, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


def test_topk_script_has_the_jax_scripts_flags_and_hparams(monkeypatch):
    """The JAX script builds its parser inside main: it is caught at
    parse_args, before any work."""
    jax_script = _load_jax_script()
    assert topk.HPARAMS == jax_script.HPARAMS
    caught = []

    def catch(parser, args=None, namespace=None):
        caught.append(parser)
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(KeyboardInterrupt):
            jax_script.main([])
    port = _flags(topk.build_parser())
    assert port.pop("device") == (["--device"], "cuda", None, ["cuda", "cpu"], False)
    assert port == _flags(caught[0])


def _load_jax_script():
    path = JAX_DIR / "eval_best_candidate" / "eval_best_candidates_topk.py"
    spec = importlib.util.spec_from_file_location("jax_eval_best_candidates_topk", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_topk_script_ranks_as_the_jax_script(tmp_path, monkeypatch):
    """Each candidate of the port's run starts from the weights the JAX run
    initialised it with (transplanted, in the same order)."""
    from nasrec_tpu import workloads as jax_workloads

    from nasrec_tpu_torch import workloads
    from nasrec_tpu_torch.models.transplant import from_jax_params

    inits = []
    real_jax_init, real_init = jax_workloads.fixed_init, workloads.fixed_init

    def recording_jax_init(key, plan):
        inits.append(jax.device_get(real_jax_init(key, plan)))
        return inits[-1]

    def from_jax_init(plan, seed, device):
        model = real_init(plan, seed, device)
        model.load_state_dict(from_jax_params(inits.pop(0), plan))
        return model

    monkeypatch.setattr(jax_workloads, "fixed_init", recording_jax_init)
    monkeypatch.setattr(workloads, "fixed_init", from_jax_init)
    ea_dir = tmp_path / "ea"
    ea_dir.mkdir()
    for i, (dataset, space) in enumerate((("kdd", "autoctr"), ("criteo-kaggle", "autoctr"))):
        choice = get_best_arch(dataset, space)
        (ea_dir / f"best_config_{i}.json").write_text(
            choice_to_json(choice, num_blocks=len(choice["macro"]), config_name=space))
    common = ["--ea_dir", str(ea_dir), "--dataset", "kdd", "--data_source", "synthetic",
              "--top_k", "2", "--train_batch_size", "64", "--test_batch_size", "128",
              "--max_train_steps", "3", "--max_eval_steps", "2", "--test_interval", "3",
              "--learning_rate", "0.02"]
    want = _load_jax_script().main(common + ["--logging_root", str(tmp_path / "jax")])
    got = topk.main(common + ["--logging_root", str(tmp_path / "port"), "--device", "cpu"])
    assert len(got) == len(want) == 2 and not inits
    assert [r["candidate"] for r in got] == [r["candidate"] for r in want]
    np.testing.assert_allclose([r["val_loss"] for r in got], [r["val_loss"] for r in want],
                               rtol=1e-4)
    summary = json.loads((tmp_path / "port" / "summary_host0.json").read_text())
    assert summary == got
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        p.name for p in (tmp_path / "jax").iterdir()}
