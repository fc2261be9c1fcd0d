"""The multi-device layer's surface in the port: every flag of each JAX CLI
parses with the port's parser, the multi-process data options, the
bring-up's refusals, the two demos (as subprocesses on the CPU), and the
orbax-style directory checkpoints against what the JAX package restores."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nasrec_tpu_torch.parallel import distributed
from nasrec_tpu_torch.parallel.mesh import Mesh, make_mesh

ROOT = Path(__file__).resolve().parents[1]
CLIS = ("main_train", "train_supernet", "eval_subnet_from_supernet",
        "eval_subnet_from_scratch")
# The one flag of a JAX CLI the port rejects, and why: ROADMAP.md Queue C
# (the JAX from-scratch CLI takes it and never reads it).
REJECTED = {"eval_subnet_from_scratch": {"--use_final_sigmoid"}}


def _parsers(name):
    import importlib

    jax_cli = importlib.import_module(f"nasrec_tpu.cli.{name}")
    port_cli = importlib.import_module(f"nasrec_tpu_torch.cli.{name}")
    return jax_cli.build_parser(), port_cli.build_parser()


def _flags(parser):
    return [a for a in parser._actions if a.option_strings and a.dest != "help"]


def _value(action):
    """A valid, non-default command-line value for a flag."""
    if action.choices:
        others = [c for c in action.choices if c != action.default]
        return (others or list(action.choices))[0]
    if action.type is int:
        return (action.default or 0) + 1
    if action.type is float:
        return (action.default or 0.0) + 0.5
    return "some/path"


@pytest.mark.parametrize("name", CLIS)
def test_every_jax_flag_parses_with_the_ports_parser(name):
    jax_parser, port_parser = _parsers(name)
    skip = REJECTED.get(name, set())
    argv, want = [], {}
    for a in _flags(jax_parser):
        if a.option_strings[0] in skip:
            continue
        v = _value(a)
        argv += [a.option_strings[0], str(v)]
        want[a.dest] = v
    got = vars(port_parser.parse_args(argv))
    for dest, v in want.items():
        assert got[dest] == v, dest
    # ... and with the same defaults.
    defaults = vars(port_parser.parse_args([]))
    for a in _flags(jax_parser):
        if a.option_strings[0] not in skip:
            assert defaults[a.dest] == a.default, a.dest


def test_from_scratch_cli_rejects_use_final_sigmoid():
    _, port_parser = _parsers("eval_subnet_from_scratch")
    with pytest.raises(SystemExit):
        port_parser.parse_args(["--use_final_sigmoid", "1"])
    from nasrec_tpu_torch.cli import eval_subnet_from_scratch

    assert "--use_final_sigmoid" in eval_subnet_from_scratch.__doc__


@pytest.mark.parametrize("name", ("main_train", "train_supernet"))
def test_loss_function_bce_is_accepted(name):
    _, port_parser = _parsers(name)
    assert port_parser.parse_args(["--loss_function", "bce"]).loss_function == "bce"
    assert port_parser.parse_args([]).loss_function == "bce"
    with pytest.raises(SystemExit):
        port_parser.parse_args(["--loss_function", "mse"])


def _data_options(monkeypatch, argv, rank=0, world=1, globalized=True):
    from nasrec_tpu_torch.cli import common, main_train

    monkeypatch.setattr(distributed, "host_info", lambda: (rank, world))
    args = main_train.build_parser().parse_args(
        ["--train_batch_size", "64", "--test_batch_size", "128"] + argv)
    return common.data_options(args, globalized=globalized)


MP = ["--num_processes", "4", "--mesh_model", "2"]


@pytest.mark.parametrize("source,batches", [("synthetic", (64, 128)), ("tsv", (32, 64))])
def test_data_options_under_a_mesh(monkeypatch, source, batches):
    d = _data_options(monkeypatch, MP + ["--data_source", source, "--root_dir", "r"],
                      rank=3, world=4)
    # Rank 3 of a (data 2, model 2) mesh: data index 1 of 2 readers.
    assert (d.host_id, d.num_hosts) == (1, 2)
    assert (d.train_batch_size, d.test_batch_size) == batches


def test_data_options_refuse_a_num_hosts_other_than_the_data_size(monkeypatch):
    with pytest.raises(SystemExit, match="does not match the mesh's data size"):
        _data_options(monkeypatch, MP + ["--num_hosts", "4"], rank=0, world=4)


def test_data_options_refuse_batches_that_do_not_divide(monkeypatch):
    from nasrec_tpu_torch.cli import common, main_train

    monkeypatch.setattr(distributed, "host_info", lambda: (0, 4))
    args = main_train.build_parser().parse_args(
        MP + ["--train_batch_size", "63", "--test_batch_size", "128"])
    with pytest.raises(SystemExit, match="must divide evenly"):
        common.data_options(args)


def test_search_data_options_are_not_globalized(monkeypatch):
    d = _data_options(monkeypatch, MP + ["--data_source", "tsv", "--root_dir", "r"],
                      rank=3, world=4, globalized=False)
    assert (d.host_id, d.num_hosts, d.train_batch_size) == (0, 1, 64)


def test_globalized_synthetic_batches_are_sliced_by_data_index():
    from nasrec_tpu_torch.workloads import _globalize_iterators

    mesh = Mesh(data=2, model=2, rank=3)            # data index 1, model index 1
    batch = (torch.arange(64).reshape(64, 1), torch.zeros(64, 26), torch.ones(64, 1))
    train, _ = _globalize_iterators(mesh, lambda: iter([batch]), lambda: iter([]),
                                    slice_local=True)
    (x, _, _), = list(train())
    assert x[:, 0].tolist() == list(range(32, 64))
    train, _ = _globalize_iterators(mesh, lambda: iter([batch]), lambda: iter([]),
                                    slice_local=False)
    assert list(train())[0][0].shape[0] == 64


def test_bring_up_refusals_and_no_ops():
    assert distributed.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA card"):
            distributed.backend_for("cuda")
    distributed.initialize("127.0.0.1:1", num_processes=1, process_id=0, device="cpu")
    assert not torch.distributed.is_initialized() and distributed.host_info() == (0, 1)
    with pytest.raises(ValueError, match="--coordinator_address"):
        distributed.initialize(None, num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model=2"):
        make_mesh(model=2)
    assert make_mesh() == Mesh(1, 1)


def test_pad_table_for_sharding_matches_jax():
    from nasrec_tpu.parallel import pad_table_for_sharding as jax_pad

    from nasrec_tpu_torch.parallel.embedding import pad_table_for_sharding

    table = np.random.RandomState(0).randn(963, 16).astype(np.float32)
    for shards in (1, 2, 4):
        want = np.asarray(jax_pad({"table": table}, shards)["table"])
        np.testing.assert_array_equal(
            pad_table_for_sharding(torch.from_numpy(table), shards).numpy(), want)


@pytest.mark.parametrize("demo,marker", [("multihost_demo", "MULTIHOST_OK"),
                                         ("search_fanout_demo", "SEARCH_FANOUT_OK")])
def test_demo_prints_ok(demo, marker):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", f"nasrec_tpu_torch.tools.{demo}",
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert marker in proc.stdout, proc.stdout


# ---------------------------------------------------------------------------
# Orbax-style directory checkpoints
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix: tree}


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want) or set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("opt_name", ("adagrad", "adam"))
def test_directory_checkpoint_restores_what_jax_restores(tmp_path, opt_name):
    """The payload the supernet workload writes, saved and restored by each
    package's orbax backend: the same trees, arrays and sidecar."""
    import jax

    from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
    from nasrec_tpu.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu.train import make_optimizer
    from nasrec_tpu.train.checkpoint import load_any_checkpoint as jax_load
    from nasrec_tpu.train.checkpoint import save_checkpoint_any as jax_save
    from nasrec_tpu.workloads import SupernetOptions as JaxSupernetOptions

    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint, save_checkpoint_any

    pytest.importorskip("orbax.checkpoint")
    cfg = SuperNetConfig(space=JAX_OPS["autoctr"], num_blocks=2, num_dense=13, num_sparse=26,
                         vocab_sizes=(20,) * 26, attention_impl="xla")
    params = jax.device_get(supernet_init(jax.random.PRNGKey(0), cfg))
    opt = jax.device_get(make_optimizer(opt_name).init(params))
    payload = {"params": params, "opt_state": opt, "step": 4,
               "supernet": dataclasses.asdict(JaxSupernetOptions(num_blocks=2))}
    jax_save(str(tmp_path / "jax.orbax"), payload, "orbax")
    save_checkpoint_any(str(tmp_path / "port.orbax"), payload, "orbax")
    assert sorted(os.listdir(tmp_path / "port.orbax")) == ["arrays", "sidecar.json"]
    assert ((tmp_path / "port.orbax" / "sidecar.json").read_text()
            == (tmp_path / "jax.orbax" / "sidecar.json").read_text())
    _assert_same(load_any_checkpoint(str(tmp_path / "port.orbax")),
                 jax_load(str(tmp_path / "jax.orbax")))


@pytest.mark.parametrize("opt_name", ("adagrad", "adam"))
def test_supernet_resumes_from_its_directory_checkpoint(tmp_path, opt_name):
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint
    from nasrec_tpu_torch.workloads import (
        DataOptions,
        SupernetOptions,
        TrainOptions,
        train_supernet,
    )

    torch.set_num_threads(2)
    data = DataOptions(data_source="synthetic", train_batch_size=32, test_batch_size=64,
                       synthetic_train_examples=256, synthetic_test_examples=64,
                       synthetic_vocab=30)

    def run(steps, backend, logdir, resume=None):
        sn = SupernetOptions(config="autoctr", num_blocks=2, supernet_training_steps=2,
                             checkpoint_path=resume)
        train = TrainOptions(learning_rate=0.01, optimizer=opt_name, max_train_steps=steps,
                             max_eval_steps=1, test_interval=steps, device="cpu",
                             ckpt_backend=backend, logging_dir=str(tmp_path / logdir),
                             sparse_embedding=True)
        return train_supernet(sn, data, train, log_fn=lambda s: None)

    run(3, "orbax", "a")
    run(3, "pickle", "b")
    orb = load_any_checkpoint(str(tmp_path / "a" / "supernet_checkpoint.orbax"))
    pkl = load_any_checkpoint(str(tmp_path / "b" / "supernet_checkpoint.pkl"))
    assert int(orb["step"]) == int(pkl["step"]) == 3
    flat_o = _flat(orb["params"])
    for k, v in _flat(pkl["params"]).items():
        np.testing.assert_array_equal(flat_o[k], v, err_msg=k)
    resumed = run(2, "pickle", "c", resume=str(tmp_path / "a" / "supernet_checkpoint.orbax"))
    assert resumed["state"].step == 5
    with open(tmp_path / "c" / "configs_args.json") as f:
        assert json.load(f)["supernet"]["checkpoint_path"].endswith("supernet_checkpoint.orbax")
