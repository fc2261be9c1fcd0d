"""The port's workloads on TSV shards against the JAX package's on the same
files, and checkpoints with SGD and Adam state across the two packages.

`train_fixed_subnet` on a 3-shard criteo-shaped root (vocab capped at 1000,
batch 64, the test split's last batch short) from the JAX package's initial
weights, through the sparse step (Adagrad) and the dense step (Adam): the
train loss of every step and the test metrics within rtol 1e-4 / atol 1e-5.

At lr 1e-3 Adam diverges on these shards in both packages (train loss 28.5,
14.2, 951), and f32 rounding grows about 25 times a step along the way (2e-7,
5.4e-6, 1.3e-4 between the packages' losses).  One step from the same
parameters and Adam state agrees to f32 rounding (the third: loss 6.4e-8
apart, parameters 5.6e-8, moments 7e-7 of their largest), so each dense
step of the port starts from the JAX run's state before that step: the
comparison holds the update, not the divergence's amplification of rounding.
"""

import jax
import jax_parser_once  # noqa: F401  (the JAX parser built and loaded under a file lock)
import numpy as np
import pytest
import torch

from nasrec_tpu import workloads as jax_workloads
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import build_fixed_plan as jax_build_plan
from nasrec_tpu.models import fixed_init as jax_fixed_init
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.train import make_optimizer as jax_make_optimizer
from nasrec_tpu.train import optim as jax_optim
from nasrec_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from nasrec_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from nasrec_tpu_torch import workloads
from nasrec_tpu_torch.config import DATASETS
from nasrec_tpu_torch.data.synthetic import write_tsv_shards
from nasrec_tpu_torch.models.transplant import from_jax_opt_state, from_jax_params
from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint
from nasrec_tpu_torch.train.optim import AdamState, SGDState, slot_dicts

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
CAP = 1000


@pytest.fixture(scope="module")
def tsv_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tsv")
    write_tsv_shards(str(root), 13, 26, {"trainval": 3 * 200, "test": 3 * 90}, 3, seed=7)
    return str(root)


def _options(pkg, root, **train):
    data = pkg.DataOptions(root_dir=root, vocab_cap=CAP, train_batch_size=64,
                           test_batch_size=64)
    train = pkg.TrainOptions(max_train_steps=3, display_interval=1, test_interval=2,
                             **train)
    return data, train


@pytest.mark.parametrize("optimizer,lr", [("adagrad", 0.02), ("adam", 1e-3)])
def test_train_fixed_subnet_on_tsv_matches_jax(tsv_root, monkeypatch, optimizer, lr):
    payload = {**jax_best_arch("criteo-kaggle", "autoctr"), "config": "autoctr"}
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(CAP)
    jplan = jax_build_plan(payload, JAX_OPS["autoctr"], 7, 13, 26, vocab, attention_impl="xla")
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(0), jplan))

    def from_jax_init(plan, seed, device):
        model = real_init(plan, seed, device)
        model.load_state_dict(from_jax_params(params, plan))
        return model

    real_init = workloads.fixed_init
    monkeypatch.setattr(workloads, "fixed_init", from_jax_init)
    # The dense step (Adam): the JAX run's state before each step, and the
    # state after its last, on the host.
    jax_states = []

    def jax_recording_step(*args, **kwargs):
        jstep = real_jax_step(*args, **kwargs)

        def step(state, *batch):
            jax_states.append(jax.device_get(state))
            new, metrics = jstep(state, *batch)
            jax_states.append(jax.device_get(new))
            return new, metrics

        return step

    def port_step_from_jax_state(*args, **kwargs):
        tstep = real_port_step(*args, **kwargs)

        def step(state, *batch):
            start = jax_states[2 * state.step]
            assert int(start.step) == state.step
            state.model.load_state_dict(from_jax_params(start.params, state.model.plan))
            state.opt_state = from_jax_opt_state(start.opt_state, state.model.plan)
            return tstep(state, *batch)

        return step

    real_jax_step, real_port_step = jax_workloads.make_train_step, workloads.make_train_step
    monkeypatch.setattr(jax_workloads, "make_train_step", jax_recording_step)
    monkeypatch.setattr(workloads, "make_train_step", port_step_from_jax_state)
    kw = dict(learning_rate=lr, optimizer=optimizer)
    want = jax_workloads.train_fixed_subnet(payload, *_options(jax_workloads, tsv_root, **kw),
                                            log_fn=lambda s: None)["logs"][0]
    said = []
    got = workloads.train_fixed_subnet(
        payload, *_options(workloads, tsv_root, device="cpu", **kw), log_fn=said.append)
    assert got["state"].step == 3
    sparse = optimizer == "adagrad"
    assert isinstance(got["state"].opt_state, AdamState) != sparse
    assert len(jax_states) == (0 if sparse else 6)
    logs = got["logs"][0]
    assert len(logs["train_loss"]) == 3 and len(logs["test_loss"]) == 2
    for key in ("train_loss", "test_loss", "test_AUROC", "test_Accuracy"):
        np.testing.assert_allclose(logs[key], want[key], err_msg=key, **TOL)
    if not sparse:      # the last step's update, from the JAX state before it
        plan = got["state"].model.plan
        want_p = from_jax_params(jax_states[-1].params, plan)
        want_s = from_jax_opt_state(jax_states[-1].opt_state, plan)
        for name, t in got["state"].model.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want_p[name].numpy(), err_msg=name, **TOL)
        for got_slot, want_slot in zip(slot_dicts(got["state"].opt_state), slot_dicts(want_s)):
            for name, t in want_slot.items():
                np.testing.assert_allclose(got_slot[name].numpy(), t.numpy(), err_msg=name,
                                           **TOL)


def test_tsv_epoch_ends_with_the_stream(tsv_root):
    """train_limit sets the steps an epoch (600 rows / 64); a limit beyond the
    stream ends the epoch when the shards run out, as the JAX loop ends it."""
    data, train = _options(workloads, tsv_root, device="cpu", learning_rate=0.02)
    train.max_train_steps, train.test_only_at_last_step = -1, True
    for limit, steps in ((320, 5), (10_000, 9)):
        train.train_limit = limit
        assert workloads._train_steps_per_epoch(data, train) == limit // 64
        said = []
        out = workloads.train_fixed_subnet(
            {**jax_best_arch("criteo-kaggle", "autoctr"), "config": "autoctr"},
            data, train, log_fn=said.append)
        assert out["state"].step == steps
        # 3 shards of 200 rows: 3 whole batches each, the short ones dropped.
        assert any(s == f"Batch counter total: {steps - 1}" for s in said) == (steps == 9)


def _supernet_cfg():
    return JaxSuperNetConfig(space=JAX_OPS["autoctr"], num_blocks=1, num_dense=13,
                             num_sparse=26, vocab_sizes=(50,) * 26, use_layernorm=True,
                             attention_impl="xla")


def test_jax_checkpoint_with_adam_and_sgd_state_loads_in_the_port(tmp_path):
    from nasrec_tpu_torch.models.supernet import SuperNetConfig
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB

    jcfg = _supernet_cfg()
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.RandomState(0)
    noisy = lambda tree: jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), tree)
    adam = jax_optim.AdamState(noisy(params), noisy(params), np.asarray(7, np.int32))
    sgd = jax_optim.SGDState(noisy(params))
    jax_save_checkpoint(str(tmp_path / "c.pkl"), {"params": params, "opt_state": adam,
                                                  "sgd": sgd, "step": 7})
    ckpt = load_any_checkpoint(str(tmp_path / "c.pkl"))
    assert type(ckpt["opt_state"]) is AdamState and type(ckpt["sgd"]) is SGDState
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB["autoctr"], num_blocks=1, num_dense=13,
                          num_sparse=26, vocab_sizes=(50,) * 26, use_layernorm=True)
    got = from_jax_opt_state(ckpt["opt_state"], tcfg)
    want_mu = from_jax_params(adam.mu, tcfg)
    assert int(got.count) == 7 and set(got.mu) == set(want_mu)
    for name in want_mu:
        np.testing.assert_array_equal(got.mu[name].numpy(), want_mu[name].numpy())
    got_sgd = from_jax_opt_state(ckpt["sgd"], tcfg)
    np.testing.assert_array_equal(got_sgd.momentum["embedding.table"].numpy(),
                                  sgd.momentum["embedding"]["table"])


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_port_checkpoint_with_optimizer_state_resumes_in_both_packages(tmp_path, monkeypatch,
                                                                      optimizer):
    """The port's train_supernet writes the JAX package's SGDState/AdamState
    by name; the JAX package loads it and resumes from it, and so does the
    port, with every slot restored."""
    sn = workloads.SupernetOptions(config="autoctr", num_blocks=1, supernet_training_steps=0)
    data = workloads.DataOptions(data_source="synthetic", train_batch_size=16,
                                 test_batch_size=32, synthetic_vocab=50)
    train = workloads.TrainOptions(max_train_steps=2, max_eval_steps=1, test_interval=2,
                                   device="cpu", optimizer=optimizer, learning_rate=1e-3,
                                   logging_dir=str(tmp_path / "port"))
    out = workloads.train_supernet(sn, data, train, log_fn=lambda s: None)
    path = tmp_path / "port" / "supernet_checkpoint.pkl"
    with open(path, "rb") as f:
        raw = f.read()
    assert b"nasrec_tpu.train.optim" in raw and b"nasrec_tpu_torch.train.optim" not in raw

    ckpt = jax_load_checkpoint(str(path))
    kind = {"adam": jax_optim.AdamState, "sgd": jax_optim.SGDState}[optimizer]
    assert type(ckpt["opt_state"]) is kind and ckpt["step"] == 2
    init = jax_make_optimizer(optimizer).init(ckpt["params"])
    assert (jax.tree_util.tree_structure(ckpt["opt_state"])
            == jax.tree_util.tree_structure(init))
    if optimizer == "adam":
        assert ckpt["opt_state"].count.dtype == np.int32 and int(ckpt["opt_state"].count) == 2
    jsn = jax_workloads.SupernetOptions(config="autoctr", num_blocks=1,
                                        supernet_training_steps=0, checkpoint_path=str(path))
    jdata = jax_workloads.DataOptions(data_source="synthetic", train_batch_size=16,
                                      test_batch_size=32, synthetic_vocab=50)
    jtrain = jax_workloads.TrainOptions(max_train_steps=1, max_eval_steps=1, test_interval=1,
                                        optimizer=optimizer, learning_rate=1e-3)
    said = []
    jout = jax_workloads.train_supernet(jsn, jdata, jtrain, log_fn=said.append)
    assert any("at step 2" in s for s in said) and int(jout["state"].step) == 3

    def first_state(step, eval_step, state, *a, **k):   # the resumed state, untrained
        seen.append(state)
        return state, {}, None

    seen = []
    monkeypatch.setattr(workloads, "train_and_test_one_epoch", first_state)
    workloads.train_supernet(
        workloads.SupernetOptions(**{**sn.__dict__, "checkpoint_path": str(path)}), data,
        workloads.TrainOptions(**{**train.__dict__, "logging_dir": None}), log_fn=lambda s: None)
    before, after = out["state"].opt_state, seen[0].opt_state
    assert type(after) is type(before) and seen[0].step == 2
    for got, want in zip(slot_dicts(after), slot_dicts(before)):
        assert set(got) == set(want)
        for name, t in want.items():
            assert torch.equal(got[name], t), name
