"""The dense-gradient train step, the sparse step's micro-batches and its
other optimizers, in the port against the JAX package: two steps from the
same transplanted weights on the same batches, for SGD, Adam and Adagrad
with wd > 0 (criteo-kaggle/autoctr, batch 64, vocab capped at 50, as
tests/test_torch_train_step.py), a masked supernet at 2 blocks, the sparse
step with micro_batches = 2 and with SGD for the non-table parameters.

Tolerance (f32, after train steps): rtol 1e-4 / atol 1e-5 on the losses,
logits, parameters, embedding table and every optimizer slot.
"""

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu import choices as jax_choices
from nasrec_tpu import sampling as jax_sampling
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import build_fixed_plan as jax_build_plan
from nasrec_tpu.models import fixed_apply as jax_fixed_apply
from nasrec_tpu.models import fixed_init as jax_fixed_init
from nasrec_tpu.models.embedding import table_offsets as jax_table_offsets
from nasrec_tpu.models.fixed import fixed_apply_embedded as jax_apply_embedded
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_apply as jax_supernet_apply
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.train import make_optimizer as jax_make_optimizer
from nasrec_tpu.train import optim as jax_optim
from nasrec_tpu.train.loop import init_train_state as jax_init_state
from nasrec_tpu.train.loop import make_train_step as jax_train_step
from nasrec_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from nasrec_tpu.train.sparse_embedding import (
    make_sparse_embedding_train_step as jax_sparse_step,
)

from nasrec_tpu_torch import choices
from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
from nasrec_tpu_torch.models.transplant import from_jax_opt_state, from_jax_params
from nasrec_tpu_torch.train.loop import init_train_state, make_train_step
from nasrec_tpu_torch.train.optim import AdamState, make_lr_schedule, make_optimizer, slot_dicts
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB = tuple(min(v, 50) for v in DATASETS["criteo-kaggle"].raw_vocab_sizes)


def _autoctr():
    jplan = jax_build_plan(jax_best_arch("criteo-kaggle", "autoctr"), JAX_OPS["autoctr"],
                           7, 13, 26, VOCAB, attention_impl="xla")
    tplan = build_fixed_plan(get_best_arch("criteo-kaggle", "autoctr"),
                             OPS_CONFIG_LIB["autoctr"], 7, 13, 26, VOCAB)
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(3), jplan))
    model = fixed_init(tplan, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tplan))
    return jplan, tplan, params, model


def _batches(b, n=2, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, 13).astype(np.float32),
             np.stack([rng.randint(0, v, size=b) for v in VOCAB], 1).astype(np.int32),
             rng.randint(0, 2, size=(b, 1)).astype(np.float32)) for _ in range(n)]


def _torch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _assert_matches(model, opt_state, tm, jstate, jm, spec):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["logits"].numpy(), np.asarray(jm["logits"]), **TOL)
    want_p = from_jax_params(jax.device_get(jstate.params), spec)
    got_p = model.state_dict()
    assert set(got_p) == set(want_p)
    for name in want_p:
        np.testing.assert_allclose(got_p[name].numpy(), want_p[name].numpy(),
                                   err_msg=name, **TOL)
    want_s = from_jax_opt_state(jax.device_get(jstate.opt_state), spec)
    assert type(want_s) is type(opt_state)
    for got, want in zip(slot_dicts(opt_state), slot_dicts(want_s)):
        assert set(got) == set(want_p)
        for name in want_p:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       err_msg=name, **TOL)
    if isinstance(opt_state, AdamState):
        assert int(opt_state.count) == int(want_s.count) == 2


@pytest.mark.parametrize("opt_name,wd,lr", [("sgd", 0.0, 0.05), ("adam", 0.0, 1e-3),
                                            ("adagrad", 1e-4, 0.16), ("adam", 1e-4, 1e-3)],
                         ids=["sgd", "adam", "adagrad-wd", "adam-wd"])
def test_two_dense_steps_match_jax(opt_name, wd, lr):
    jplan, tplan, params, model = _autoctr()
    batches = _batches(64)
    jopt = jax_make_optimizer(opt_name)
    jstate = jax_init_state(params, jopt)
    jstep = jax_train_step(lambda p, d, c: jax_fixed_apply(jplan, p, d, c), jopt,
                           jax_lr_schedule("cosine", lr, 10, 1), l2_reg=wd, donate=False)
    for d, c, y in batches:
        jstate, jm = jstep(jstate, d, c, y)

    tstate = init_train_state(model, make_optimizer(opt_name))
    tstep = make_train_step(make_optimizer(opt_name), make_lr_schedule("cosine", lr, 10, 1),
                            l2_reg=wd)
    table_before = model.embedding.table.detach().clone()
    for batch in batches:
        tstate, tm = tstep(tstate, *_torch(batch))
    assert tstate.step == 2
    np.testing.assert_allclose(float(tm["l2"]), float(jm["l2"]), **TOL)
    _assert_matches(model, tstate.opt_state, tm, jstate, jm, tplan)
    # With wd > 0 every table row moves, touched or not.
    moved = (model.embedding.table.detach() != table_before).any(1)
    assert bool(moved.all()) == (wd > 0)


def test_two_masked_dense_steps_match_jax():
    """A 2-block supernet, Adagrad with wd > 0; the second step's masks come
    as a mask buffer's (buffer, idx) pair."""
    vocab = (40,) * 26
    kw = dict(num_blocks=2, num_dense=13, num_sparse=26, vocab_sizes=vocab, use_layernorm=True)
    jcfg = JaxSuperNetConfig(space=JAX_OPS["xlarge"], attention_impl="xla", **kw)
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], **kw)
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(5), jcfg))
    rng = np.random.RandomState(1)
    batches = [(rng.randn(16, 13).astype(np.float32),
                rng.randint(0, 40, size=(16, 26)).astype(np.int32),
                rng.randint(0, 2, size=(16, 1)).astype(np.float32)) for _ in range(2)]
    sampler = jax_sampling.ChoiceSampler(JAX_OPS["xlarge"], 2, strategy="any-path", seed=8)
    picks = [sampler(), sampler()]

    jopt = jax_make_optimizer("adagrad")
    jstate = jax_init_state(params, jopt)
    jstep = jax_train_step(lambda p, d, c, m: jax_supernet_apply(jcfg, p, d, c, m), jopt,
                           jax_lr_schedule("cosine", 0.12, 10, 1), l2_reg=1e-3,
                           has_masks=True, donate=False)
    for (d, c, y), choice in zip(batches, picks):
        jstate, jm = jstep(jstate, d, c, y,
                           jax_choices.choice_to_masks(choice, JAX_OPS["xlarge"], 2))

    model = supernet_init(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    tstate = init_train_state(model, make_optimizer("adagrad"))
    tstep = make_train_step(make_optimizer("adagrad"), make_lr_schedule("cosine", 0.12, 10, 1),
                            l2_reg=1e-3, has_masks=True)
    stacked = choices.ChoiceMasks.stack(
        [choices.choice_to_masks(c, OPS_CONFIG_LIB["xlarge"], 2) for c in picks]).to("cpu")
    for k, batch in enumerate(batches):
        masks = stacked.select(0) if k == 0 else (stacked, 1)
        tstate, tm = tstep(tstate, *_torch(batch), masks)
    _assert_matches(model, tstate.opt_state, tm, jstate, jm, tcfg)


def test_sparse_step_micro_batches_match_jax():
    jplan, tplan, params, model = _autoctr()
    batches = _batches(64)
    opt = jax_make_optimizer("adagrad")
    jstate = jax_init_state(params, opt)
    jstep = jax_sparse_step(lambda p, d, s: jax_apply_embedded(jplan, p, d, s), opt,
                            jax_lr_schedule("cosine", 0.16, 10, 1), jax_table_offsets(VOCAB),
                            grad_clip=0.05, donate=False, microbatch=2, table_update="scatter")
    for d, c, y in batches:
        jstate, jm = jstep(jstate, d, c, y)

    tstate = init_sparse_train_state(model)
    tstep = make_sparse_embedding_train_step(make_lr_schedule("cosine", 0.16, 10, 1),
                                             grad_clip=0.05, microbatch=2)
    for batch in batches:
        tstate, tm = tstep(tstate, *_torch(batch))
    _assert_matches(model, tstate.opt_state, tm, jstate, jm, tplan)
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        make_sparse_embedding_train_step(lambda s: 0.1, microbatch=3)(tstate, *_torch(batches[0]))


def test_sparse_step_with_sgd_for_the_other_parameters_matches_jax():
    """The JAX sparse step hands its optimizer the other parameters' slots as
    a dict mirroring them; SGD's momentum, wrapped to that contract here, is
    the JAX package's sgd_update."""
    def jax_sgd(p, s, g, lr):
        new_p, new_s = jax_optim.sgd_update(p, jax_optim.SGDState(s), g, lr)
        return new_p, new_s.momentum

    jplan, tplan, params, model = _autoctr()
    batches = _batches(64)
    jopt = jax_optim.Optimizer(jax_optim.adagrad_init, jax_sgd)
    jstate = jax_init_state(params, jopt)
    jstep = jax_sparse_step(lambda p, d, s: jax_apply_embedded(jplan, p, d, s), jopt,
                            jax_lr_schedule("cosine", 0.05, 10, 1), jax_table_offsets(VOCAB),
                            donate=False, table_update="scatter")
    for d, c, y in batches:
        jstate, jm = jstep(jstate, d, c, y)
    jstate = jstate.__class__(jstate.params, jax_optim.SGDState(jstate.opt_state), jstate.step)

    sgd = make_optimizer("sgd")
    tstate = init_sparse_train_state(model, sgd)
    tstep = make_sparse_embedding_train_step(make_lr_schedule("cosine", 0.05, 10, 1),
                                             optimizer=sgd)
    for batch in batches:
        tstate, tm = tstep(tstate, *_torch(batch))
    _assert_matches(model, tstate.opt_state, tm, jstate, jm, tplan)


def test_dense_step_frozen_parameters_get_a_zero_gradient():
    """trainable: frozen parameters go through the update with a zero
    gradient, as the JAX step's mask leaves them: with zero moments they keep
    their values; the table included."""
    from nasrec_tpu_torch.train.loop import freeze_mask

    _, _, _, model = _autoctr()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    keep = freeze_mask(model, "final-only")
    step = make_train_step(make_optimizer("adam"), lambda s: 1e-2, l2_reg=1e-3,
                           trainable=keep)
    state = init_train_state(model, make_optimizer("adam"))
    for batch in _batches(32):
        state, _ = step(state, *_torch(batch))
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]) != keep[name], name
