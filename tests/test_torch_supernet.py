"""The port's supernet pieces against the JAX package: the path sampler's
choice sequences, the lowering of a choice to masks, the mask buffer, the
choice enumeration and JSON form, and the supernet's logits from
transplanted weights over the three spaces, both LayerNorm settings, both
head fan-ins, the full path and sampled subnets.

Tolerance: choices and masks exactly; logits (f32 forward through up to three
blocks at maximum widths) rtol 1e-4 / atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu import choices as jax_choices
from nasrec_tpu import sampling as jax_sampling
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_apply as jax_supernet_apply
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init

from nasrec_tpu_torch import choices, sampling
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_apply, supernet_init
from nasrec_tpu_torch.models.transplant import from_jax_params, to_jax_params

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
SPACES = ("xlarge", "xlarge-zeros", "autoctr")
STRATEGIES = ("default", "single-path", "any-path", "full-path", "fixed-path",
              "evo-2shot-path")
VOCAB = (100,) * 26


def _candidates(space, num_blocks):
    """An evo-2shot candidate list, some entries wrapped as {"choice": ...}."""
    s = jax_sampling.ChoiceSampler(JAX_OPS[space], num_blocks, seed=99)
    out = [s() for _ in range(6)]
    return [({"choice": c, "score": 0.5} if k % 2 else c) for k, c in enumerate(out)]


@pytest.mark.parametrize("fan_in", ["uniform", "binomial-0.5"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sampler_draws_the_jax_sequence(strategy, fan_in):
    space = "xlarge-zeros" if strategy == "default" else "xlarge"
    cands = _candidates(space, 4) if strategy == "evo-2shot-path" else None
    kw = dict(strategy=strategy, anypath_choice=fan_in, supernet_training_steps=100,
              candidate_choices=cands, seed=7)
    js = jax_sampling.ChoiceSampler(JAX_OPS[space], 4, **kw)
    ts = sampling.ChoiceSampler(OPS_CONFIG_LIB[space], 4, **kw)
    want = [js() for _ in range(300)]
    got = [ts() for _ in range(300)]
    assert got == want
    assert ts.step_counter == js.step_counter == 299
    if strategy in ("default", "single-path", "any-path"):
        full = choices.full_path_choice(OPS_CONFIG_LIB[space], 4)
        # The warmup drew the full path early and sampled subnets too.
        assert full in got[:100] and any(c != full for c in got[:100])


@pytest.mark.parametrize("space", SPACES)
def test_choice_to_masks_matches_jax(space):
    js = jax_sampling.ChoiceSampler(JAX_OPS[space], 3, strategy="any-path", seed=3)
    for choice in [jax_choices.full_path_choice(JAX_OPS[space], 3)] + [js() for _ in range(20)]:
        want = jax_choices.choice_to_masks(choice, JAX_OPS[space], 3)
        got = choices.choice_to_masks(choice, OPS_CONFIG_LIB[space], 3)
        for g, w in zip(got.astuple(), want.astuple()):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        dev = got.to("cpu")
        assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
                   for x in dev.astuple())


def test_enumeration_and_json_match_jax():
    for space in SPACES:
        assert choices.get_all_subnet_choices(OPS_CONFIG_LIB[space], 4) == \
            jax_choices.get_all_subnet_choices(JAX_OPS[space], 4)
        assert choices.full_path_choice(OPS_CONFIG_LIB[space], 4) == \
            jax_choices.full_path_choice(JAX_OPS[space], 4)
    choice = jax_sampling.ChoiceSampler(JAX_OPS["xlarge"], 3, seed=5)()
    text = choices.choice_to_json(choice, num_blocks=3, config_name="xlarge",
                                  use_layernorm=True, extra={"score": 0.7})
    assert text == jax_choices.choice_to_json(choice, num_blocks=3, config_name="xlarge",
                                              use_layernorm=True, extra={"score": 0.7})
    assert choices.choice_from_json(text) == jax_choices.choice_from_json(text) == choice
    np.testing.assert_array_equal(choices.prefix_mask(8, 3), jax_choices.prefix_mask(8, 3))


def test_mask_buffer_hands_out_the_jax_masks():
    """Over size + 3 steps, across a refill; the sampler counters advance alike."""
    size = 5
    kw = dict(strategy="default", anypath_choice="binomial-0.5",
              supernet_training_steps=6, seed=0)
    jb = jax_sampling.DeviceMaskBuffer(
        jax_sampling.ChoiceSampler(JAX_OPS["xlarge"], 3, **kw), size=size)
    tb = sampling.DeviceMaskBuffer(
        sampling.ChoiceSampler(OPS_CONFIG_LIB["xlarge"], 3, **kw), size=size, device="cpu")
    for step in range(size + 3):
        (jbuf, jidx), (tbuf, tidx) = jb(), tb()
        assert int(jidx) == tidx == step % size
        want = jax.tree_util.tree_map(lambda x: np.asarray(x[jidx]), jbuf)
        for g, w in zip(tbuf.select(tidx).astuple(), want.astuple()):
            np.testing.assert_array_equal(g.numpy(), w)
        assert tb.sampler.step_counter == jb.sampler.step_counter


def _models(space, use_layernorm, last_n, impl="xla", num_blocks=3):
    kw = dict(num_blocks=num_blocks, num_dense=13, num_sparse=26, vocab_sizes=VOCAB,
              use_layernorm=use_layernorm, last_n_blocks_out=last_n)
    jcfg = JaxSuperNetConfig(space=JAX_OPS[space], attention_impl=impl, **kw)
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB[space], **kw)
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(2), jcfg))
    model = supernet_init(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    return jcfg, tcfg, params, model


def _batch(b, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 13).astype(np.float32),
            rng.randint(0, VOCAB[0], size=(b, 26)).astype(np.int32))


# Each space with each LayerNorm setting and each head fan-in at least once.
@pytest.mark.parametrize("space,use_layernorm,last_n", [
    ("xlarge", True, 1), ("xlarge", False, 2), ("xlarge-zeros", True, 2),
    ("xlarge-zeros", False, 1), ("autoctr", True, 2), ("autoctr", False, 1)])
def test_supernet_logits_match_jax(space, use_layernorm, last_n):
    jcfg, tcfg, params, model = _models(space, use_layernorm, last_n)
    # The inverse transplant gives back the JAX pytree, leaf for leaf.
    back = to_jax_params(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, np.asarray(w))

    dense, cat = _batch(8)
    sampler = jax_sampling.ChoiceSampler(JAX_OPS[space], 3, seed=11)
    picks = [jax_choices.full_path_choice(JAX_OPS[space], 3)] + [sampler() for _ in range(3)]
    for choice in picks:
        want = jax_supernet_apply(jcfg, params, dense, cat,
                                  jax_choices.choice_to_masks(choice, JAX_OPS[space], 3))
        got = supernet_apply(model, torch.from_numpy(dense), torch.from_numpy(cat),
                             choices.choice_to_masks(choice, OPS_CONFIG_LIB[space], 3))
        assert got.shape == (8, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_supernet_logits_match_jax_pallas_kernels():
    """The JAX side through its fused body and dot-product kernels (Pallas, in
    interpret mode on the CPU)."""
    jcfg, tcfg, params, model = _models("xlarge", True, 1, impl="pallas", num_blocks=2)
    dense, cat = _batch(8, seed=1)
    sampler = jax_sampling.ChoiceSampler(JAX_OPS["xlarge"], 2, seed=4)
    for choice in [jax_choices.full_path_choice(JAX_OPS["xlarge"], 2), sampler()]:
        want = jax_supernet_apply(jcfg, params, dense, cat,
                                  jax_choices.choice_to_masks(choice, JAX_OPS["xlarge"], 2))
        got = supernet_apply(model, torch.from_numpy(dense), torch.from_numpy(cat),
                             choices.choice_to_masks(choice, OPS_CONFIG_LIB["xlarge"], 2))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_zero_gates_leave_inactive_nodes_out():
    """A node whose gate is 0 still runs but changes no logit: perturbing its
    parameters leaves the output as it was, and its gradient is zero."""
    _, tcfg, _, model = _models("xlarge", True, 1, num_blocks=2)
    choice = choices.full_path_choice(OPS_CONFIG_LIB["xlarge"], 2)
    choice["micro"][1]["active_nodes"] = [0, 5]          # linear-2d, linear-3d
    masks = choices.choice_to_masks(choice, OPS_CONFIG_LIB["xlarge"], 2)
    dense, cat = (torch.from_numpy(a) for a in _batch(4))
    out = supernet_apply(model, dense, cat, masks)
    node = model.blocks[1].nodes[4]                      # the transformer
    grads = torch.autograd.grad(out.sum(), list(node.parameters()), allow_unused=True)
    assert all(g is None or not g.any() for g in grads)
    with torch.no_grad():
        for p in node.parameters():
            p.add_(1.0)
        again = supernet_apply(model, dense, cat, masks)
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)
