"""The port's transformer node against `nasrec_tpu.ops.attention` and its two
Pallas kernels (run in interpret mode on the CPU), forward and gradients, on
the same numpy inputs and transplanted weights: the attention core, the fused
body, the whole node, and the port's three forms against each other.  On the
CPU the port's wrappers take the kernels' plain versions.

Tolerance (f32): forward rtol 1e-5 / atol 1e-5, gradients rtol 2e-4 /
atol 2e-4, the tolerances tests/test_pallas_attention.py holds the TPU
kernels to.  The LayerNorm scales start at 0.17, so outputs are small and the
absolute part matters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu.ops.attention import (
    _transformer_bmajor_unfused,
    transformer_apply_flat,
    transformer_init,
)
from nasrec_tpu.ops.kernels.attention_pallas import mha_reference, tiny_head_attention_bmajor
from nasrec_tpu.ops.kernels.transformer_body_pallas import transformer_body_fused_params

from nasrec_tpu_torch.models.transplant import state_dict_from_jax
from nasrec_tpu_torch.ops.attention import Transformer
from nasrec_tpu_torch.ops.kernels.attention import tiny_head_attention
from nasrec_tpu_torch.ops.kernels.transformer_body import PARAM_NAMES, transformer_body

torch.set_num_threads(2)

E, H = 16, 8
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _jax_params(seed, in_slots, out_slots, use_ln):
    """transformer_init's pytree as numpy, with every zero-initialised bias and
    every LayerNorm parameter moved off its initial value."""
    rng = np.random.RandomState(seed)
    p = jax.device_get(transformer_init(jax.random.PRNGKey(seed), in_slots, out_slots, E, use_ln))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), p)


def _node(p, in_slots, out_slots, use_ln):
    node = Transformer(in_slots, out_slots, E, use_ln, torch.Generator().manual_seed(0))
    node.load_state_dict(state_dict_from_jax(p))
    return node


def _assert_param_grads(node, jax_grads, body_only=False):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {n: q.grad for n, q in node.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        if body_only and name.startswith("proj"):
            continue            # the body does not read the slot projection
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **GRAD)


@pytest.mark.parametrize("b,s", [(8, 64), (16, 48), (5, 16)])
def test_attention_core_matches_jax(b, s):
    rng = np.random.RandomState(b + s)
    qkv = rng.randn(b, s, 3 * E).astype(np.float32)
    co = rng.randn(b, s, E).astype(np.float32)
    # The JAX kernel takes batch-on-lanes [3E, S, B].
    out_k, vjp_k = jax.vjp(lambda t: tiny_head_attention_bmajor(t, H, True),
                           jnp.asarray(qkv.transpose(2, 1, 0)))
    (dqkv_k,) = vjp_k(jnp.asarray(co.transpose(2, 1, 0)))
    out_r, vjp_r = jax.vjp(lambda t: mha_reference(*jnp.split(t, 3, axis=-1), H),
                           jnp.asarray(qkv))
    (dqkv_r,) = vjp_r(jnp.asarray(co))

    t = torch.tensor(qkv, requires_grad=True)
    out = tiny_head_attention(t)
    out.backward(torch.from_numpy(co))
    for want_o, want_g in ((np.asarray(out_k).transpose(2, 1, 0),
                            np.asarray(dqkv_k).transpose(2, 1, 0)),
                           (np.asarray(out_r), np.asarray(dqkv_r))):
        np.testing.assert_allclose(out.detach().numpy(), want_o, **FWD)
        np.testing.assert_allclose(t.grad.numpy(), want_g, **GRAD)


def _body_against(jax_body, b, s, seed):
    """The plain body against a JAX body on b-major [E, S, B]: output, dx and
    all twelve parameter gradients through the transplant."""
    rng = np.random.RandomState(seed)
    p = _jax_params(seed, s, s, False)
    x = (0.3 * rng.randn(b, s, E)).astype(np.float32)
    co = rng.randn(b, s, E).astype(np.float32)
    out_j, vjp = jax.vjp(jax_body, p, jnp.asarray(x.transpose(2, 1, 0)))
    dp_j, dx_j = vjp(jnp.asarray(co.transpose(2, 1, 0)))

    node = _node(p, s, s, False)
    params = node.body_params()
    assert len(params) == len(PARAM_NAMES) == 12
    xt = torch.tensor(x, requires_grad=True)
    out = transformer_body(xt, params)
    out.backward(torch.from_numpy(co))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j).transpose(2, 1, 0), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j).transpose(2, 1, 0), **GRAD)
    assert all(q.grad is not None for q in params)
    _assert_param_grads(node, dp_j, body_only=True)


@pytest.mark.parametrize("s", [24, 16])
def test_body_matches_jax_fused_kernel(s):
    # The JAX backward needs a lane tile that divides the batch: 128.
    _body_against(lambda p, xb: transformer_body_fused_params(p, xb, H, True), 128, s, s)


def test_body_matches_jax_unfused_at_odd_batch():
    _body_against(lambda p, xb: _transformer_bmajor_unfused(p, xb, None, H), 37, 24, 5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("use_ln", [False, True])
def test_transformer_node_matches_jax(use_ln, impl):
    in_slots, out_slots, b = 26, 32, 128
    rng = np.random.RandomState(7)
    p = _jax_params(11, in_slots, out_slots, use_ln)
    sparse = rng.randn(b, in_slots * E).astype(np.float32)
    co = rng.randn(b, out_slots * E).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda pp, xx: transformer_apply_flat(pp, xx, in_slots, E, None, H, impl),
        p, jnp.asarray(sparse))
    dp_j, dx_j = vjp(jnp.asarray(co))

    node = _node(p, in_slots, out_slots, use_ln)
    assert (node.proj_ln is not None) == use_ln == (node.proj.bias is None)
    xt = torch.tensor(sparse, requires_grad=True)
    out = node(xt, E)
    out.backward(torch.from_numpy(co))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **GRAD)
    _assert_param_grads(node, dp_j)


@pytest.mark.parametrize("use_ln", [False, True])
def test_three_forms_agree(use_ln):
    in_slots, out_slots, b = 20, 48, 9
    rng = np.random.RandomState(3)
    node = _node(_jax_params(2, in_slots, out_slots, use_ln), in_slots, out_slots, use_ln)
    sparse = rng.randn(b, in_slots * E).astype(np.float32)
    co = torch.from_numpy(rng.randn(b, out_slots * E).astype(np.float32))

    def run(impl, fused):
        node.fused = fused
        node.zero_grad()
        xt = torch.tensor(sparse, requires_grad=True)
        out = node(xt, E, impl=impl)
        out.backward(co)
        return out.detach(), xt.grad, {n: q.grad.clone() for n, q in node.named_parameters()}

    plain = run("plain", True)
    for other in (run("auto", True), run("auto", False)):   # fused-plain, unfused-plain
        np.testing.assert_allclose(other[0].numpy(), plain[0].numpy(), **FWD)
        np.testing.assert_allclose(other[1].numpy(), plain[1].numpy(), **GRAD)
        for name in plain[2]:
            np.testing.assert_allclose(other[2][name].numpy(), plain[2][name].numpy(),
                                       err_msg=name, **GRAD)


def test_kernel_impl_raises_on_cpu_tensors():
    node = _node(_jax_params(0, 8, 16, False), 8, 16, False)
    x = torch.zeros(2, 8 * E)
    for fused in (True, False):
        node.fused = fused
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            node(x, E, impl="kernel")
