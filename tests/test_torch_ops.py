"""The port's operators against `nasrec_tpu.ops`, forward and gradients, on
transplanted weights: elastic linear 2-D / 3-D, FM3D and the flat-layout
dot-product with each of its projection-elision cases.

Tolerance (f32): forward rtol 1e-5 and atol 1e-6 times the output's largest
magnitude (outputs reach ~15 after three chained products, where one ulp is
~1e-6; atol 1e-5 for FM3D, whose difference of squares cancels at ~70);
gradients rtol 1e-4 and atol the larger of 1e-5 and 1e-6 times the
gradient's largest magnitude (they reach ~200 and sum over the batch in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu.ops import interactions as jint
from nasrec_tpu.ops import linear as jlin

from nasrec_tpu_torch.models.transplant import state_dict_from_jax
from nasrec_tpu_torch.ops.interactions import FM3D, DotProduct
from nasrec_tpu_torch.ops.linear import ElasticLinear, ElasticLinear3D

torch.set_num_threads(2)

E = 16
B = 12


def _grad_tol(want):
    return dict(rtol=1e-4, atol=max(1e-5, 1e-6 * float(np.abs(want).max())))


def _gen():
    return torch.Generator().manual_seed(0)


def _check(jparams, jfn, module, tfn, inputs, seed=0, fwd=None):
    """Compare outputs and the gradients of sum(out * co) w.r.t. the inputs
    and every parameter."""
    rng = np.random.RandomState(seed)
    jparams = jax.device_get(jparams)
    module.load_state_dict(state_dict_from_jax(jparams))

    out_j = np.asarray(jfn(jparams, *[jnp.asarray(x) for x in inputs]))
    co = rng.randn(*out_j.shape).astype(np.float32)
    loss_j = lambda p, *xs: jnp.sum(jfn(p, *xs) * co)
    g_j = jax.grad(loss_j, argnums=tuple(range(len(inputs) + 1)))(
        jparams, *[jnp.asarray(x) for x in inputs])

    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    out_t = tfn(module, *xs)
    fwd = fwd or dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(out_j).max())))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, **fwd)
    (out_t * torch.from_numpy(co)).sum().backward()

    for x, gx in zip(xs, g_j[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **_grad_tol(gx))
    want = state_dict_from_jax(jax.device_get(g_j[0]))
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), err_msg=n,
                                   **_grad_tol(want[n].numpy()))


@pytest.mark.parametrize("use_ln", [False, True])
def test_elastic_linear_2d(use_ln):
    rng = np.random.RandomState(1)
    jp = jlin.elastic_linear_init(jax.random.PRNGKey(0), 24, 40, use_ln)
    _check(jp, lambda p, x: jlin.elastic_linear_apply(p, x, "relu"),
           ElasticLinear(24, 40, use_ln, _gen()), lambda m, x: m(x, "relu"),
           [rng.randn(B, 24).astype(np.float32)])


@pytest.mark.parametrize("use_ln", [False, True])
def test_elastic_linear_3d_flat(use_ln):
    rng = np.random.RandomState(2)
    s_in, s_out = 10, 6
    jp = jlin.elastic_linear3d_init(jax.random.PRNGKey(0), s_in, s_out, use_ln)
    _check(jp, lambda p, x: jlin.elastic_linear3d_apply_flat(p, x, s_in, E, "relu"),
           ElasticLinear3D(s_in, s_out, use_ln, _gen()), lambda m, x: m(x, E, "relu"),
           [rng.randn(B, s_in * E).astype(np.float32)])


@pytest.mark.parametrize("out_dim", [16, 48])   # 16: projection elided
def test_fm3d_flat(out_dim):
    rng = np.random.RandomState(3)
    slots = 9
    jp = jint.fm3d_init(jax.random.PRNGKey(0), E, out_dim, False)
    _check(jp, lambda p, x: jint.fm3d_apply_flat(p, x, slots, E),
           FM3D(E, out_dim, False, _gen()), lambda m, x: m(x, slots, E),
           [rng.randn(B, slots * E).astype(np.float32)],
           fwd=dict(rtol=1e-5, atol=1e-5))


# (dense_in, sparse_slots, out_dim, use_ln): slot_dim = round(sqrt(2*out_dim)).
DOT_CASES = {
    "all_projections": (32, 20, 64, False),      # slot_dim 11, P 66 != 64
    "no_dense_proj": (E, 20, 64, False),
    "no_slot_proj": (32, 11, 64, False),         # sparse_slots == slot_dim
    "no_out_proj": (32, 20, 66, False),          # P == out_dim
    "layernorm": (32, 20, 64, True),
    "block1_shape": (256, 82, 1024, False),      # n = 46, P = 1035
}


# The block-1 shape goes through the JAX op's Pallas path (interpret mode)
# only; that kernel alone is held at several n in test_torch_dotprod.py.
@pytest.mark.parametrize("case,impl", [(c, "xla") for c in sorted(DOT_CASES)
                                       if c != "block1_shape"]
                         + [("block1_shape", "pallas")])
def test_dot_product_flat(case, impl):
    dense_in, slots, out_dim, use_ln = DOT_CASES[case]
    rng = np.random.RandomState(4)
    jp = jint.dot_product_init(jax.random.PRNGKey(0), dense_in, slots, out_dim, E, use_ln)
    module = DotProduct(dense_in, slots, out_dim, E, use_ln, _gen())
    if case.startswith("no_"):
        assert getattr(module, case[3:]) is None and case[3:] not in jp
    _check(jp, lambda p, d, s: jint.dot_product_apply_flat(p, d, s, slots, E, impl=impl),
           module, lambda m, d, s: m(d, s, slots, E),
           [rng.randn(B, dense_in).astype(np.float32),
            rng.randn(B, slots * E).astype(np.float32)])


@pytest.mark.parametrize("case", sorted(DOT_CASES))
def test_dot_product_hands_the_kernel_its_operands_as_they_lie(case, monkeypatch):
    """The node gives `dot_scores_tril` the projected dense row [B, 16] and the
    projected slots [B, 16, slot_dim], contiguous wherever a slot projection
    made them, and builds no [B, n, 16] tensor; the plain version on those
    operands equals the concat-and-transpose form it replaced."""
    from nasrec_tpu_torch.ops import interactions
    from nasrec_tpu_torch.ops.kernels import dotprod

    dense_in, slots, out_dim, use_ln = DOT_CASES[case]
    module = DotProduct(dense_in, slots, out_dim, E, use_ln, _gen())
    seen = {}

    def spy(x, yt, impl="auto"):
        seen["x"], seen["yt"] = x, yt
        return dotprod.dot_scores_tril(x, yt, impl)

    monkeypatch.setattr(interactions, "dot_scores_tril", spy)
    rng = np.random.RandomState(5)
    module(torch.from_numpy(rng.randn(B, dense_in).astype(np.float32)),
           torch.from_numpy(rng.randn(B, slots * E).astype(np.float32)), slots, E)
    slot_dim = interactions.dot_product_slot_dim(out_dim)
    x, yt = seen["x"], seen["yt"]
    assert tuple(x.shape) == (B, E) and tuple(yt.shape) == (B, E, slot_dim)
    assert yt.is_contiguous() == (module.slot_proj is not None)
    t = torch.cat([x[:, None, :], yt.transpose(1, 2)], dim=1)
    want = torch.einsum("bne,bme->bnm", t, t)[:, *torch.tril_indices(1 + slot_dim, 1 + slot_dim, -1)]
    torch.testing.assert_close(dotprod.dot_scores_tril_plain(x, yt), want, rtol=0, atol=0)
