"""The bf16 plain versions of the port's kernels against the JAX package's
Pallas kernels on the same bf16 inputs, run in interpret mode on the CPU:
the dot-product (`dot_scores_tril_bmajor`), the fused transformer body
(`transformer_body_fused`) and the tiny-head attention core
(`tiny_head_attention_bmajor`), forward and gradients.

Each side computes in f32 and rounds a bf16 output once, so an output is
held to one bf16 unit in the last place (ulp) of the other, elementwise: a
larger gap would be a different f32 value, not a different rounding of the
same one.  Where a gradient's f32 sum cancels to a value far below its terms
(1e-6 against a largest element of 4), the two f32 sums differ by their own
rounding, about 1e-8 of the largest element, which is several ulps of so
small a value: such elements are held to 1e-6 of the largest element
instead.  The body's parameter gradients stay f32 and are held to 1e-3 of
the largest element (they sum over every position, in another order).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nasrec_tpu.ops.attention import transformer_init
from nasrec_tpu.ops.kernels.attention_pallas import tiny_head_attention_bmajor
from nasrec_tpu.ops.kernels.dotprod_pallas import dot_scores_tril_bmajor
from nasrec_tpu.ops.kernels.transformer_body_pallas import transformer_body_fused_params

from nasrec_tpu_torch.models.transplant import state_dict_from_jax
from nasrec_tpu_torch.ops.attention import Transformer
from nasrec_tpu_torch.ops.kernels.attention import tiny_head_attention
from nasrec_tpu_torch.ops.kernels.dotprod import dot_scores_tril
from nasrec_tpu_torch.ops.kernels.transformer_body import transformer_body

torch.set_num_threads(2)

E, H = 16, 8
BF16 = ml_dtypes.bfloat16


def bf16_ulps(got, want) -> np.ndarray:
    """Elementwise distance between two bf16 arrays in units in the last
    place: the count of bf16 values between them (+0 and -0 are one value)."""
    def ordered(a):
        bits = np.asarray(a, BF16).view(np.uint16).astype(np.int32)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordered(got) - ordered(want))


def assert_within_one_ulp(got, want, what):
    """One bf16 ulp elementwise, or 1e-6 of the largest element where an f32
    sum cancelled (see the module docstring)."""
    got32, want32 = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ok = (bf16_ulps(got, want) <= 1) | (np.abs(got32 - want32) <= 1e-6 * np.abs(want32).max())
    assert ok.all(), f"{what}: {int((~ok).sum())} elements more than one bf16 ulp apart"


def _torch_bf16(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy().astype(BF16)


@pytest.mark.parametrize("n,b", [(9, 128), (17, 256)])
def test_dot_product_plain_matches_jax_kernel_in_bf16(n, b):
    rng = np.random.RandomState(n)
    t = rng.randn(b, n, E).astype(BF16)                  # row 0 the dense row, 1.. the slots
    dz = rng.randn(b, n * (n - 1) // 2).astype(BF16)
    z_j, vjp = jax.vjp(lambda tb: dot_scores_tril_bmajor(tb, True),
                       jnp.asarray(t.transpose(2, 1, 0)))            # [E, n, B]
    (dt_j,) = vjp(jnp.asarray(dz.T))
    assert z_j.dtype == dt_j.dtype == jnp.bfloat16

    x = _torch_bf16(t[:, 0, :], True)
    yt = _torch_bf16(t[:, 1:, :].transpose(0, 2, 1), True)          # [B, 16, m]
    z = dot_scores_tril(x, yt)
    z.backward(_torch_bf16(dz))
    assert z.dtype == x.grad.dtype == yt.grad.dtype == torch.bfloat16
    assert_within_one_ulp(_np(z), np.asarray(z_j).T, "z")
    dt = np.asarray(dt_j).transpose(2, 1, 0)                         # [B, n, E]
    assert_within_one_ulp(_np(x.grad), dt[:, 0, :], "dx")
    assert_within_one_ulp(_np(yt.grad), dt[:, 1:, :].transpose(0, 2, 1), "dyt")


@pytest.mark.parametrize("b,s", [(128, 16), (128, 24)])
def test_attention_core_plain_matches_jax_kernel_in_bf16(b, s):
    rng = np.random.RandomState(s)
    qkv = rng.randn(b, s, 3 * E).astype(BF16)
    do = rng.randn(b, s, E).astype(BF16)
    o_j, vjp = jax.vjp(lambda t: tiny_head_attention_bmajor(t, H, True),
                       jnp.asarray(qkv.transpose(2, 1, 0)))
    (dqkv_j,) = vjp(jnp.asarray(do.transpose(2, 1, 0)))
    assert o_j.dtype == dqkv_j.dtype == jnp.bfloat16

    t = _torch_bf16(qkv, True)
    o = tiny_head_attention(t)
    o.backward(_torch_bf16(do))
    assert o.dtype == t.grad.dtype == torch.bfloat16
    assert_within_one_ulp(_np(o), np.asarray(o_j).transpose(2, 1, 0), "o")
    assert_within_one_ulp(_np(t.grad), np.asarray(dqkv_j).transpose(2, 1, 0), "dqkv")


def _body_params(seed, s):
    """transformer_init's pytree as numpy, biases and LayerNorm parameters
    moved off their initial values."""
    rng = np.random.RandomState(seed)
    p = jax.device_get(transformer_init(jax.random.PRNGKey(seed), s, s, E, False))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), p)


@pytest.mark.parametrize("s", [16, 24])
def test_body_plain_matches_jax_kernel_in_bf16(s):
    b = 128                      # the JAX backward's lane tile divides the batch
    rng = np.random.RandomState(s)
    p = _body_params(s, s)
    x = (0.3 * rng.randn(b, s, E)).astype(BF16)
    dout = rng.randn(b, s, E).astype(BF16)
    out_j, vjp = jax.vjp(lambda pp, xb: transformer_body_fused_params(pp, xb, H, True),
                         p, jnp.asarray(x.transpose(2, 1, 0)))
    dp_j, dx_j = vjp(jnp.asarray(dout.transpose(2, 1, 0)))
    assert out_j.dtype == dx_j.dtype == jnp.bfloat16

    node = Transformer(s, s, E, False, torch.Generator().manual_seed(0))
    node.load_state_dict(state_dict_from_jax(p))
    params = node.body_params()
    xt = _torch_bf16(x, True)
    out = transformer_body(xt, params)
    out.backward(_torch_bf16(dout))
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    assert all(q.grad.dtype == torch.float32 for q in params)
    assert_within_one_ulp(_np(out), np.asarray(out_j).transpose(2, 1, 0), "out")
    assert_within_one_ulp(_np(xt.grad), np.asarray(dx_j).transpose(2, 1, 0), "dx")
    want = state_dict_from_jax(jax.device_get(dp_j))
    for name, q in node.named_parameters():
        if name.startswith("proj"):
            continue                  # the body does not read the slot projection
        w = want[name].numpy()
        assert want[name].dtype == torch.float32
        np.testing.assert_allclose(q.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
