"""The arithmetic of the port's transformer-body and attention kernels, in
plain PyTorch on the CPU: the folded softmax (queries scaled once by
log2(e) / sqrt(2), base-2 exponentials, one saved statistic lse2 a head,
ds = p (dp - dsum)) against the plain version under autograd and against the
JAX package's `mha_reference`; the three-way TF32 split of the parameter
gradients' products against a float64 product; and the layout the kernels'
wrapper takes in place.

Tolerance (f32): the folded forward, its statistic and its backward 1e-5,
relative and absolute: both sides sum the same at most 48 products of values
of magnitude 1 a score and differ only in where they round (the scale folded
into q, exp2 for exp, a multiply by ln 2), each a few 1e-7.  The split product
2e-6 of the result's largest magnitude: each operand is kept to 2^-22, the
lo.lo term left out is 2^-22 of a product, and up to 192 products are summed
in f32.  Plain TF32 keeps 2^-11 of each operand and must miss that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu.ops.kernels.attention_pallas import mha_reference

from nasrec_tpu_torch.ops.kernels import attention as at
from nasrec_tpu_torch.ops.kernels import transformer_body as tb

torch.set_num_threads(2)

E, H, BATCH = 16, 8, 3
TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_REL_TOL = 2e-6


def _qkv_and_cotangent(slots):
    rng = np.random.RandomState(slots)
    return (rng.randn(BATCH, slots, 3 * E).astype(np.float32),
            rng.randn(BATCH, slots, E).astype(np.float32))


@pytest.mark.parametrize("slots", [5, 16, 48])
def test_folded_forward_matches_plain(slots):
    qkv, _ = _qkv_and_cotangent(slots)
    t = torch.from_numpy(qkv)
    o, lse2 = at.tiny_head_attention_folded(t)
    assert lse2.shape == (BATCH, slots, H)
    torch.testing.assert_close(o, at.tiny_head_attention_plain(t), **TOL)
    torch.testing.assert_close(lse2, at.softmax_lse2(t), **TOL)


@pytest.mark.parametrize("slots", [5, 16, 48])
def test_folded_backward_matches_plain_autograd(slots):
    qkv, co = _qkv_and_cotangent(slots)
    t = torch.tensor(qkv, requires_grad=True)
    (want,) = torch.autograd.grad(at.tiny_head_attention_plain(t), t, torch.from_numpy(co))
    o, lse2 = at.tiny_head_attention_folded(t.detach())
    got = at.tiny_head_attention_folded_bwd(t.detach(), torch.from_numpy(co), o, lse2)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("slots", [5, 16, 48])
def test_folded_attention_matches_jax_reference(slots):
    qkv, co = _qkv_and_cotangent(slots)
    out_r, vjp_r = jax.vjp(lambda a: mha_reference(*jnp.split(a, 3, axis=-1), H),
                           jnp.asarray(qkv))
    (dqkv_r,) = vjp_r(jnp.asarray(co))
    t = torch.from_numpy(qkv)
    o, lse2 = at.tiny_head_attention_folded(t)
    dqkv = at.tiny_head_attention_folded_bwd(t, torch.from_numpy(co), o, lse2)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_r), **TOL)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(dqkv_r), **TOL)


def test_folded_backward_uses_only_what_the_forward_saves():
    """A statistic that is off by one bit of log2 changes every probability:
    the backward rebuilds p from lse2 alone, with no second normalisation."""
    qkv, co = _qkv_and_cotangent(16)
    t, do = torch.from_numpy(qkv), torch.from_numpy(co)
    o, lse2 = at.tiny_head_attention_folded(t)
    dv = at.tiny_head_attention_folded_bwd(t, do, o, lse2)[..., 2 * E:]
    dv_half = at.tiny_head_attention_folded_bwd(t, do, o, lse2 + 1.0)[..., 2 * E:]
    torch.testing.assert_close(dv_half, 0.5 * dv, **TOL)


def _gradient_operands(k):
    """Operands of the magnitudes the parameter gradients see: an upstream
    gradient of a few 1e-1 through a LayerNorm scale of 0.17, and activations
    of magnitude 1, over k positions of a tile."""
    rng = np.random.RandomState(k)
    dy = (0.3 * rng.randn(E, k)).astype(np.float32)
    x = rng.randn(k, E).astype(np.float32)
    return torch.from_numpy(dy), torch.from_numpy(x)


def _rel_err(got, dy, x):
    want = dy.double() @ x.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("k", [96, 128, 192])
def test_tf32_three_way_split_keeps_f32_accuracy(k):
    dy, x = _gradient_operands(k)
    assert _rel_err(tb.matmul_tf32x3(dy, x), dy, x) <= SPLIT_REL_TOL


@pytest.mark.parametrize("k", [96, 128, 192])
def test_plain_tf32_product_misses_the_bound(k):
    dy, x = _gradient_operands(k)
    assert _rel_err(tb.round_tf32(dy) @ tb.round_tf32(x), dy, x) > 10 * SPLIT_REL_TOL


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0 - 2.0 ** -9])
    assert torch.equal(tb.round_tf32(x), want)
    assert bool(((tb.round_tf32(x).view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("slots,want", [(64, (2, 128)), (48, (2, 96)), (16, (8, 128)),
                                        (24, (5, 128)), (128, (1, 128)), (1, (128, 128))])
def test_tile_geometry(slots, want):
    rpt, threads = tb.tile_geometry(slots)
    assert (rpt, threads) == want
    assert rpt * slots <= threads and threads % 32 == 0


def test_tile_geometry_refuses_more_slots_than_a_tile_holds():
    with pytest.raises(ValueError, match="slots"):
        tb.tile_geometry(129)


def test_slot_minor_layout_is_recognised():
    """The kernels read a contiguous x, or the transposed view of a contiguous
    [B, 16, S] as the slot projection leaves it, in place; the wrapper tells
    the two apart by strides."""
    x = torch.zeros(4, 16, 6).transpose(1, 2)        # [B, S, 16] over [B, 16, S]
    assert tb._slot_minor(x) and not x.is_contiguous()
    assert not tb._slot_minor(x.contiguous())
    assert not tb._slot_minor(torch.zeros(4, 6, 32)[:, :, ::2])   # neither layout


@pytest.mark.parametrize("batch", [1, 3])
def test_both_layouts_are_told_apart_at_s16(batch):
    """At S = 16 (the last block of avazu/xlarge and kdd/xlarge) both layouts
    of x are [B, 16, 16]: only the strides tell them apart, and the body gives
    the same values from either."""
    torch.manual_seed(batch)
    base = torch.randn(batch, 16, 16)                 # the slot projection's [B, 16, S]
    x = base.transpose(1, 2)
    assert x.shape == base.shape
    assert tb._slot_minor(x) and not tb._slot_minor(x.contiguous())
    assert not tb._slot_minor(base)
    params = [0.3 * torch.randn(s) for s in tb.PARAM_SHAPES]
    torch.testing.assert_close(tb.transformer_body_plain(x, params),
                               tb.transformer_body_plain(x.contiguous(), params),
                               rtol=0, atol=0)
