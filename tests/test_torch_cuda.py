"""The port's CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach: a batch that is not a multiple of the
kernel's tile, the smallest operand (n = 2, one pair score), an empty update,
sentinel rows, row_offset shards and a hot row repeated at many positions;
the transformer body and the attention core at batches of 1, 37 and 2048,
the body with x in both layouts its kernels read in place.
chip_smoke.py holds the same kernels at the main path's shapes.

Needs an NVIDIA card; skipped without one.  The port needs no JAX, so on
the card run it without tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance (f32): the dot-product forward rtol 1e-5 / atol 1e-5, its backward
rtol 1e-5 / atol 1e-4 (sums of up to 45 products of N(0,1) values, ordered
differently from cuBLAS); the table update exact, since the kernel rounds
step by step like the plain version and each row is written by one thread
group.  The transformer body and the attention core: forward rtol 1e-5 /
atol 1e-5, input gradients rtol 2e-4 / atol 2e-4 (the tolerances the JAX
package holds its TPU kernels to), parameter gradients, which sum over every
position of the batch, 2e-4 of the gradient's largest magnitude.  The saved
softmax statistic (a base-2 log-sum-exp) rtol 1e-5 / atol 1e-5.
"""

import pytest
import torch
import torch.nn.functional as F

from nasrec_tpu_torch.ops.kernels import attention, dotprod, table_update, transformer_body

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("batch,n", [(1, 2), (5, 3), (37, 17), (13, 46), (1000, 46)])
def test_dot_scores_tril_kernel_matches_plain(dev, batch, n):
    gen = torch.Generator(device=dev).manual_seed(batch * 100 + n)
    t = torch.randn(batch, n, 16, device=dev, generator=gen)
    dz = torch.randn(batch, dotprod.tril_size(n), device=dev, generator=gen)

    tk = t.clone().requires_grad_(True)
    zk = dotprod.dot_scores_tril(tk)                 # CUDA -> the kernel
    zk.backward(dz)
    tp = t.clone().requires_grad_(True)
    zp = dotprod.dot_scores_tril(tp, impl="plain")
    zp.backward(dz)
    torch.cuda.synchronize()

    torch.testing.assert_close(zk, zp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tk.grad, tp.grad, rtol=1e-5, atol=1e-4)


def _update_case(dev, vocab, positions, seed, hot_row=None, sentinels=0):
    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, vocab, (positions, 1), device=dev, generator=gen,
                        dtype=torch.int32)
    if hot_row is not None:
        idx[::2] = hot_row
    g = torch.randn(positions, 16, device=dev, generator=gen)
    if positions:
        rows, seg, _ = rowwise_segment_sum_slotwise(idx, g)
    else:
        rows, seg = idx.reshape(-1), g
    if sentinels:
        rows = torch.cat([rows, torch.full((sentinels,), vocab + 3, device=dev,
                                           dtype=rows.dtype)])
        seg = torch.cat([seg, torch.ones(sentinels, 16, device=dev)])
    table = torch.randn(vocab, 16, device=dev, generator=gen)
    acc = torch.rand(vocab, 16, device=dev, generator=gen)
    return rows.to(torch.int32).contiguous(), seg.contiguous(), table, acc


@pytest.mark.parametrize("vocab,positions,hot_row,sentinels",
                         [(100, 0, None, 0), (1000, 777, None, 5), (500, 4096, 7, 3)])
def test_table_update_kernel_matches_plain(dev, vocab, positions, hot_row, sentinels):
    rows, seg, table, acc = _update_case(dev, vocab, positions, vocab, hot_row, sentinels)
    tk, ak = table.clone(), acc.clone()
    table_update.table_update(tk, ak, rows, seg, 0.05)
    tp, ap = table.clone(), acc.clone()
    table_update.table_update(tp, ap, rows, seg, 0.05, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(tk, tp) and torch.equal(ak, ap)


def test_table_update_kernel_row_offset_shards(dev):
    vocab, half = 2000, 1000
    rows, seg, table, acc = _update_case(dev, vocab, 3000, 11, sentinels=2)
    whole_t, whole_a = table.clone(), acc.clone()
    table_update.table_update(whole_t, whole_a, rows, seg, 0.05)
    lo_t, lo_a = table[:half].clone(), acc[:half].clone()
    hi_t, hi_a = table[half:].clone(), acc[half:].clone()
    table_update.table_update(lo_t, lo_a, rows, seg, 0.05, row_offset=0)
    table_update.table_update(hi_t, hi_a, rows, seg, 0.05, row_offset=half)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([lo_t, hi_t]), whole_t)
    assert torch.equal(torch.cat([lo_a, hi_a]), whole_a)


def _body_case(dev, batch, slots, seed, layout="contiguous"):
    """layout 'slot_minor': x is the transposed view of a contiguous
    [batch, 16, slots], as the transformer node's slot projection leaves it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, slots, 16, device=dev, generator=gen)
    if layout == "slot_minor":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    params = []
    for name, shape in zip(transformer_body.PARAM_NAMES, transformer_body.PARAM_SHAPES):
        p = 0.3 * torch.randn(shape, device=dev, generator=gen)
        if name in ("attn_ln_w", "fc_ln_w"):
            p = p + 0.17
        params.append(p)
    dout = torch.randn(batch, slots, 16, device=dev, generator=gen)
    # Where an input of the FFN's ReLU lies within rounding of zero, the kernel
    # and the plain version may take different sides, and their gradients then
    # differ by a whole term: such batch rows get a zero output gradient.
    with torch.no_grad():
        w_in, b_in, w_out, b_out, g1, h1, fc1w, fc1b = params[:8]
        o = attention.tiny_head_attention_plain(F.linear(x, w_in, b_in))
        x4 = F.layer_norm(F.linear(o, w_out, b_out) + x, (16,), g1, h1, 1e-5)
        dout[(F.linear(x4, fc1w, fc1b).abs() < 1e-5).flatten(1).any(1)] = 0.0
    return x, params, dout


def _body_grads(x, params, dout, impl):
    xs = x.clone().requires_grad_(True)
    ps = [p.clone().requires_grad_(True) for p in params]
    out = transformer_body.transformer_body(xs, ps, impl=impl)
    grads = torch.autograd.grad(out, [xs] + ps, dout)
    return out.detach(), grads[0], grads[1:]


@pytest.mark.parametrize("layout", ["contiguous", "slot_minor"])
@pytest.mark.parametrize("slots", [16, 24, 48, 64])
@pytest.mark.parametrize("batch", [1, 37, 2048])
def test_transformer_body_kernel_matches_plain(dev, batch, slots, layout):
    x, params, dout = _body_case(dev, batch, slots, batch * 100 + slots, layout)
    before = dict(transformer_body.LAUNCHES)
    with torch.no_grad():
        out_eval = transformer_body.transformer_body(x, params)      # eval forward
    out_k, dx_k, dp_k = _body_grads(x, params, dout, "auto")          # training forward
    out_p, dx_p, dp_p = _body_grads(x, params, dout, "plain")
    _, dx_2, dp_2 = _body_grads(x, params, dout, "auto")
    torch.cuda.synchronize()
    for key in (f"fwd_s{slots}", f"fwd_train_s{slots}", f"bwd_s{slots}"):
        assert transformer_body.LAUNCHES[key] > before.get(key, 0), key

    torch.testing.assert_close(out_eval, out_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(out_eval, out_k)
    # dx comes back in the layout x had, so nothing is copied on the way out.
    assert dx_k.stride() == x.stride()
    torch.testing.assert_close(dx_k, dx_p, rtol=2e-4, atol=2e-4)
    for name, gk, gp in zip(transformer_body.PARAM_NAMES, dp_k, dp_p):
        tol = 2e-4 * max(1.0, gp.abs().max().item())
        assert (gk - gp).abs().max().item() <= tol, name
    # Two backward runs from the same inputs give the same bits.
    assert torch.equal(dx_k, dx_2)
    assert all(torch.equal(a, b) for a, b in zip(dp_k, dp_2))


@pytest.mark.parametrize("layout", ["contiguous", "slot_minor"])
@pytest.mark.parametrize("batch,slots", [(1, 16), (37, 24), (37, 48), (2048, 64)])
def test_transformer_body_kernel_saves_o_and_statistic(dev, batch, slots, layout):
    x, params, _ = _body_case(dev, batch, slots, batch + slots, layout)
    flat = transformer_body.flatten_params(params)
    out, o, lse2 = transformer_body.transformer_body_fwd_kernel(x, flat, save=True)
    qkv = F.linear(x, params[0], params[1])
    torch.cuda.synchronize()
    assert out.is_contiguous() and o.is_contiguous() and lse2.shape == (batch, slots, 8)
    torch.testing.assert_close(o, attention.tiny_head_attention_plain(qkv), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse2, attention.softmax_lse2(qkv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,slots", [(1, 16), (37, 48), (5, 24), (2048, 64), (3, 128)])
def test_tiny_head_attention_kernel_matches_plain(dev, batch, slots):
    gen = torch.Generator(device=dev).manual_seed(batch + slots)
    qkv = torch.randn(batch, slots, 48, device=dev, generator=gen)
    do = torch.randn(batch, slots, 16, device=dev, generator=gen)
    qk = qkv.clone().requires_grad_(True)
    ok = attention.tiny_head_attention(qk)                 # CUDA -> the kernel
    ok.backward(do)
    qp = qkv.clone().requires_grad_(True)
    op = attention.tiny_head_attention(qp, impl="plain")
    op.backward(do)
    torch.cuda.synchronize()
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(qk.grad, qp.grad, rtol=2e-4, atol=2e-4)


def test_kernels_refuse_what_they_do_not_take(dev):
    x, params, _ = _body_case(dev, 4, 16, 0)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        transformer_body.transformer_body(x.cpu(), [p.cpu() for p in params], impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        attention.tiny_head_attention(torch.zeros(2, 16, 48), impl="kernel")
    with pytest.raises(ValueError, match="float32"):
        transformer_body.transformer_body(x.double(), [p.double() for p in params])
    with pytest.raises(ValueError, match="slots"):
        attention.tiny_head_attention(torch.zeros(2, 129, 48, device=dev))
