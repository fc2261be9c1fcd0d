"""The port's CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach: a batch that is not a multiple of the
kernel's tile, the smallest operand (n = 2, one pair score), an odd slot count
(n = 46: runs of 45 floats and z rows of 4,140 bytes, on no 16-byte boundary),
the launch shapes the defaults do not use, an empty update, a position count
that fills no whole block, sentinel rows, row_offset shards and a hot row
repeated at many positions;
the segment-sum against its plain version and float64 sums at [32768, 26]
with Criteo's vocabularies, a column of one row, a column of distinct rows,
B = 1, B = 1001 (a ragged tile), the search's [512, 8 x 26] and [37, 5], two
launches giving the same bits;
the transformer body and the attention core at batches of 1, 37 and 2048,
the body with x in both layouts its kernels read in place; the body at S = 64
and the dot-product at n = 46 (the supernet's shapes) at batches of 1, 7, 33,
512 and 4096; the supernet's forward and one masked train step at batch 512,
kernels against plain versions; the search's eval body forward at batch 512
and 1024, and two final-only candidates fine-tuned and scored through the
kernels against the plain versions; the transformer body's K-candidate
kernel (K = 2 to 8, f32 and bf16) bit-equal to one-candidate launches on each
candidate's rows and held against its plain version (parameter gradients
1e-5 of their largest magnitude in f32), each kernel's vmap rule launching
once for a group of 4, and three whole-net candidates as one K-candidate
step against the plain path and the one-at-a-time form (test losses 1e-4); device_prefetch's copies on a side stream
against blocking copies over 50 batches; the dense-gradient step's launches (no
table update) for Adam, SGD and Adagrad with wd > 0, against its plain step;
and the micro-batched sparse step's single segment-sum and table update against
one slice;
profiling.dot_flops of the xlarge forward (and of a forward and backward)
through the kernels against the plain versions, and both device checks
(tools/body_device_check.py, tools/sweep_device_check.py); the host-RAM
table's step against the on-device step (1e-4), and the sparse mesh step over
an NCCL group of one rank against the one-device step (equal bits); the
dense parameters' clip and Adagrad as one list (1, 13 and 1,201,920 floats,
300 tensors, zero gradients, eps 1e-2 and 1e-8, tensors on no 16-byte
boundary, the xlarge table's summed gradient in the norm) against its plain
version, three xlarge steps through it against the plain step within
xlarge.uniform's limits, and its counter of fused tensors (86 on xlarge).
The same kernels at the main paths' shapes: the body, the attention core
and the dot-product at batch 32768, f32 and bf16; the transformer node's
fused form against its unfused form; the table update and the segment-sum
over each dataset's full table and the search's capped one; the list
kernels on an xlarge step's 86 tensors.  The paths that run them (training,
the search, the CLIs) are tests/test_torch_cuda_paths.py.

Needs an NVIDIA card; skipped without one.  The port needs no JAX, so on
the card run the two card test files without tests/conftest.py, which
imports JAX (collecting all of tests/ would import the JAX tests too):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py \
        tests/test_torch_cuda_paths.py

Tolerance (f32): the dot-product forward rtol 1e-5 / atol 1e-5, its backward
(dx and dyt) rtol 1e-5 / atol 1e-4 (sums of up to 45 products of N(0,1)
values, ordered differently from cuBLAS), equal bits from two runs; the table
update exact, since the kernel rounds
step by step like the plain version and each row is written by one thread
group.  The segment-sum: rows and is_end exact, seg exactly zero off the run
ends and at them within 2^-20 of the run's sum of |g| from the float64 sums.  The transformer body and the attention core: forward rtol 1e-5 /
atol 1e-5, input gradients rtol 2e-4 / atol 2e-4 (the tolerances the JAX
package holds its TPU kernels to), parameter gradients, which sum over every
position of the batch, 2e-4 of the gradient's largest magnitude.  The saved
softmax statistic (a base-2 log-sum-exp) rtol 1e-5 / atol 1e-5.  The
supernet (seven blocks, f32): logits rtol 1e-4 / atol 1e-4, and after one
train step the loss within 1e-4 and every parameter within 1e-4 (absolute);
the final-only evaluator's test losses and fine-tuned finals within 1e-4.
"""

import pytest
import torch
import torch.nn.functional as F

from nasrec_tpu_torch.ops.kernels import (
    attention,
    dense_adagrad,
    dotprod,
    segment_sum,
    table_update,
    transformer_body,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("batch,n", [(1, 2), (5, 3), (37, 17), (13, 46), (1000, 46),
                                     (32768 + 3, 40), (9, 70), (3, 128), (0, 5)])
def test_dot_scores_tril_kernel_matches_plain(dev, batch, n):
    gen = torch.Generator(device=dev).manual_seed(batch * 100 + n)
    x = torch.randn(batch, 16, device=dev, generator=gen)
    yt = torch.randn(batch, 16, n - 1, device=dev, generator=gen)
    dz = torch.randn(batch, dotprod.tril_size(n), device=dev, generator=gen)

    def run(impl):
        xs, ys = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
        z = dotprod.dot_scores_tril(xs, ys, impl=impl)   # CUDA, "auto" -> the kernel
        z.backward(dz)
        return z.detach(), xs.grad, ys.grad

    before = dict(dotprod.LAUNCHES)
    zk, dxk, dyk = run("auto")
    z2, dx2, dy2 = run("auto")
    zp, dxp, dyp = run("plain")
    torch.cuda.synchronize()
    for key in (f"fwd_n{n}", f"bwd_n{n}"):
        assert dotprod.LAUNCHES[key] == before.get(key, 0) + 2, key

    torch.testing.assert_close(zk, zp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dxk, dxp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dyk, dyp, rtol=1e-5, atol=1e-4)
    # Two runs from the same inputs give the same bits.
    assert torch.equal(zk, z2) and torch.equal(dxk, dx2) and torch.equal(dyk, dy2)


@pytest.mark.parametrize("shape", ["fwd_3x128", "fwd_7x64", "bwd_4", "bwd_8"])
@pytest.mark.parametrize("batch,n", [(5, 3), (37, 17), (1000, 46)])
def test_dot_scores_tril_kernel_other_launch_shapes(dev, batch, n, shape):
    """Tiles, block sizes and feature splits other than the default launch's
    (forward: batch rows a tile x threads; backward: features a thread)."""
    gen = torch.Generator(device=dev).manual_seed(batch + n)
    x = torch.randn(batch, 16, device=dev, generator=gen)
    yt = torch.randn(batch, 16, n - 1, device=dev, generator=gen)
    dz = torch.randn(batch, dotprod.tril_size(n), device=dev, generator=gen)
    xs, ys = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    zp = dotprod.dot_scores_tril_plain(xs, ys)
    dxp, dyp = torch.autograd.grad(zp, [xs, ys], dz)
    kind, tile = shape.split("_")
    key = (kind, n)
    dotprod.TUNE[key] = (tuple(map(int, tile.split("x"))) if kind == "fwd"
                         else (int(tile), 3, 64))
    try:
        if kind == "fwd":
            torch.testing.assert_close(dotprod.dot_scores_tril_fwd_kernel(x, yt), zp.detach(),
                                       rtol=1e-5, atol=1e-5)
        else:
            dxk, dyk = dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
            torch.testing.assert_close(dxk, dxp, rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(dyk, dyp, rtol=1e-5, atol=1e-4)
    finally:
        del dotprod.TUNE[key]


# The main paths' tables: (dataset, rows a slot at most, stacked copies).
# "supernet" is the search-capped table of the supernet and the search,
# "supernet_k8" the whole-net group's 8 stacked copies of it.
TABLES = {"criteo-kaggle": ("criteo-kaggle", None, 1), "avazu": ("avazu", None, 1),
          "kdd": ("kdd", None, 1), "supernet": ("criteo-kaggle", 500_000, 1),
          "supernet_k8": ("criteo-kaggle", 500_000, 8)}


def _table_indices(dev, table, batch, seed):
    """[batch, slots] int32 fused rows over a table of TABLES ("<name>" or
    "<name>:zipf"): each slot's index uniform over its rows (or zipf(1.05),
    clipped), and the first example at every slot's last row, so the update
    reaches the table's highest row.  Returns (indices, the table's rows)."""
    import numpy as np

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.embedding import table_offsets

    name, _, kind = table.partition(":")
    dataset, cap, copies = TABLES[name]
    slots = np.asarray(DATASETS[dataset].vocab_sizes(cap) * copies)
    rng = np.random.RandomState(seed)
    if kind == "zipf":
        cols = np.minimum(rng.zipf(1.05, size=(batch, slots.size)) - 1, slots - 1)
    else:
        cols = (rng.random_sample((batch, slots.size)) * slots).astype(np.int64)
    cols[0] = slots - 1
    idx = cols + np.asarray(table_offsets(tuple(slots)))
    return torch.as_tensor(idx.astype(np.int32), device=dev), int(slots.sum())


def _update_case(dev, vocab, positions, seed, hot_row=None, sentinels=0):
    """vocab: the table's rows, with `positions` uniform indices; or a table
    of TABLES, with a batch of `positions` examples over its slots."""
    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    gen = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(vocab, str):
        idx, vocab = _table_indices(dev, vocab, positions, seed)
    else:
        idx = torch.randint(0, vocab, (positions, 1), device=dev, generator=gen,
                            dtype=torch.int32)
    positions = idx.numel()
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
                         [(100, 0, None, 0), (1000, 777, None, 5), (500, 4096, 7, 3),
                          (3000, 1001, None, 0),    # 1001: no multiple of a block's positions
                          # The main paths' tables: batch 32768 over every slot of
                          # each dataset's full vocab (33,762,601, 9,459,467 and
                          # 50,666,853 rows), and batch 512 over the search's
                          # capped table and the whole-net group's 8 copies of it.
                          ("criteo-kaggle", 32768, None, 0), ("criteo-kaggle:zipf", 32768, None, 0),
                          ("avazu", 32768, None, 0), ("kdd", 32768, None, 0),
                          ("supernet", 512, None, 0), ("supernet:zipf", 512, None, 0),
                          ("supernet_k8", 512, None, 0)])
def test_table_update_kernel_matches_plain(dev, vocab, positions, hot_row, sentinels):
    """Bit for bit over the whole table; no row that no position names changes."""
    seed = vocab if isinstance(vocab, int) else len(vocab)
    rows, seg, table, acc = _update_case(dev, vocab, positions, seed, hot_row, sentinels)
    tk, ak = table.clone(), acc.clone()
    table_update.table_update(tk, ak, rows, seg, 0.05)
    tp, ap = table.clone(), acc.clone()
    table_update.table_update(tp, ap, rows, seg, 0.05, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(tk, tp) and torch.equal(ak, ap)
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    touched[rows[rows < table.shape[0]].long()] = True
    changed = (tk != table).any(1) | (ak != acc).any(1)
    assert not bool((changed & ~touched).any())
    if isinstance(vocab, str):        # the table's last row is among the updated
        assert bool(changed[-1])


@pytest.mark.parametrize("vocab,positions", [(2000, 3000), ("criteo-kaggle", 32768)])
def test_table_update_kernel_row_offset_shards(dev, vocab, positions):
    """Two launches on the table's halves (row_offset 0 and rows / 2, as the
    model ranks of a mesh launch it) give the whole-table launch's bits; the
    second case is Criteo's full table at batch 32768."""
    rows, seg, table, acc = _update_case(dev, vocab, positions, 11, sentinels=2)
    half = table.shape[0] // 2
    whole_t, whole_a = table.clone(), acc.clone()
    table_update.table_update(whole_t, whole_a, rows, seg, 0.05)
    lo_t, lo_a = table[:half].clone(), acc[:half].clone()
    hi_t, hi_a = table[half:].clone(), acc[half:].clone()
    table_update.table_update(lo_t, lo_a, rows, seg, 0.05, row_offset=0)
    table_update.table_update(hi_t, hi_a, rows, seg, 0.05, row_offset=half)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([lo_t, hi_t]), whole_t)
    assert torch.equal(torch.cat([lo_a, hi_a]), whole_a)


def _segsum_case(dev, case):
    """idx2d [B, C] int32 fused rows and g [B*C, 16] of a segment-sum case."""
    import numpy as np

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.embedding import table_offsets

    criteo = DATASETS["criteo-kaggle"].vocab_sizes(None)
    rng = np.random.RandomState(len(case))
    k = 1
    if case == "criteo":              # the main path: batch 32768, Criteo's full vocab
        b, vocab = 32768, criteo
    elif case == "one_row":           # a column of one row: one run across 20 tiles
        b, vocab = 5000, (1, 50, 1)
    elif case == "distinct":          # a column of distinct rows: no run longer than 1
        b, vocab = 3000, (3000, 7)
    elif case == "b1":
        b, vocab = 1, criteo
    elif case == "b1001":             # a ragged last tile; runs across tiles
        b, vocab = 1001, tuple(min(v, 300) for v in criteo)
    elif case == "search_k8":         # the search's 8 stacked tables, [512, 8 x 26]
        b, vocab, k = 512, tuple(min(v, 500_000) for v in criteo), 8
    elif case == "b37":
        b, vocab = 37, (5, 1, 40, 2, 9)
    elif case in ("avazu", "kdd"):    # the other datasets' slots at the main batch
        b, vocab = 32768, DATASETS[case].vocab_sizes(None)
    elif case == "supernet_b512":     # the supernet's step over the search-capped table
        b, vocab = 512, tuple(min(v, 500_000) for v in criteo)
    cols = []
    for v in vocab:
        cols.append(rng.permutation(v)[:b] if case == "distinct" and v == b
                    else rng.randint(0, v, size=b))
    idx = np.stack(cols, 1).astype(np.int64) + np.asarray(table_offsets(vocab))
    # Candidate j's rows lie above candidate j-1's table, column (j, s) of
    # [B, K S] as the whole-net group step lays them out.
    idx = np.concatenate([idx + j * sum(vocab) for j in range(k)], axis=1).astype(np.int32)
    g = rng.randn(b * idx.shape[1], 16).astype(np.float32)
    return torch.as_tensor(idx, device=dev), torch.as_tensor(g, device=dev)


def _segsum_float64(idx2d, g):
    """Each run's float64 sum and sum of |g| (per float, in position order),
    and each column's sum of |g| a position."""
    b, c = idx2d.shape
    rows, order = torch.sort(idx2d.t().long(), dim=1, stable=True)
    g_sorted = torch.take_along_dim(g.double().reshape(b, c, 16).transpose(0, 1),
                                    order[:, :, None], dim=1)
    start = torch.ones_like(rows, dtype=torch.bool)
    start[:, 1:] = rows[:, 1:] != rows[:, :-1]
    run = start.reshape(-1).cumsum(0) - 1
    n = int(run[-1]) + 1
    flat = g_sorted.reshape(-1, 16)
    sums = torch.zeros(n, 16, dtype=torch.float64, device=g.device).index_add_(0, run, flat)
    abs_sums = torch.zeros_like(sums).index_add_(0, run, flat.abs())
    col_abs = g_sorted.abs().sum(dim=1, keepdim=True).expand(c, b, 16).reshape(-1, 16)
    return sums, abs_sums, col_abs


@pytest.mark.parametrize("case", ["criteo", "one_row", "distinct", "b1", "b1001", "search_k8",
                                  "b37", "avazu", "kdd", "supernet_b512"])
def test_segment_sum_kernel_matches_plain_and_float64(dev, case):
    """rows and is_end equal the plain version's; seg is exact zero (+0.0) off
    the run ends, and at them within 2^-20 of the run's sum of |g| from the
    float64 sums (16 ulps of that sum: the worst case of any f32 order for
    runs of up to 17 positions, far above the error of longer ones), and
    within that plus the plain version's own bound ((2B + 1) 2^-24 of the
    column's sum of |g|, a difference of prefix sums) of the plain version's;
    two launches give the same bits."""
    idx2d, g = _segsum_case(dev, case)
    b = idx2d.shape[0]
    before = segment_sum.LAUNCHES["segment_sum"]
    rows, seg, is_end = segment_sum.segment_sum(idx2d, g)       # CUDA, "auto": the kernel
    again = segment_sum.segment_sum(idx2d, g)
    p_rows, p_seg, p_end = segment_sum.segment_sum(idx2d, g, impl="plain")
    torch.cuda.synchronize()
    assert segment_sum.LAUNCHES["segment_sum"] == before + 2
    assert seg.dtype == torch.float32 and seg.is_contiguous() and seg.shape == p_seg.shape
    assert torch.equal(rows, p_rows) and torch.equal(is_end, p_end)
    assert all(torch.equal(a, w) for a, w in zip((rows, seg, is_end), again))
    off = seg[~is_end]
    assert bool((off == 0).all()) and not bool(torch.signbit(off).any())
    sums, abs_sums, col_abs = _segsum_float64(idx2d, g)
    err = (seg[is_end].double() - sums).abs()
    assert bool((err <= 2.0 ** -20 * abs_sums).all()), float(err.max())
    tol = 2.0 ** -20 * torch.zeros_like(col_abs).index_put_((is_end,), abs_sums)
    assert bool(((seg.double() - p_seg.double()).abs()
                 <= tol + (2 * b + 1) * 2.0 ** -24 * col_abs).all())


def test_segment_sum_kernel_refuses_what_it_does_not_take(dev):
    idx2d, g = _segsum_case(dev, "b37")
    shifted = torch.empty(g.numel() + 1, device=dev)[1:].view(g.shape)   # 4 bytes off
    shifted.copy_(g)
    before = dict(segment_sum.LAUNCHES)
    for bad in ((idx2d.long(), g), (idx2d, g.double()), (idx2d, g[:-1]),
                (idx2d.t().contiguous().t(), g), (idx2d, shifted), (idx2d.cpu(), g.cpu())):
        with pytest.raises(ValueError):
            segment_sum.segment_sum_kernel(*bad)
    assert dict(segment_sum.LAUNCHES) == before


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
    xd, yd = torch.zeros(4, 16, device=dev), torch.zeros(4, 16, 7, device=dev)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dotprod.dot_scores_tril(xd.cpu(), yd.cpu(), impl="kernel")
    with pytest.raises(ValueError, match="contiguous"):        # slots not minor
        dotprod.dot_scores_tril_fwd_kernel(xd, torch.zeros(4, 7, 16, device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        dotprod.dot_scores_tril_fwd_kernel(xd.double(), yd.double())
    with pytest.raises(ValueError, match="m >= 1"):            # no slot: no pair
        dotprod.dot_scores_tril_fwd_kernel(xd, yd[:, :, :0].contiguous())
    with pytest.raises(ValueError, match="expected"):          # 8 features
        dotprod.dot_scores_tril_fwd_kernel(xd[:, :8].contiguous(), yd)
    with pytest.raises(ValueError, match="expected"):          # dz of another n
        dotprod.dot_scores_tril_bwd_kernel(xd, yd, torch.zeros(4, 21, device=dev))
    with pytest.raises(ValueError, match="shared memory"):
        dotprod.dot_scores_tril_fwd_kernel(xd, torch.zeros(4, 16, 400, device=dev))
    table = torch.zeros(10, 16, device=dev)
    rows, seg = torch.zeros(3, dtype=torch.int32, device=dev), torch.zeros(3, 16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        table_update.table_update(table, table.clone(), rows.long(), seg, 0.1)
    with pytest.raises(ValueError, match="16-byte"):           # a row is moved in 16-byte pieces
        table_update.table_update(torch.zeros(161, device=dev)[1:].view(10, 16), table, rows,
                                  seg, 0.1)


@pytest.mark.parametrize("batch", [1, 7, 33, 512, 1024, 4096, 8192])
def test_supernet_shapes_body_and_dot_product_match_plain(dev, batch):
    """The supernet's kernel shapes at its training (512) and eval (4096)
    batches, the search's eval chunks (1024 a candidate, 8 x 1024 a group),
    and batches that fill a grid of a few blocks or leave a partial last
    tile."""
    x, params, dout = _body_case(dev, batch, 64, batch + 64, "slot_minor")
    out_k, dx_k, dp_k = _body_grads(x, params, dout, "auto")
    out_p, dx_p, dp_p = _body_grads(x, params, dout, "plain")
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx_k, dx_p, rtol=2e-4, atol=2e-4)
    for name, gk, gp in zip(transformer_body.PARAM_NAMES, dp_k, dp_p):
        assert (gk - gp).abs().max().item() <= 2e-4 * max(1.0, gp.abs().max().item()), name

    gen = torch.Generator(device=dev).manual_seed(batch)
    xd = torch.randn(batch, 16, device=dev, generator=gen)
    yd = torch.randn(batch, 16, 45, device=dev, generator=gen)
    dz = torch.randn(batch, dotprod.tril_size(46), device=dev, generator=gen)
    zk = dotprod.dot_scores_tril_fwd_kernel(xd, yd)
    dxk, dyk = dotprod.dot_scores_tril_bwd_kernel(xd, yd, dz)
    xs, ys = xd.clone().requires_grad_(True), yd.clone().requires_grad_(True)
    zp = dotprod.dot_scores_tril_plain(xs, ys)
    dxp, dyp = torch.autograd.grad(zp, [xs, ys], dz)
    torch.testing.assert_close(zk, zp.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dxk, dxp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dyk, dyp, rtol=1e-5, atol=1e-4)


def test_supernet_forward_and_train_step_kernels_match_plain(dev):
    """Seven xlarge blocks with LayerNorm at batch 512 on sampled masks: the
    forward, then one masked train step, through the kernels and through the
    plain versions from the same weights; every block launches its body and
    dot-product kernels whatever its gates."""
    import copy

    import numpy as np

    from nasrec_tpu_torch.choices import ChoiceMasks, choice_to_masks
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_apply, supernet_init
    from nasrec_tpu_torch.sampling import ChoiceSampler
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    space = OPS_CONFIG_LIB["xlarge"]
    cfg = SuperNetConfig(space=space, num_blocks=7, num_dense=13, num_sparse=26,
                         vocab_sizes=(1000,) * 26, use_layernorm=True)
    model_k = supernet_init(cfg, seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    sampler = ChoiceSampler(space, 7, strategy="default", anypath_choice="binomial-0.5", seed=1)
    masks = ChoiceMasks.stack([choice_to_masks(sampler(), space, 7)
                               for _ in range(2)]).to(dev)
    rng = np.random.RandomState(0)
    dense = torch.as_tensor(rng.randn(512, 13).astype(np.float32), device=dev)
    cat = torch.as_tensor(rng.randint(0, 1000, size=(512, 26)).astype(np.int32), device=dev)
    y = torch.as_tensor(rng.randint(0, 2, size=(512, 1)).astype(np.float32), device=dev)

    with torch.no_grad():
        before = dict(transformer_body.LAUNCHES)
        out_k = supernet_apply(model_k, dense, cat, masks.select(0))
        assert transformer_body.LAUNCHES["fwd_s64"] == before.get("fwd_s64", 0) + 7
        out_p = supernet_apply(model_p, dense, cat, masks.select(0), impl="plain")
    torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)

    res = []
    for model, impl in ((model_k, "auto"), (model_p, "plain")):
        step = make_sparse_embedding_train_step(lambda s: 0.05, impl=impl, has_masks=True)
        state, metrics = step(init_sparse_train_state(model), dense, cat, y, (masks, 1))
        res.append(float(metrics["loss"]))
    assert abs(res[0] - res[1]) <= 1e-4
    sd_k, sd_p = model_k.state_dict(), model_p.state_dict()
    for name in sd_k:
        assert (sd_k[name] - sd_p[name]).abs().max().item() <= 1e-4, name


@pytest.mark.parametrize("batch", [512, 1024, 4096, 8192])
def test_search_shapes_body_eval_forward_matches_plain(dev, batch):
    """The search's eval body forward at S = 64: a fine-tune step's batch (512)
    and an eval chunk (1024), and a group of 8 candidates' of each folded into
    one launch (4096, 8192), x as the slot projection leaves it."""
    x, params, _ = _body_case(dev, batch, 64, batch + 7, "slot_minor")
    before = transformer_body.LAUNCHES["fwd_s64"]
    with torch.no_grad():
        out_k = transformer_body.transformer_body(x, params)
        out_p = transformer_body.transformer_body(x, params, impl="plain")
    assert transformer_body.LAUNCHES["fwd_s64"] == before + 1
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-5)


def test_final_only_evaluator_kernels_match_plain(dev):
    """Two final-only candidates over a seven-block xlarge supernet with
    LayerNorm at batch 512 (eval chunks of 1024): the kernel path launches
    only the eval body forward and the dot-product forward, once a block for
    the group (at batch 2 x 512, and 2 x 1024 an eval chunk), and its scores
    and fine-tuned finals match the plain path's."""
    import numpy as np

    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.search import Tokenizer, make_candidate_evaluator

    space = OPS_CONFIG_LIB["xlarge"]
    cfg = SuperNetConfig(space=space, num_blocks=7, num_dense=13, num_sparse=26,
                         vocab_sizes=(1000,) * 26, use_layernorm=True)
    model = supernet_init(cfg, seed=0, device=dev)
    tok = Tokenizer(7, space, seed=2)
    picks = [tok.generate_random_choice() for _ in range(2)]
    rng = np.random.RandomState(0)

    def batch(n):
        return (torch.as_tensor(rng.randn(n, 13).astype(np.float32), device=dev),
                torch.as_tensor(rng.randint(0, 1000, size=(n, 26)).astype(np.int32), device=dev),
                torch.as_tensor(rng.randint(0, 2, size=(n, 1)).astype(np.float32), device=dev))

    train, test = [batch(512) for _ in range(3)], [batch(2048)]
    args = dict(max_train_steps=4, max_eval_steps=1, eval_batch_chunk=1024)
    ev_k = make_candidate_evaluator(cfg, model, **args)
    before = _launches()
    res_k = ev_k(picks, lambda: iter(train), lambda: iter(test))
    # 4 steps and 2 eval chunks, each 7 blocks for the group.
    assert _launched(before) == {"dot_fwd_n46": 6 * 7, "body_fwd_s64": 6 * 7}
    ev_p = make_candidate_evaluator(cfg, model, impl="plain", **args)
    res_p = ev_p(picks, lambda: iter(train), lambda: iter(test))
    for a, b in zip(res_k, res_p):
        assert abs(a["test_loss"] - b["test_loss"]) <= 1e-4
    assert (ev_k.last_group.weight - ev_p.last_group.weight).abs().max().item() <= 1e-4
    assert (ev_k.last_group.bias - ev_p.last_group.bias).abs().max().item() <= 1e-4


def _body_k_case(dev, k, batch, slots, dtype, seed):
    """K candidates' parameters [K, ...], x [K batch, S, 16] slot-minor, and an
    output gradient that is zero on the rows where a ReLU input lies within
    rounding of zero (see _body_case), found on x as the kernel reads it (in
    bf16, the rounded x)."""
    cases = [_body_case(dev, batch, slots, seed + i, "slot_minor") for i in range(k)]
    x = torch.cat([c[0].transpose(1, 2) for c in cases]).to(dtype).transpose(1, 2)
    params = [torch.stack(ps) for ps in zip(*(c[1] for c in cases))]
    dout = torch.cat([_body_case_from(x[i * batch:(i + 1) * batch].float(), c[1], c[2])[2]
                      for i, c in enumerate(cases)]).to(dtype)
    return x, params, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,batch,slots", [(2, 1, 16), (3, 37, 48), (8, 512, 64), (5, 333, 64),
                                           (8, 1024, 64)])
def test_transformer_body_k_kernel_matches_plain_and_single_launches(dev, k, batch, slots,
                                                                      dtype):
    """The K-candidate launch gives each candidate's rows and parameter
    gradients the bits of a one-candidate launch on them (a candidate's rows
    are partitioned as that launch partitions them), and matches the
    K-candidate plain version: forward as the one-candidate kernel is held,
    dx 2e-4, parameter gradients 1e-5 of their largest magnitude in f32 (1e-3
    in bf16, as test_transformer_body_bf16_kernel_matches_plain)."""
    tb = transformer_body
    x, params, dout = _body_k_case(dev, k, batch, slots, dtype, 7 * k + batch)
    flat = tb.flatten_params(params)
    assert flat.shape == (k, tb.NUM_PARAM_FLOATS)
    out_e, _, _ = tb.transformer_body_fwd_kernel(x, flat, save=False)
    out_t, o, st = tb.transformer_body_fwd_kernel(x, flat, save=True)
    dx, dflat = tb.transformer_body_bwd_kernel(x, dout, o, st, flat)
    for i in range(k):
        rows = slice(i * batch, (i + 1) * batch)
        oe1, _, _ = tb.transformer_body_fwd_kernel(x[rows], flat[i], save=False)
        ot1, o1, st1 = tb.transformer_body_fwd_kernel(x[rows], flat[i], save=True)
        dx1, df1 = tb.transformer_body_bwd_kernel(x[rows], dout[rows].contiguous(), o1, st1,
                                                  flat[i])
        assert torch.equal(out_e[rows], oe1) and torch.equal(out_t[rows], ot1)
        assert torch.equal(o[rows], o1) and torch.equal(st[rows], st1)
        assert torch.equal(dx[rows], dx1) and torch.equal(dflat[i], df1)

    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    out_p = tb.transformer_body_k_plain(xg, pg)
    grads = torch.autograd.grad(out_p, [xg] + pg, dout)
    if dtype == torch.bfloat16:
        _within_bf16_ulp(out_e, out_p.detach(), "out")
        _within_bf16_ulp(dx, grads[0], "dx")
        ptol = 1e-3
    else:
        torch.testing.assert_close(out_e, out_p.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx, grads[0], rtol=2e-4, atol=2e-4)
        ptol = 1e-5
    dp = [g.reshape(gp.shape) for g, gp in zip(dflat.split(tb.PARAM_SIZES, dim=1), grads[1:])]
    for name, gk, gp in zip(tb.PARAM_NAMES, dp, grads[1:]):
        assert (gk - gp).abs().max().item() <= ptol * max(1.0, gp.abs().max().item()), name


@pytest.mark.parametrize("k,b", [(4, 33), (8, 512)])
def test_vmap_rules_launch_the_k_candidate_forms(dev, k, b):
    """Under torch.func.vmap over K candidates (4 of 33 rows; the search's
    group, 8 of 512) each kernel launches once for the group, forward and
    backward (the body's K-candidate form where the parameters vary, its
    one-candidate form where they are shared), and the results match the plain
    versions; the attention core's equal the bits of one launch a candidate."""
    tb = transformer_body
    x, params, dout = _body_k_case(dev, k, b, 64, torch.float32, 3)
    gen = torch.Generator(device=dev).manual_seed(5)
    xd = torch.randn(k, b, 16, device=dev, generator=gen, requires_grad=True)
    yt = torch.randn(k, b, 16, 45, device=dev, generator=gen, requires_grad=True)
    qkv = torch.randn(k, b, 64, 48, device=dev, generator=gen, requires_grad=True)

    def run(impl):
        xs = x.clone().requires_grad_(True)
        ps = [p.clone().requires_grad_(True) for p in params]
        body = torch.func.vmap(lambda xi, *p: tb.transformer_body(xi, list(p), impl=impl))(
            xs.reshape(k, b, 64, 16), *ps)
        shared = torch.func.vmap(lambda xi: tb.transformer_body(xi, [p[0] for p in ps],
                                                                impl=impl))(
            xs.reshape(k, b, 64, 16))
        z = torch.func.vmap(lambda a, c: dotprod.dot_scores_tril(a, c, impl))(xd, yt)
        o = torch.func.vmap(lambda q: attention.tiny_head_attention(q, impl=impl))(qkv)
        outs = [body.reshape(k * b, 64, 16), shared.reshape(k * b, 64, 16), z, o]
        grads = torch.autograd.grad(outs, [xs, *ps, xd, yt, qkv],
                                    [dout, dout, torch.ones_like(z), torch.ones_like(o)])
        return outs, grads

    before = _launches()
    outs_k, grads_k = run("auto")
    assert _launched(before) == {f"body_fwd_train_s64_k{k}": 1, f"body_bwd_s64_k{k}": 1,
                                 "body_fwd_train_s64": 1, "body_bwd_s64": 1,
                                 "dot_fwd_n46": 1, "dot_bwd_n46": 1, "attn_fwd_s64": 1,
                                 "attn_bwd_s64": 1}
    for i in range(k):
        q = qkv.detach()[i]
        assert torch.equal(outs_k[3][i], attention.tiny_head_attention_fwd_kernel(q))
        assert torch.equal(grads_k[-1][i], attention.tiny_head_attention_bwd_kernel(
            q, torch.ones_like(outs_k[3][i])))
    outs_p, grads_p = run("plain")
    for a, w in zip(outs_k, outs_p):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    for a, w in zip(grads_k, grads_p):
        assert (a - w).abs().max().item() <= 2e-4 * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("mode", ["whole", "layernorm-calibrate"])
def test_batched_whole_evaluator_kernels_match_plain(dev, mode):
    """Three candidates over a two-block xlarge supernet at batch 512 as one
    K-candidate step, in the whole-net mode and in the LayerNorm-calibrate
    mode: each step launches each kernel once a block for the group, and the
    whole-net mode the segment-sum and the table update once (the calibrate
    mode leaves the table frozen); scores within 1e-4 of the plain path's and
    of the one-at-a-time form's."""
    import numpy as np

    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.search import Tokenizer, make_candidate_evaluator

    space = OPS_CONFIG_LIB["xlarge"]
    cfg = SuperNetConfig(space=space, num_blocks=2, num_dense=13, num_sparse=26,
                         vocab_sizes=(1000,) * 26, use_layernorm=True)
    model = supernet_init(cfg, seed=0, device=dev)
    tok = Tokenizer(2, space, seed=4)
    picks = [tok.generate_random_choice() for _ in range(3)]
    rng = np.random.RandomState(0)

    def batch(n):
        return (torch.as_tensor(rng.randn(n, 13).astype(np.float32), device=dev),
                torch.as_tensor(rng.randint(0, 1000, size=(n, 26)).astype(np.int32), device=dev),
                torch.as_tensor(rng.randint(0, 2, size=(n, 1)).astype(np.float32), device=dev))

    train, test = [batch(512) for _ in range(3)], [batch(2048)]
    args = dict(max_train_steps=3, max_eval_steps=1, eval_batch_chunk=1024,
                finetune_mode=mode)
    ev_k = make_candidate_evaluator(cfg, model, **args)
    before = _launches()
    res_k = ev_k(picks, lambda: iter(train), lambda: iter(test))
    # 3 steps of 2 blocks, then 2 eval chunks of 2 blocks.
    table = {"table_update": 3, "segment_sum": 3} if mode == "whole" else {}
    assert _launched(before) == {"body_fwd_train_s64_k3": 6, "body_bwd_s64_k3": 6,
                                 "dot_fwd_n46": 6 + 4, "dot_bwd_n46": 6,
                                 "body_fwd_s64_k3": 4, **table}
    res_p = make_candidate_evaluator(cfg, model, impl="plain", **args)(
        picks, lambda: iter(train), lambda: iter(test))
    res_s = make_candidate_evaluator(cfg, model, batch_candidates=False, **args)(
        picks, lambda: iter(train), lambda: iter(test))
    for a, b, c in zip(res_k, res_p, res_s):
        assert abs(a["test_loss"] - b["test_loss"]) <= 1e-4
        assert abs(a["test_loss"] - c["test_loss"]) <= 1e-4


def test_device_prefetch_matches_a_blocking_copy(dev):
    """50 batches through device_prefetch (pinned host buffers, copies on a side
    stream, 2 ahead) equal the same batches copied with .to(dev), while the
    consumer's stream is kept busy between batches."""
    import numpy as np

    from nasrec_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.RandomState(0)
    batches = [(rng.randn(4096, 13).astype(np.float32),
                rng.randint(0, 1 << 30, size=(4096, 26)).astype(np.int32),
                rng.randint(0, 2, size=(4096, 1)).astype(np.float32)) for _ in range(50)]
    busy = torch.randn(2048, 2048, device=dev)
    got = []
    for out in device_prefetch(iter(batches), dev):
        busy = busy @ busy / 2048.0                  # queue work on the consumer's stream
        got.append(tuple(t.clone() for t in out))
    torch.cuda.synchronize()
    assert len(got) == 50
    for g, host in zip(got, batches):
        for t, a in zip(g, host):
            assert t.device.type == "cuda"
            assert torch.equal(t, torch.from_numpy(a).to(dev))


def _fixed_case(dev, batch, vocab=1000):
    import numpy as np

    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.configs import get_best_arch
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init

    plan = build_fixed_plan(get_best_arch("criteo-kaggle", "xlarge"), OPS_CONFIG_LIB["xlarge"],
                            7, 13, 26, (vocab,) * 26)
    rng = np.random.RandomState(1)
    data = (torch.as_tensor(rng.randn(batch, 13).astype(np.float32), device=dev),
            torch.as_tensor(rng.randint(0, vocab, size=(batch, 26)).astype(np.int32), device=dev),
            torch.as_tensor(rng.randint(0, 2, size=(batch, 1)).astype(np.float32), device=dev))
    return fixed_init(plan, seed=0, device=dev), data


def _launches():
    return {**{"dot_" + k: v for k, v in dotprod.LAUNCHES.items()},
            **{"body_" + k: v for k, v in transformer_body.LAUNCHES.items()},
            **{"attn_" + k: v for k, v in attention.LAUNCHES.items()},
            **table_update.LAUNCHES, **segment_sum.LAUNCHES, **dense_adagrad.LAUNCHES}


def _launched(before):
    return {k: v - before.get(k, 0) for k, v in _launches().items() if v != before.get(k, 0)}


XLARGE_STEP = {"dot_fwd_n40": 1, "dot_fwd_n9": 1, "dot_bwd_n40": 1, "dot_bwd_n9": 1,
               "body_fwd_train_s64": 1, "body_fwd_train_s48": 1, "body_bwd_s64": 1,
               "body_bwd_s48": 1}
# A sparse step adds the segment-sum, the table update, and the dense
# parameters' clip and Adagrad update as one list each.
XLARGE_SPARSE_STEP = {**XLARGE_STEP, "segment_sum": 1, "table_update": 1, "clip_scale": 1,
                      "adagrad": 1}


def _times(launches, n):
    return {k: v * n for k, v in launches.items()}


@pytest.mark.parametrize("optimizer,wd", [("adam", 0.0), ("sgd", 0.0), ("adagrad", 1e-6)])
def test_dense_step_launches_the_body_and_dot_product_kernels(dev, optimizer, wd):
    """One dense-gradient xlarge step launches the body and dot-product kernels
    forward and backward, and no table update; with Adagrad the optimizer's
    update is one launch of the list kernel; its loss (1e-4), logits (1e-3),
    parameters and optimizer slots match the plain step's (Adam's moments
    within 1e-4 of their largest magnitude, other slots within 1e-4)."""
    import copy

    from nasrec_tpu_torch.train.loop import init_train_state, make_train_step
    from nasrec_tpu_torch.train.optim import make_optimizer, slot_dicts

    model_k, batch = _fixed_case(dev, 1024)
    model_p = copy.deepcopy(model_k)
    losses, logits, slots = [], [], []
    for model, impl in ((model_k, "auto"), (model_p, "plain")):
        opt = make_optimizer(optimizer)
        step = make_train_step(opt, lambda s: 1e-3, l2_reg=wd, impl=impl)
        before = _launches()
        state, metrics = step(init_train_state(model, opt), *batch)
        losses.append(float(metrics["loss"]))
        logits.append(metrics["logits"])
        slots.append(slot_dicts(state.opt_state))
        # Adagrad's update is the list kernel's; the dense step's clip is its own.
        want = {**XLARGE_STEP, **({"adagrad": 1} if optimizer == "adagrad" else {})}
        assert _launched(before) == (want if impl == "auto" else {})
    assert abs(losses[0] - losses[1]) <= 1e-4
    assert (logits[0] - logits[1]).abs().max().item() <= 1e-3
    sd_k, sd_p = model_k.state_dict(), model_p.state_dict()
    # Adam's first step moves an element by lr times its gradient's sign: an
    # element whose gradient rounds to opposite signs differs by 2 lr.
    tol = 1e-4 + (2e-3 if optimizer == "adam" else 0.0)
    for name in sd_k:
        assert (sd_k[name] - sd_p[name]).abs().max().item() <= tol, name
    for slot_k, slot_p in zip(*slots):
        for name, want in slot_p.items():
            scale = max(1.0, want.abs().max().item()) if optimizer == "adam" else 1.0
            assert (slot_k[name] - want).abs().max().item() <= 1e-4 * scale, name


def test_micro_batched_step_updates_the_table_once(dev):
    """micro_batches = 2: each slice launches the body and dot-product kernels,
    the step one table update; parameters and accumulators match one slice's."""
    import copy

    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model_1, batch = _fixed_case(dev, 2048)
    model_2 = copy.deepcopy(model_1)
    states = []
    for model, micro in ((model_1, 1), (model_2, 2)):
        step = make_sparse_embedding_train_step(lambda s: 0.05, microbatch=micro)
        before = _launches()
        state, _ = step(init_sparse_train_state(model), *batch)
        assert _launched(before) == {**XLARGE_SPARSE_STEP, **_times(XLARGE_STEP, micro)}
        states.append(state)
    sd_1, sd_2 = model_1.state_dict(), model_2.state_dict()
    for name in sd_1:
        assert (sd_1[name] - sd_2[name]).abs().max().item() <= 1e-4, name
        a_1, a_2 = states[0].opt_state[name], states[1].opt_state[name]
        assert (a_1 - a_2).abs().max().item() <= 1e-4, name


# bf16 (activations in bf16, f32 inside the kernels): each kernel output is
# one rounding of an f32 value, as in its plain version, so outputs are held
# to one bf16 unit in the last place elementwise, or to 1e-6 of the largest
# element where an f32 sum cancelled far below its terms (the two sums then
# differ by their own f32 rounding, which is several ulps of so small a
# value); the body's f32 parameter gradients to 1e-3 of the largest element.


def _within_bf16_ulp(got, want, what):
    assert got.dtype == want.dtype == torch.bfloat16, what

    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    floor = 1e-6 * want.float().abs().max().item()
    ok = ((ordered(got) - ordered(want)).abs() <= 1) | ((got.float() - want.float()).abs() <= floor)
    assert bool(ok.all()), f"{what}: {int((~ok).sum())} elements beyond one bf16 ulp"


@pytest.mark.parametrize("batch,n", [(1, 2), (5, 3), (33, 9), (37, 17), (13, 46), (1000, 46),
                                     (1001, 40), (0, 5)])
def test_dot_scores_tril_bf16_kernel_matches_plain(dev, batch, n):
    gen = torch.Generator(device=dev).manual_seed(batch * 100 + n)
    x = torch.randn(batch, 16, device=dev, generator=gen).bfloat16()
    yt = torch.randn(batch, 16, n - 1, device=dev, generator=gen).bfloat16()
    dz = torch.randn(batch, dotprod.tril_size(n), device=dev, generator=gen).bfloat16()

    def run(impl):
        xs, ys = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
        z = dotprod.dot_scores_tril(xs, ys, impl=impl)
        z.backward(dz)
        return z.detach(), xs.grad, ys.grad

    before = dict(dotprod.LAUNCHES)
    zk, dxk, dyk = run("auto")
    z2, dx2, dy2 = run("auto")
    zp, dxp, dyp = run("plain")
    torch.cuda.synchronize()
    for key in (f"fwd_n{n}_bf16", f"bwd_n{n}_bf16"):
        assert dotprod.LAUNCHES[key] == before.get(key, 0) + 2, key
    assert dotprod.LAUNCHES[f"fwd_n{n}"] == before.get(f"fwd_n{n}", 0)
    for got, want, what in ((zk, zp, "z"), (dxk, dxp, "dx"), (dyk, dyp, "dyt")):
        if batch:
            _within_bf16_ulp(got, want, what)
    assert torch.equal(zk, z2) and torch.equal(dxk, dx2) and torch.equal(dyk, dy2)


def test_dot_scores_tril_bf16_kernel_takes_dz_at_any_offset(dev):
    """A dz row tile starts on any 2-byte boundary: a view one element into
    a larger tensor."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, batch = 9, 301
    x = torch.randn(batch, 16, device=dev, generator=gen).bfloat16()
    yt = torch.randn(batch, 16, n - 1, device=dev, generator=gen).bfloat16()
    big = torch.randn(batch * dotprod.tril_size(n) + 1, device=dev, generator=gen).bfloat16()
    dz = big[1:].view(batch, dotprod.tril_size(n))
    dxk, dyk = dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
    xs, ys = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    dxp, dyp = torch.autograd.grad(dotprod.dot_scores_tril_plain(xs, ys), [xs, ys], dz)
    _within_bf16_ulp(dxk, dxp, "dx")
    _within_bf16_ulp(dyk, dyp, "dyt")


def _body_case_bf16(dev, batch, slots, seed, layout):
    x, params, dout = _body_case(dev, batch, slots, seed, layout)
    xb = x.bfloat16()
    if layout == "slot_minor":
        xb = xb.transpose(1, 2).contiguous().transpose(1, 2)
    # The ReLU-edge rows of the bf16 input (the kernel and the plain version
    # both compute from it in f32).
    _, _, edge = _body_case_from(xb.float(), params, dout)
    return xb, params, edge.bfloat16()


def _body_case_from(x, params, dout):
    dout = dout.clone()
    with torch.no_grad():
        w_in, b_in, w_out, b_out, g1, h1, fc1w, fc1b = params[:8]
        o = attention.tiny_head_attention_plain(F.linear(x, w_in, b_in))
        x4 = F.layer_norm(F.linear(o, w_out, b_out) + x, (16,), g1, h1, 1e-5)
        dout[(F.linear(x4, fc1w, fc1b).abs() < 1e-5).flatten(1).any(1)] = 0.0
    return x, params, dout


@pytest.mark.parametrize("layout", ["contiguous", "slot_minor"])
@pytest.mark.parametrize("slots", [16, 48, 64])
@pytest.mark.parametrize("batch", [1, 37, 2048])
def test_transformer_body_bf16_kernel_matches_plain(dev, batch, slots, layout):
    x, params, dout = _body_case_bf16(dev, batch, slots, batch * 10 + slots, layout)
    before = dict(transformer_body.LAUNCHES)
    with torch.no_grad():
        out_eval = transformer_body.transformer_body(x, params)
    out_k, dx_k, dp_k = _body_grads(x, params, dout, "auto")
    out_p, dx_p, dp_p = _body_grads(x, params, dout, "plain")
    _, dx_2, dp_2 = _body_grads(x, params, dout, "auto")
    torch.cuda.synchronize()
    for key in (f"fwd_s{slots}_bf16", f"fwd_train_s{slots}_bf16", f"bwd_s{slots}_bf16"):
        assert transformer_body.LAUNCHES[key] > before.get(key, 0), key
    assert out_k.dtype == dx_k.dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in dp_k)
    assert torch.equal(out_eval, out_k) and dx_k.stride() == x.stride()
    _within_bf16_ulp(out_k, out_p, "out")
    _within_bf16_ulp(dx_k, dx_p, "dx")
    for name, gk, gp in zip(transformer_body.PARAM_NAMES, dp_k, dp_p):
        assert (gk - gp).abs().max().item() <= 1e-3 * max(1e-6, gp.abs().max().item()), name
    assert torch.equal(dx_k, dx_2) and all(torch.equal(a, b) for a, b in zip(dp_k, dp_2))


def test_transformer_body_bf16_kernel_saves_f32_residuals(dev):
    x, params, _ = _body_case_bf16(dev, 37, 48, 3, "slot_minor")
    flat = transformer_body.flatten_params(params)
    out, o, lse2 = transformer_body.transformer_body_fwd_kernel(x, flat, save=True)
    qkv = F.linear(x.float(), params[0], params[1])
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and o.dtype == lse2.dtype == torch.float32
    torch.testing.assert_close(o, attention.tiny_head_attention_plain(qkv), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse2, attention.softmax_lse2(qkv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,slots", [(1, 16), (37, 48), (2048, 64), (3, 128)])
def test_tiny_head_attention_bf16_kernel_matches_plain(dev, batch, slots):
    gen = torch.Generator(device=dev).manual_seed(batch + slots)
    qkv = torch.randn(batch, slots, 48, device=dev, generator=gen).bfloat16()
    do = torch.randn(batch, slots, 16, device=dev, generator=gen).bfloat16()
    before = dict(attention.LAUNCHES)
    qk = qkv.clone().requires_grad_(True)
    ok = attention.tiny_head_attention(qk)
    ok.backward(do)
    qp = qkv.clone().requires_grad_(True)
    op = attention.tiny_head_attention(qp, impl="plain")
    op.backward(do)
    torch.cuda.synchronize()
    for key in (f"fwd_s{slots}_bf16", f"bwd_s{slots}_bf16"):
        assert attention.LAUNCHES[key] == before.get(key, 0) + 1, key
    _within_bf16_ulp(ok, op, "o")
    _within_bf16_ulp(qk.grad, qp.grad, "dqkv")


def test_bf16_kernels_refuse_mixed_operands(dev):
    xd = torch.zeros(4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        dotprod.dot_scores_tril_fwd_kernel(xd, torch.zeros(4, 16, 7, device=dev))
    with pytest.raises(ValueError, match="bfloat16"):
        dotprod.dot_scores_tril_fwd_kernel(xd.half(), torch.zeros(4, 16, 7, device=dev).half())
    x, params, _ = _body_case_bf16(dev, 4, 16, 0, "contiguous")
    flat = transformer_body.flatten_params(params)
    out, o, lse2 = transformer_body.transformer_body_fwd_kernel(x, flat, save=True)
    with pytest.raises(ValueError, match="float32"):          # o must stay f32
        transformer_body.transformer_body_bwd_kernel(x, out, o.bfloat16(), lse2, flat)
    with pytest.raises(ValueError, match="bfloat16"):         # dout in x's dtype
        transformer_body.transformer_body_bwd_kernel(x, out.float(), o, lse2, flat)
    with pytest.raises(ValueError, match="float32"):          # the table stays f32
        table = torch.zeros(10, 16, device=dev, dtype=torch.bfloat16)
        table_update.table_update(table, table.clone(), torch.zeros(3, dtype=torch.int32,
                                                                      device=dev),
                                  torch.zeros(3, 16, device=dev, dtype=torch.bfloat16), 0.1)


# The kernels at the main paths' batch, 32768, on the operands as the nodes
# hold them: the body and the attention core at S = 64 and 48
# (criteo-kaggle/xlarge) and 16 (the avazu and kdd xlarge archs), the
# dot-product at n = 40, 9 (xlarge), 46, 17 (autoctr) and 33
# (avazu/autoctr).  f32: an output within 1e-5 of the plain version's largest
# magnitude (or of 1), dx and the parameter gradients, which sum over the
# slots and over all 2 M positions of the batch, within 1e-4.  bf16: outputs
# in bf16 within one bf16 ulp (as above), f32 residuals as in f32, parameter
# gradients within 1e-3.

MAIN_BATCH = 32768


def _agree(got, want, rel_tol, what):
    if want.dtype == torch.bfloat16:
        _within_bf16_ulp(got, want, what)
        return
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel_tol * max(1.0, want.float().abs().max().item()), (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slots", [64, 48, 16])
def test_transformer_body_kernel_at_the_main_batch(dev, slots, dtype):
    """Eval forward, training forward (out, o, the statistic) and backward (dx
    and the twelve parameter gradients) against the plain version, x as the
    slot projection leaves it; equal bits from two backward runs, and from x
    laid out contiguous."""
    tb = transformer_body
    gen = torch.Generator(device=dev).manual_seed(slots)
    x = torch.randn(MAIN_BATCH, 16, slots, device=dev, generator=gen).to(dtype).transpose(1, 2)
    dout = torch.randn(MAIN_BATCH, slots, 16, device=dev, generator=gen).to(dtype)
    params = []
    for name, shape in zip(tb.PARAM_NAMES, tb.PARAM_SHAPES):
        p = 0.3 * torch.randn(shape, device=dev, generator=gen)
        params.append(p + 0.17 if name in ("attn_ln_w", "fc_ln_w") else p)
    _, _, dout = _body_case_from(x.float(), params, dout)
    flat = tb.flatten_params(params)

    out_e, _, _ = tb.transformer_body_fwd_kernel(x, flat, save=False)
    out_t, o_k, st_k = tb.transformer_body_fwd_kernel(x, flat, save=True)
    dx_k, dflat_k = tb.transformer_body_bwd_kernel(x, dout, o_k, st_k, flat)
    dx_2, dflat_2 = tb.transformer_body_bwd_kernel(x, dout, o_k, st_k, flat)
    assert torch.equal(out_e, out_t) and torch.equal(dx_k, dx_2) and torch.equal(dflat_k, dflat_2)
    xc = x.contiguous()
    out_c, o_c, st_c = tb.transformer_body_fwd_kernel(xc, flat, save=True)
    dx_c, dflat_c = tb.transformer_body_bwd_kernel(xc, dout, o_c, st_c, flat)
    assert dx_c.is_contiguous() and dx_k.transpose(1, 2).is_contiguous()
    for a, b in ((out_c, out_t), (o_c, o_k), (st_c, st_k), (dx_c, dx_k), (dflat_c, dflat_k)):
        assert torch.equal(a, b)
    del xc, out_c, o_c, st_c, dx_c, dflat_c

    with torch.no_grad():
        qkv = F.linear(x.float(), params[0], params[1])
        _agree(o_k, attention.tiny_head_attention_plain(qkv), 1e-5, "o")
        _agree(st_k, attention.softmax_lse2(qkv), 1e-5, "statistic")
        del qkv
    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    out_p = tb.transformer_body_plain(xg, pg)
    grads = torch.autograd.grad(out_p, [xg] + pg, dout)
    _agree(out_e, out_p.detach(), 1e-5, "out")
    _agree(dx_k, grads[0], 1e-4, "dx")
    ptol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    for name, g, want in zip(tb.PARAM_NAMES, dflat_k.split(tb.PARAM_SIZES), grads[1:]):
        _agree(g.reshape(want.shape), want, ptol, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slots", [64, 48, 16])
def test_tiny_head_attention_kernel_at_the_main_batch(dev, slots, dtype):
    gen = torch.Generator(device=dev).manual_seed(slots + 1)
    qkv = torch.randn(MAIN_BATCH, slots, 48, device=dev, generator=gen).to(dtype)
    do = torch.randn(MAIN_BATCH, slots, 16, device=dev, generator=gen).to(dtype)
    o_k = attention.tiny_head_attention_fwd_kernel(qkv)
    dqkv_k = attention.tiny_head_attention_bwd_kernel(qkv, do)
    qg = qkv.clone().requires_grad_(True)
    o_p = attention.tiny_head_attention_plain(qg)
    (dqkv_p,) = torch.autograd.grad(o_p, qg, do)
    _agree(o_k, o_p.detach(), 1e-5, "o")
    _agree(dqkv_k, dqkv_p, 1e-4, "dqkv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [46, 17, 40, 9, 33])
def test_dot_scores_tril_kernel_at_the_main_batch(dev, n, dtype):
    """x [B, 16] and yt [B, 16, n - 1] as the node holds them; equal bits
    from two runs."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(MAIN_BATCH, 16, device=dev, generator=gen).to(dtype)
    yt = torch.randn(MAIN_BATCH, 16, n - 1, device=dev, generator=gen).to(dtype)
    dz = torch.randn(MAIN_BATCH, dotprod.tril_size(n), device=dev, generator=gen).to(dtype)
    z_k = dotprod.dot_scores_tril_fwd_kernel(x, yt)
    dx_k, dy_k = dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
    z_2 = dotprod.dot_scores_tril_fwd_kernel(x, yt)
    dx_2, dy_2 = dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
    assert torch.equal(z_k, z_2) and torch.equal(dx_k, dx_2) and torch.equal(dy_k, dy_2)
    xg, yg = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    z_p = dotprod.dot_scores_tril_plain(xg, yg)
    dx_p, dy_p = torch.autograd.grad(z_p, [xg, yg], dz)
    for got, want, what in ((z_k, z_p.detach(), "z"), (dx_k, dx_p, "dx"), (dy_k, dy_p, "dyt")):
        _agree(got, want, 1e-5, what)


def test_transformer_node_fused_form_matches_its_unfused_form(dev):
    """The xlarge plan's block-0 transformer node (26 -> 64 slots) at batch
    32768: the body kernels against PyTorch ops around the attention kernel,
    output within 1e-5 and input gradient within 1e-4."""
    from nasrec_tpu_torch.ops.attention import Transformer

    gen = torch.Generator(device=dev).manual_seed(3)
    node = Transformer(26, 64, 16, False, gen, dev)
    sparse = torch.randn(MAIN_BATCH, 26 * 16, device=dev, generator=gen)
    co = torch.randn(MAIN_BATCH, 64 * 16, device=dev, generator=gen)
    with torch.no_grad():
        x = node.proj(sparse.reshape(MAIN_BATCH, 26, 16).transpose(1, 2)).transpose(1, 2)
    _, _, co = _body_case_from(x, node.body_params(), co.reshape(MAIN_BATCH, 64, 16))
    co = co.reshape(MAIN_BATCH, 64 * 16)
    res = []
    for fused in (True, False):
        node.fused = fused
        xs = sparse.clone().requires_grad_(True)
        out = node(xs, 16)
        res.append((out.detach(), torch.autograd.grad(out, xs, co)[0]))
    _agree(res[0][0], res[1][0], 1e-5, "out")
    _agree(res[0][1], res[1][1], 1e-4, "dx")


def test_bf16_xlarge_step_launches_the_bf16_kernels(dev):
    """One sparse xlarge step with compute_dtype bf16: the body and
    dot-product kernels launch in bf16, the table update in f32; the
    parameters and accumulators stay f32 and match the plain step's."""
    import copy

    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model_k, batch = _fixed_case(dev, 2048)
    model_p = copy.deepcopy(model_k)
    losses = []
    for model, impl in ((model_k, "auto"), (model_p, "plain")):
        step = make_sparse_embedding_train_step(lambda s: 0.05, impl=impl,
                                                compute_dtype=torch.bfloat16)
        before = _launches()
        state, m = step(init_sparse_train_state(model), *batch)
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        want = ({**{k + "_bf16": 1 for k in XLARGE_STEP}, "table_update": 1, "segment_sum": 1,
                 "clip_scale": 1, "adagrad": 1} if impl == "auto" else {})
        assert _launched(before) == want
        assert m["logits"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model_k.parameters())
    # One bf16 step from the same weights: the two paths round the same f32
    # values, so the loss agrees to a bf16 ulp of the logits' effect.
    assert abs(losses[0] - losses[1]) <= 1e-2 * abs(losses[1])


@pytest.mark.parametrize("train", [False, True])
def test_dot_flops_of_the_kernel_path_equals_the_plain_path(dev, train):
    """profiling.dot_flops of the xlarge forward (and of a forward and
    backward) at batch 512: the kernels report their plain versions' counts,
    so both paths count the same, and the kernel path did launch."""
    from nasrec_tpu_torch import profiling
    from nasrec_tpu_torch.train.metrics import bce_with_logits

    model, (dense, cat, y) = _fixed_case(dev, 512)

    def call(impl):
        if not train:
            with torch.no_grad():
                return model(dense, cat, impl=impl)
        bce_with_logits(model(dense, cat, impl=impl), y).backward()

    before = _launches()
    kernel = profiling.dot_flops(call, "kernel")
    launched = _launched(before)
    assert launched.get("dot_fwd_n40") == 1 and launched.get("body_fwd_s64" if not train
                                                             else "body_bwd_s64") == 1
    assert kernel == profiling.dot_flops(call, "plain") > 0


def test_device_checks_pass(dev, capsys):
    from nasrec_tpu_torch.tools import body_device_check, sweep_device_check

    body_device_check.main()
    sweep_device_check.main()
    out = capsys.readouterr().out
    assert "BODY_DEVICE_CHECK_OK" in out and "SWEEP_DEVICE_CHECK_OK" in out


def _max_diff(model_a, model_b, skip=()):
    sd_a, sd_b = model_a.state_dict(), model_b.state_dict()
    return max((sd_a[k] - sd_b[k]).abs().max().item() for k in sd_a if k not in skip)


def test_host_offload_step_on_the_card_matches_the_on_device_step(dev):
    """Three xlarge steps at batch 2048 with the table in host RAM against the
    sparse step with the table on the card, from the same weights: the body
    and dot-product kernels launch each step, the table update never; loss,
    dense parameters, table and accumulator within 1e-4."""
    import copy

    import numpy as np

    from nasrec_tpu_torch.models.embedding import table_offsets
    from nasrec_tpu_torch.parallel.host_embedding import (
        HostEmbedding,
        detach_table,
        make_host_offload_train_step,
    )
    from nasrec_tpu_torch.train.loop import init_train_state
    from nasrec_tpu_torch.train.optim import make_optimizer
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
        table_accumulator,
    )

    model_d, batch = _fixed_case(dev, 2048)
    model_o = copy.deepcopy(model_d)
    state_d = init_sparse_train_state(model_d)
    step_d = make_sparse_embedding_train_step(lambda s: 0.05)
    host = HostEmbedding(detach_table(model_o), table_offsets((1000,) * 26))
    opt = make_optimizer("adagrad")
    state_o = init_train_state(model_o, opt)
    step_o = make_host_offload_train_step(opt, lambda s: 0.05, host)
    before = _launches()
    for _ in range(3):
        state_o, m_o = step_o(state_o, *batch)
    torch.cuda.synchronize()
    assert _launched(before) == {**_times(XLARGE_STEP, 3), "adagrad": 3}
    for _ in range(3):
        state_d, m_d = step_d(state_d, *batch)
    assert abs(float(m_o["loss"]) - float(m_d["loss"])) <= 1e-4
    assert _max_diff(model_o, model_d, skip=("embedding.table",)) <= 1e-4
    assert np.abs(host.table - model_d.embedding.table.cpu().numpy()).max() <= 1e-4
    assert np.abs(host.acc - table_accumulator(state_d.opt_state).cpu().numpy()).max() <= 1e-4


def test_sparse_mesh_step_over_nccl_at_world_size_one(dev):
    """The sparse mesh step over an NCCL group of one rank gives the
    one-device step's bits, with the same launches."""
    import copy
    import socket

    from nasrec_tpu_torch.parallel import distributed
    from nasrec_tpu_torch.parallel.mesh import make_mesh
    from nasrec_tpu_torch.parallel.sparse import make_parallel_sparse_train_step
    from nasrec_tpu_torch.parallel.train import shard_train_state
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model_1, batch = _fixed_case(dev, 2048)
    model_m = copy.deepcopy(model_1)
    state_1 = init_sparse_train_state(model_1)
    step_1 = make_sparse_embedding_train_step(lambda s: 0.05)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.start(f"tcp://127.0.0.1:{port}", 1, 0, "cuda")
    try:
        mesh = make_mesh(model=1)
        state_m = shard_train_state(init_sparse_train_state(model_m), mesh)
        step_m = make_parallel_sparse_train_step(lambda s: 0.05, mesh)
        before = _launches()
        for _ in range(2):
            state_m, m_m = step_m(state_m, *batch)
        torch.cuda.synchronize()
        launched = _launched(before)
        assert torch.distributed.get_backend() == "nccl"
    finally:
        distributed.shutdown()
    assert launched == _times(XLARGE_SPARSE_STEP, 2)
    for _ in range(2):
        state_1, m_1 = step_1(state_1, *batch)
    assert float(m_m["loss"]) == float(m_1["loss"])
    assert _max_diff(model_m, model_1) == 0.0


# The 128-wide instances (DLRM-DCNv2's rows).  The table update is held to its
# plain version bit for bit, as at 16.  The segment-sum sums each run in a
# fixed order whose partial sums carry across tiles (and, for a bag step's
# one column of all lookups, across tens of thousands of them), so a run's
# sum is held to float64: within 2^-20 of the run's sum of |g| for runs of up
# to 16 lookups, growing as the square root of the run's length beyond
# (rounding errors of a sum of n terms of either sign grow as sqrt(n)).


def _runs_float64(rows_sorted, g_sorted):
    """Each run's float64 sum, sum of |g| and length, runs in sorted order."""
    start = torch.ones_like(rows_sorted, dtype=torch.bool)
    start[1:] = rows_sorted[1:] != rows_sorted[:-1]
    run = start.cumsum(0) - 1
    n = int(run[-1]) + 1
    g64 = g_sorted.double()
    sums = torch.zeros(n, g64.shape[1], dtype=torch.float64, device=g64.device)
    sums.index_add_(0, run, g64)
    abs_sums = torch.zeros_like(sums).index_add_(0, run, g64.abs())
    lengths = torch.zeros(n, dtype=torch.float64, device=g64.device).index_add_(
        0, run, torch.ones_like(run, dtype=torch.float64))
    return sums, abs_sums, lengths


def _check_seg128(seg, is_end, sums, abs_sums, lengths):
    off = seg[~is_end]
    assert bool((off == 0).all()) and not bool(torch.signbit(off).any())
    err = (seg[is_end].double() - sums).abs()
    tol = 2.0 ** -20 * abs_sums * torch.clamp(lengths / 16, min=1.0).sqrt()[:, None]
    assert bool((err <= tol).all()), float((err / tol.clamp(min=1e-30)).max())


def _bag_case(dev, case):
    """(idx [P] int32 fused rows, bag_of [P] int64, g [bags, 128]) of a bag case."""
    import numpy as np

    from nasrec_tpu_torch.configs.dcnv2 import DCNV2_CRITEO1TB, row_share
    from nasrec_tpu_torch.models.embedding import EmbeddingStem, table_offsets

    if case == "dcnv2":         # the cell's step: batch 16384, 3,506,176 lookups
        cfg = row_share(DCNV2_CRITEO1TB, 4)
        b, vocab, bags = 16384, cfg.vocab_sizes, cfg.bag_sizes
    elif case == "one_row":     # one run of 21,000 lookups across 329 tiles
        b, vocab, bags = 3000, (1,), (7,)
    elif case == "small":
        b, vocab, bags = 37, (5, 1, 40, 2), (1, 3, 7, 2)
    elif case == "b1":
        b, vocab, bags = 1, (9, 4000), (3, 100)
    rng = np.random.RandomState(len(case))
    stem = EmbeddingStem(vocab, 128, torch.Generator(), device="meta", bag_sizes=bags)
    cols = np.repeat(np.asarray(vocab, np.int64), bags)
    ids = (rng.random_sample((b, cols.size)) * cols).astype(np.int64)
    idx = torch.as_tensor((ids + np.repeat(table_offsets(vocab), bags)).astype(np.int32),
                          device=dev).reshape(-1)
    bag_of = stem.bag_index(b, dev)
    g = torch.as_tensor(rng.randn(b * len(bags), 128).astype(np.float32), device=dev)
    return idx, bag_of, g


@pytest.mark.parametrize("case", ["dcnv2", "one_row", "small", "b1"])
def test_segment_sum128_bag_kernel_matches_plain_and_float64(dev, case):
    """The bag form at width 128: rows and is_end equal the plain version's;
    seg exact +0.0 off the run ends and at them within the bound above of the
    float64 sums, and within that bound plus the plain version's own (its
    atomics) of the plain version's; one launch a call; two launches give
    the same bits."""
    idx, bag_of, g = _bag_case(dev, case)
    before = segment_sum.LAUNCHES["segment_sum128"]
    rows, seg, is_end = segment_sum.segment_sum_bags(idx, bag_of, g)
    again = segment_sum.segment_sum_bags(idx, bag_of, g)
    p_rows, p_seg, p_end = segment_sum.segment_sum_bags(idx, bag_of, g, impl="plain")
    torch.cuda.synchronize()
    assert segment_sum.LAUNCHES["segment_sum128"] == before + 2
    assert torch.equal(rows, p_rows) and torch.equal(is_end, p_end)
    assert all(torch.equal(a, w) for a, w in zip((rows, seg, is_end), again))
    order = torch.sort(idx.long(), stable=True).indices
    sums, abs_sums, lengths = _runs_float64(rows.long(), g[bag_of[order]])
    _check_seg128(seg, is_end, sums, abs_sums, lengths)
    _check_seg128(p_seg, p_end, sums, abs_sums, lengths)


@pytest.mark.parametrize("b,vocab", [(1001, (300, 7, 1, 5000, 2)), (64, (3, 70)), (1, (5,))])
def test_segment_sum128_slotwise_kernel_matches_float64(dev, b, vocab):
    """The one-hot form [B, C] at width 128 (runs across the 64-position
    tiles of a column): as above."""
    import numpy as np

    from nasrec_tpu_torch.models.embedding import table_offsets

    rng = np.random.RandomState(b)
    idx = np.stack([rng.randint(0, v, size=b) for v in vocab], 1) + table_offsets(vocab)
    idx2d = torch.as_tensor(idx.astype(np.int32), device=dev)
    g = torch.as_tensor(rng.randn(idx.size, 128).astype(np.float32), device=dev)
    rows, seg, is_end = segment_sum.segment_sum(idx2d, g)
    p_rows, _, p_end = segment_sum.segment_sum(idx2d, g, impl="plain")
    assert torch.equal(rows, p_rows) and torch.equal(is_end, p_end)
    rows_cb, order = torch.sort(idx2d.t().long(), dim=1, stable=True)
    g_cb = torch.take_along_dim(g.reshape(b, len(vocab), 128).transpose(0, 1),
                                order[:, :, None], dim=1)
    # Runs never cross columns: each column's rows lie above the last's.
    _check_seg128(seg, is_end, *_runs_float64(rows_cb.reshape(-1), g_cb.reshape(-1, 128)))


@pytest.mark.parametrize("vocab,positions,hot_row,sentinels",
                         [(100, 0, None, 0), (1000, 777, None, 5), (500, 4096, 7, 3),
                          (3000, 1001, None, 0)])
def test_table_update128_kernel_matches_plain(dev, vocab, positions, hot_row, sentinels):
    """At width 128 (one warp a position) the update equals the plain
    version bit for bit, and row_offset halves equal the whole update; the
    rows it counts as written are the plain version's, halves included."""
    gen = torch.Generator(device=dev).manual_seed(vocab + positions)
    idx = torch.randint(0, vocab, (positions,), device=dev, generator=gen, dtype=torch.int32)
    if hot_row is not None:
        idx[::2] = hot_row
    g = torch.randn(max(positions, 1), 128, device=dev, generator=gen)
    bag_of = torch.arange(positions, device=dev)
    if positions:
        rows, seg, _ = segment_sum.segment_sum_bags(idx, bag_of, g)
    else:
        rows, seg = idx, g[:0]
    if sentinels:
        rows = torch.cat([rows, torch.full((sentinels,), vocab + 3, device=dev,
                                           dtype=rows.dtype)])
        seg = torch.cat([seg, torch.ones(sentinels, 128, device=dev)])
    table = torch.randn(vocab, 128, device=dev, generator=gen)
    acc = torch.rand(vocab, 128, device=dev, generator=gen)
    if positions:
        seg[rows == rows[0]] = 0.0      # a row with a zero sum: not written
    before = table_update.LAUNCHES["table_update128"]
    written = torch.zeros(4, dtype=torch.int64, device=dev)
    tk, ak = table.clone(), acc.clone()
    table_update.table_update(tk, ak, rows, seg, 0.05, 1e-8, written=written[0:1])
    tp, ap = table.clone(), acc.clone()
    table_update.table_update(tp, ap, rows, seg, 0.05, 1e-8, impl="plain", written=written[1:2])
    half = vocab // 2
    lo_t, lo_a, hi_t, hi_a = (x.clone() for x in (table[:half], acc[:half], table[half:],
                                                  acc[half:]))
    table_update.table_update(lo_t, lo_a, rows, seg, 0.05, 1e-8, row_offset=0,
                              written=written[2:3])
    table_update.table_update(hi_t, hi_a, rows, seg, 0.05, 1e-8, row_offset=half,
                              written=written[3:4])
    torch.cuda.synchronize()
    assert table_update.LAUNCHES["table_update128"] == before + 3
    assert torch.equal(tk, tp) and torch.equal(ak, ap)
    assert torch.equal(torch.cat([lo_t, hi_t]), tk) and torch.equal(torch.cat([lo_a, hi_a]), ak)
    n = written.tolist()
    assert n[0] == n[1] == n[2] + n[3] == int(((tk != table).any(dim=1)).sum())


def test_wide_kernels_refuse_what_they_do_not_take(dev):
    idx, bag_of, g = _bag_case(dev, "small")
    before = (dict(segment_sum.LAUNCHES), dict(table_update.LAUNCHES))
    for bad in ((idx.long(), bag_of, g), (idx, bag_of.int(), g), (idx, bag_of[:-1], g),
                (idx, bag_of, g[:, :64].contiguous()), (idx, bag_of, g.double()),
                (idx.cpu(), bag_of.cpu(), g.cpu())):
        with pytest.raises(ValueError):
            segment_sum.segment_sum_bags_kernel(*bad)
    table, acc = torch.zeros(10, 64, device=dev), torch.zeros(10, 64, device=dev)
    with pytest.raises(ValueError):
        table_update.table_update_kernel(table, acc, idx[:3], torch.ones(3, 64, device=dev), 0.1)
    table, acc = torch.zeros(10, 16, device=dev), torch.zeros(10, 16, device=dev)
    for written in (torch.zeros(1, dtype=torch.int64, device=dev),     # no count at 16
                    torch.zeros(1, dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError):
            table_update.table_update_kernel(table, acc, idx[:3], torch.ones(3, 16, device=dev),
                                             0.1, written=written)
    assert (dict(segment_sum.LAUNCHES), dict(table_update.LAUNCHES)) == before


def test_dcnv2_step_kernels_match_plain(dev):
    """Three DLRM-DCNv2 sparse steps at a small size (128-wide rows, bags of
    1 to 7): one 128-wide segment-sum and table update a step through the
    kernels and none through the plain versions; losses, parameters and
    accumulators within 1e-5 of the plain step's (the plain segment-sum's
    atomics sum a row's lookups in another order).  Adagrad's eps is 1e-2:
    at the preset's 1e-8 an element whose gradient cancels to within
    rounding of zero moves by up to lr on either route."""
    import numpy as np

    from nasrec_tpu_torch.models.dcn import DCNv2Config, dcnv2_init
    from nasrec_tpu_torch.train.optim import make_optimizer, slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    cfg = DCNv2Config(vocab_sizes=(500, 40, 3, 1000), bag_sizes=(3, 1, 2, 7),
                      dense_arch=(64, 128), cross_rank=32, over_arch=(64,))
    rng = np.random.RandomState(0)
    cols = np.repeat(np.asarray(cfg.vocab_sizes), cfg.bag_sizes)
    batches = [tuple(torch.as_tensor(a, device=dev) for a in (
        rng.randn(512, 13).astype(np.float32),
        (rng.random_sample((512, cols.size)) * cols).astype(np.int32),
        rng.randint(0, 2, size=(512, 1)).astype(np.float32))) for _ in range(3)]
    out = []
    for impl in ("auto", "plain"):
        model = dcnv2_init(cfg, 0, dev)
        opt = make_optimizer("adagrad", 1e-2)
        state = init_sparse_train_state(model, opt)
        step = make_sparse_embedding_train_step(lambda s: 0.005, optimizer=opt, grad_clip=None,
                                                adagrad_eps=1e-2, impl=impl,
                                                bag_sizes=cfg.bag_sizes)
        before = _launches()
        losses = [float(step(state, *b)[1]["loss"]) for b in batches]
        want = ({"segment_sum128": 3, "table_update128": 3, "adagrad": 3} if impl == "auto"
                else {})
        assert _launched(before) == want
        out.append((model, slot_dicts(state.opt_state)[0], losses))
    (mk, ak, lk), (mp, ap, lp) = out
    assert max(abs(a - b) for a, b in zip(lk, lp)) <= 1e-5 * max(lp)
    sd_k, sd_p = mk.state_dict(), mp.state_dict()
    for name in sd_k:
        assert (sd_k[name] - sd_p[name]).abs().max().item() <= 1e-5, name
        assert (ak[name] - ap[name]).abs().max().item() <= 1e-5 * max(1.0, ap[name].abs().max().item()), name


# The dense parameters' clip and Adagrad as one list (csrc/dense_adagrad.cu):
# given the same scale, parameters and accumulators bit-equal to the plain
# version; the scale, whose squares are summed in another order, within 2
# ulps of the plain version's; two launches give the same bits.

def _dense_lists(dev, sizes, seed, grad_scale, zero_grads=False, misaligned=False):
    import numpy as np

    rng = np.random.RandomState(seed)

    def put(a):
        # A view one float into a buffer lies on no 16-byte boundary.
        if not misaligned:
            return torch.as_tensor(a, device=dev)
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
        buf[1:] = torch.as_tensor(a, device=dev)
        return buf[1:]

    params = [put(rng.randn(n).astype(np.float32)) for n in sizes]
    accs = [put(np.abs(rng.randn(n)).astype(np.float32)) for n in sizes]
    grads = [put((np.zeros(n) if zero_grads else rng.randn(n) * grad_scale).astype(np.float32))
             for n in sizes]
    return params, accs, grads


DENSE_CASES = {
    # case: (sizes, grad scale, eps, clip, extra rows, zero grads, misaligned)
    "1_13_1201920": ([1, 13, 1201920], 0.1, 1e-2, 5.0, 0, False, False),
    "300_tensors": (None, 1.0, 1e-2, 5.0, 0, False, False),
    "zero_grads": ([1, 13, 4099, 1201920], 1.0, 1e-8, 5.0, 0, True, False),
    "eps_1e-8": ([1, 13, 1201920], 1e-4, 1e-8, 5.0, 0, False, False),
    "misaligned": ([1, 5, 1201, 16387, 70001], 1.0, 1e-2, 5.0, 0, False, True),
    "no_clip": ([1, 13, 1201920], 1.0, 1e-8, None, 0, False, False),
    "xlarge_seg": ([1, 13, 1201920], 1e-3, 1e-2, 5.0, 32768 * 26, False, False),
    # The lists of an xlarge sparse step: its 86 dense tensors, the table's
    # summed gradient at batch 32768 in the norm.
    "xlarge_step": ("xlarge", 1e-3, 1e-2, 5.0, 32768 * 26, False, False),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_adagrad_kernel_matches_plain(dev, case):
    import numpy as np

    sizes, grad_scale, eps, clip, extra_rows, zero, misaligned = DENSE_CASES[case]
    if sizes is None:        # more tensors than one launch's table holds, some empty
        sizes = list(np.random.RandomState(3).randint(0, 5000, size=300))
        sizes[7] = 0
    elif sizes == "xlarge":
        sizes = [p.numel() for n, p in _fixed_case(dev, 1)[0].named_parameters()
                 if n != "embedding.table"]
        assert len(sizes) == 86
    params, accs, grads = _dense_lists(dev, sizes, 0, grad_scale, zero, misaligned)
    extra = (torch.randn(extra_rows, 16, device=dev, generator=torch.Generator(dev).manual_seed(1))
             if extra_rows else None)
    runs = []
    for _ in range(2):
        before = _launches()
        scale = None if clip is None else dense_adagrad.clip_scale(grads, clip, extra)
        p, a = [x.clone() for x in params], [x.clone() for x in accs]
        dense_adagrad.adagrad_(p, a, grads, 0.05, eps, scale)
        torch.cuda.synchronize()
        want = {"adagrad": 1} if clip is None else {"adagrad": 1, "clip_scale": 1}
        assert _launched(before) == want
        runs.append((scale, p, a))
    (scale, p, a), (scale2, p2, a2) = runs
    for x, y in zip(p + a + [scale] * (clip is not None), p2 + a2 + [scale2] * (clip is not None)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))      # two runs, same bits
    if clip is not None:
        want = dense_adagrad.clip_scale(grads, clip, extra, impl="plain")
        ulps = abs(int(scale.view(torch.int32)) - int(want.view(torch.int32)))
        assert ulps <= 2, (float(scale), float(want))
        if zero:
            assert float(scale) == 1.0
    pp, ap = [x.clone() for x in params], [x.clone() for x in accs]
    dense_adagrad.adagrad_(pp, ap, grads, 0.05, eps, scale, impl="plain")
    for i, (x, y) in enumerate(zip(p + a, pp + ap)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), i
    if zero:
        assert all(torch.equal(x, y) for x, y in zip(p, params))


def test_dense_adagrad_kernel_refuses_what_it_does_not_take(dev):
    p, a, g = (torch.zeros(8, device=dev) for _ in range(3))
    with pytest.raises(ValueError, match="contiguous float32"):
        dense_adagrad.adagrad_([p], [a], [g.double()], 0.1, 1e-2)
    with pytest.raises(ValueError, match="contiguous float32"):
        dense_adagrad.adagrad_([p.view(4, 2).t()], [a.view(4, 2).t()], [g.view(4, 2).t()], 0.1, 1e-2)
    with pytest.raises(ValueError, match="sizes"):
        dense_adagrad.adagrad_([p], [a], [torch.zeros(9, device=dev)], 0.1, 1e-2)
    with pytest.raises(ValueError, match="contiguous float32"):
        dense_adagrad.clip_scale([g, g.cpu()], 5.0)


def _leaf_gap(prog, ref):
    """The benchmark's leaf gap (benchmark/lib/compare.py): the worst leaf's
    |prog - ref| over the larger of its ref and the median leaf's, over the
    leaves with a ref of at least a thousandth of the median."""
    import statistics

    med = statistics.median(v for v in ref.values() if v > 0)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in ref
               if ref[n] > 0 and ref[n] >= 1e-3 * med)


def test_sparse_step_dense_kernel_within_the_cell_limits(dev):
    """Three xlarge sparse steps at batch 32768 through the kernels against
    the plain versions, from the same weights and batches: the first loss,
    each leaf's first gradient (from its Adagrad accumulator) and each leaf's
    change over the three steps within xlarge.uniform's limits (2e-6, 1e-4,
    2e-4); the dense update launches once a step, the clip once."""
    import copy

    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model, batch = _fixed_case(dev, 32768, vocab=100_000)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for impl in ("auto", "plain"):
        m = copy.deepcopy(model)
        state = init_sparse_train_state(m)
        step = make_sparse_embedding_train_step(lambda s: 0.16, impl=impl)
        before = _launches()
        loss = float(step(state, *batch)[1]["loss"])
        grad = {n: a.sum().sqrt().item() for n, a in state.opt_state.items()}
        for _ in range(2):
            step(state, *batch)
        assert _launched(before) == (_times(XLARGE_SPARSE_STEP, 3) if impl == "auto" else {})
        change = {n: (v - start[n]).norm().item() for n, v in m.state_dict().items()}
        out[impl] = (loss, grad, change)
    (lk, gk, ck), (lp, gp, cp) = out["auto"], out["plain"]
    assert abs(lk - lp) / abs(lp) <= 2e-6
    assert _leaf_gap(gk, gp) <= 1e-4
    assert _leaf_gap(ck, cp) <= 2e-4


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_sparse_step_clips_through_the_list_kernel_for_sgd_and_adam(dev, optimizer):
    """With SGD or Adam the sparse step's clip is the list kernel's (one
    launch a step) and the update the optimizer's loop (no list update); its
    loss and parameters match the plain step's."""
    import copy

    from nasrec_tpu_torch.train.optim import make_optimizer
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model_k, batch = _fixed_case(dev, 1024)
    model_p = copy.deepcopy(model_k)
    losses = []
    for model, impl in ((model_k, "auto"), (model_p, "plain")):
        opt = make_optimizer(optimizer)
        step = make_sparse_embedding_train_step(lambda s: 1e-3, optimizer=opt, impl=impl)
        before = _launches()
        _, metrics = step(init_sparse_train_state(model, opt), *batch)
        losses.append(float(metrics["loss"]))
        want = {k: v for k, v in XLARGE_SPARSE_STEP.items() if k != "adagrad"}
        assert _launched(before) == (want if impl == "auto" else {})
    assert abs(losses[0] - losses[1]) <= 1e-4
    sd_k, sd_p = model_k.state_dict(), model_p.state_dict()
    tol = 1e-4 + (2e-3 if optimizer == "adam" else 0.0)
    for name in sd_k:
        assert (sd_k[name] - sd_p[name]).abs().max().item() <= tol, name


def test_xlarge_step_counts_86_fused_tensors(dev):
    """Under a profiler, one xlarge step's `train.dense_update` counts the 86
    dense tensors the kernel updated."""
    from torch.profiler import ProfilerActivity, profile

    from nasrec_tpu_torch import tracing
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model, batch = _fixed_case(dev, 1024)
    state = init_sparse_train_state(model)
    step = make_sparse_embedding_train_step(lambda s: 0.16)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            step(state, *batch)
            torch.cuda.synchronize()
        (span,) = [s for s in tracing.spans() if s.name == "train.dense_update"]
        assert span.counts == {"train.dense_tensors_fused": 86}
    finally:
        tracing.clear()
