"""The search's candidate group as one program, on the CPU at a small size
(2 blocks, K = 2 or 3, vocab <= 60, a few steps).

  - each kernel's K-candidate plain form against a loop of its unbatched
    plain version: the transformer body with stacked parameters and with
    one shared set, forward and backward; the dot-product and the attention
    core folded to batch K B; the table update over K stacked tables;
  - each kernel's vmap rule (ops/kernels/candidates.py), with the launch
    functions swapped for plain stand-ins that count a launch as the
    kernels do: one launch for the group, forward and backward, results
    equal to the loop;
  - the group step and the eval forward of every mode through those rules:
    one launch of each kernel a node, equal to the plain route, no vmap
    fallback (torch.func's per-sample loop for an op without a batching
    rule raises here), and `profiling.dot_flops` of a group step the same
    on both routes;
  - the batched whole-net and LayerNorm-calibrate evaluators of the xlarge
    space (transformer and dot-product nodes) against the JAX package's
    batched evaluator on transplanted weights, and the final-only group
    against K = 1 runs.

The CUDA kernels themselves run on the card only (tests/test_torch_cuda.py,
tests/test_torch_cuda_paths.py).

Tolerance (f32): K-candidate forms and stand-in routes against the loop or
the plain route 1e-5 (abs, of values of order one; the K-candidate body's
parameter gradients 1e-5 relative to their largest magnitude); the
evaluators against JAX as tests/test_torch_search_eval.py holds them
(test_loss rel 2e-4, AUROC and accuracy abs 2e-3); final-only K = 3 against
K = 1 test_loss rel 1e-6, AUROC and accuracy abs 1e-4.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from nasrec_tpu.search import make_candidate_evaluator as jax_make_evaluator

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.choices import ChoiceMasks, choice_to_masks
from nasrec_tpu_torch.models.transplant import from_jax_params
from nasrec_tpu_torch.ops.kernels import attention, build, dotprod, segment_sum, table_update
from nasrec_tpu_torch.ops.kernels import transformer_body as tb
from nasrec_tpu_torch.search import make_candidate_evaluator
from nasrec_tpu_torch.search.worker import BatchedWholeGroup, FinalOnlyGroup

from test_torch_search_eval import _assert_results, _setup, _streams

torch.set_num_threads(2)

TOL = 1e-5


def _params(k, seed):
    g = torch.Generator().manual_seed(seed)
    lead = (k,) if k else ()
    out = []
    for name, shape in zip(tb.PARAM_NAMES, tb.PARAM_SHAPES):
        p = 0.3 * torch.randn(lead + shape, generator=g)
        out.append(p + 0.17 if name in ("attn_ln_w", "fc_ln_w") else p)
    return out


def _unflatten(flat):
    lead = tuple(flat.shape[:-1])
    return [g.reshape(lead + s) for g, s in zip(flat.split(tb.PARAM_SIZES, dim=-1),
                                               tb.PARAM_SHAPES)]


# Plain stand-ins for the launch functions, with the kernels' contract and
# launch keys; what they compute is hidden from FlopCounterMode, as a ctypes
# launch is, and they report the kernels' FLOPs.

def _body_fwd(x, flat, save):
    k = flat.shape[0] if flat.dim() == 2 else 1
    b, s = x.shape[0], x.shape[1]
    with _disable_current_modes(), torch.no_grad():
        params = _unflatten(flat if flat.dim() == 2 else flat[None])
        xk = x.float().reshape(k, b // k, s, 16)
        out = torch.func.vmap(tb.transformer_body_plain)(xk, params).reshape(b, s, 16)
        out = out.to(x.dtype)
        qkv = torch.func.vmap(F.linear)(xk, params[0], params[1]).reshape(b, s, 48)
        o, stats = attention.tiny_head_attention_plain(qkv), attention.softmax_lse2(qkv)
    key = (f"_k{k}" if flat.dim() == 2 else "") + attention.dtype_suffix(x.dtype)
    tb.LAUNCHES[(f"fwd_train_s{s}" if save else f"fwd_s{s}") + key] += 1
    profiling.report_matmul_flops(tb.matmul_flops(b, s))
    return out.contiguous(), (o if save else None), (stats if save else None)


def _body_bwd(x, dout, o, stats, flat):
    k = flat.shape[0] if flat.dim() == 2 else 1
    b, s = x.shape[0], x.shape[1]
    with _disable_current_modes(), torch.enable_grad():
        xg = x.detach().float().requires_grad_(True)
        fg = flat.detach().requires_grad_(True)
        params = _unflatten(fg if flat.dim() == 2 else fg[None])
        out = torch.func.vmap(tb.transformer_body_plain)(xg.reshape(k, b // k, s, 16), params)
        dx, dflat = torch.autograd.grad(out.reshape(b, s, 16), [xg, fg], dout.float())
    dx = dx.to(x.dtype)
    tb.LAUNCHES[f"bwd_s{s}" + (f"_k{k}" if flat.dim() == 2 else "")
                + attention.dtype_suffix(x.dtype)] += 1
    profiling.report_matmul_flops(2 * tb.matmul_flops(b, s))
    return dx, dflat


def _vjp_standin(plain, module, key, flops):
    """(fwd, bwd) stand-ins of a weightless kernel pair from its plain version."""
    def fwd(*args):
        with _disable_current_modes(), torch.no_grad():
            out = plain(*args)
        module.LAUNCHES[f"fwd_{key(*args)}{attention.dtype_suffix(args[0].dtype)}"] += 1
        profiling.report_matmul_flops(flops(*args))
        return out

    def bwd(*args):
        *ins, dout = args
        with _disable_current_modes(), torch.enable_grad():
            ins_g = [t.detach().requires_grad_(True) for t in ins]
            grads = torch.autograd.grad(plain(*ins_g), ins_g, dout)
        module.LAUNCHES[f"bwd_{key(*ins)}{attention.dtype_suffix(ins[0].dtype)}"] += 1
        profiling.report_matmul_flops(2 * flops(*ins))
        return grads if len(grads) > 1 else grads[0]

    return fwd, bwd


def _segsum_standin(idx2d, g):
    segment_sum.LAUNCHES["segment_sum"] += 1
    return segment_sum.segment_sum_plain(idx2d, g)


def _table_standin(table, acc, rows, seg16, lr, eps=1e-2, row_offset=0, written=None):
    table_update.LAUNCHES["table_update"] += 1
    return table_update.table_update_plain(table, acc, rows, seg16, lr, eps, row_offset,
                                           written)


@pytest.fixture
def kernels(monkeypatch):
    """The wrappers take their kernel route on the CPU, through the stand-ins;
    torch.func's per-sample fallback raises.  Yields the launch counter."""
    monkeypatch.setattr(build, "resolve_impl",
                        lambda impl, x: "plain" if impl == "plain" else "kernel")
    monkeypatch.setattr(tb, "transformer_body_fwd_kernel", _body_fwd)
    monkeypatch.setattr(tb, "transformer_body_bwd_kernel", _body_bwd)
    dfwd, dbwd = _vjp_standin(dotprod.dot_scores_tril_plain, dotprod,
                              lambda x, yt: f"n{yt.shape[2] + 1}",
                              lambda x, yt: dotprod.matmul_flops(x.shape[0], yt.shape[2] + 1))
    monkeypatch.setattr(dotprod, "dot_scores_tril_fwd_kernel", dfwd)
    monkeypatch.setattr(dotprod, "dot_scores_tril_bwd_kernel", dbwd)
    afwd, abwd = _vjp_standin(attention.tiny_head_attention_plain, attention,
                              lambda qkv: f"s{qkv.shape[1]}",
                              lambda qkv: attention.matmul_flops(qkv.shape[0], qkv.shape[1]))
    monkeypatch.setattr(attention, "tiny_head_attention_fwd_kernel", afwd)
    monkeypatch.setattr(attention, "tiny_head_attention_bwd_kernel", abwd)
    monkeypatch.setattr(table_update, "table_update_kernel", _table_standin)
    monkeypatch.setattr(segment_sum, "segment_sum_kernel", _segsum_standin)
    mods = (tb, dotprod, attention, table_update, segment_sum)

    def launches():
        out = {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v for m in mods for k, v in m.LAUNCHES.items()}
        for m in mods:
            m.LAUNCHES.clear()
        return out

    launches()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield launches
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
        launches()      # the stand-ins' counts are not left for later tests


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=tol)


def _rel_close(got, want, tol=TOL):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


def _body_inputs(k, b=5, s=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(k * b, 16, s, generator=g).transpose(1, 2)   # as the slot projection leaves it
    dout = torch.randn(k * b, s, 16, generator=g)
    return x, dout


@pytest.mark.parametrize("shared", [False, True], ids=["stacked", "shared"])
def test_body_k_plain_matches_a_loop(shared):
    k, b = 3, 5
    x, dout = _body_inputs(k, b)
    params = _params(0, 1) if shared else _params(k, 1)
    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    if shared:     # one set for every row: the one-candidate form over K B rows
        out = tb.transformer_body_plain(xg, pg)
    else:
        out = tb.transformer_body_k_plain(xg, pg)
    grads = torch.autograd.grad(out, [xg] + pg, dout)

    xl = x.clone().requires_grad_(True)
    pl = [p.clone().requires_grad_(True) for p in params]
    outs = [tb.transformer_body_plain(xl[i * b:(i + 1) * b], pl if shared else [p[i] for p in pl])
            for i in range(k)]
    want = torch.autograd.grad(torch.cat(outs), [xl] + pl, dout)
    _close(out, torch.cat(outs))
    _close(grads[0], want[0])
    for g, w in zip(grads[1:], want[1:]):
        _rel_close(g, w)


def test_folded_dot_product_and_attention_match_a_loop():
    g = torch.Generator().manual_seed(2)
    k, b, m = 3, 4, 9
    x, yt = torch.randn(k, b, 16, generator=g), torch.randn(k, b, 16, m, generator=g)
    z = dotprod.dot_scores_tril_plain(x.reshape(k * b, 16), yt.reshape(k * b, 16, m))
    _close(z.reshape(k, b, -1), torch.stack([dotprod.dot_scores_tril_plain(x[i], yt[i])
                                              for i in range(k)]))
    qkv = torch.randn(k, b, 6, 48, generator=g)
    o = attention.tiny_head_attention_plain(qkv.reshape(k * b, 6, 48))
    _close(o.reshape(k, b, 6, 16), torch.stack([attention.tiny_head_attention_plain(qkv[i])
                                                 for i in range(k)]))


def test_stacked_table_update_matches_a_loop():
    """K tables and accumulators as one [K V, 16] pair, candidate k's rows
    offset by k V: one update equals K updates of the separate tables."""
    g = torch.Generator().manual_seed(3)
    k, v, n = 3, 40, 30
    table, acc = torch.randn(k * v, 16, generator=g), torch.rand(k * v, 16, generator=g)
    rows = torch.randint(0, v, (k, n), generator=g, dtype=torch.int32)
    seg = torch.randn(k, n, 16, generator=g)
    seg[:, ::4] = 0.0                       # positions that carry no update
    rows = torch.sort(rows, dim=1).values   # any order: the update is per position
    t_one, a_one = table.clone(), acc.clone()
    stacked_rows = (rows + v * torch.arange(k, dtype=torch.int32)[:, None]).reshape(-1)
    table_update.table_update_plain(t_one, a_one, stacked_rows, seg.reshape(-1, 16), 0.05)
    for i in range(k):
        ti, ai = table[i * v:(i + 1) * v].clone(), acc[i * v:(i + 1) * v].clone()
        table_update.table_update_plain(ti, ai, rows[i], seg[i], 0.05)
        assert torch.equal(t_one[i * v:(i + 1) * v], ti)
        assert torch.equal(a_one[i * v:(i + 1) * v], ai)


@pytest.mark.parametrize("shared", [False, True], ids=["stacked", "shared"])
def test_body_vmap_rule_launches_once_for_the_group(kernels, shared):
    k, b = 3, 5
    x, dout = _body_inputs(k, b)
    params = _params(0, 4) if shared else _params(k, 4)
    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    xk = xg.reshape(k, b, *x.shape[1:])
    out = torch.func.vmap(lambda xi, *ps: tb.transformer_body(xi, list(ps)),
                          in_dims=(0,) + ((None if shared else 0),) * 12)(xk, *pg)
    grads = torch.autograd.grad(out.reshape(k * b, -1, 16), [xg] + pg, dout)
    key = "" if shared else f"_k{k}"
    assert kernels() == {f"transformer_body.fwd_train_s7{key}": 1,
                         f"transformer_body.bwd_s7{key}": 1}
    with torch.no_grad():
        torch.func.vmap(lambda xi, *ps: tb.transformer_body(xi, list(ps)),
                        in_dims=(0,) + ((None if shared else 0),) * 12)(xk, *pg)
    assert kernels() == {f"transformer_body.fwd_s7{key}": 1}

    xl = x.clone().requires_grad_(True)
    pl = [p.clone().requires_grad_(True) for p in params]
    outs = [tb.transformer_body_plain(xl[i * b:(i + 1) * b], pl if shared else [p[i] for p in pl])
            for i in range(k)]
    want = torch.autograd.grad(torch.cat(outs), [xl] + pl, dout)
    _close(out, torch.stack(outs))
    _close(grads[0], want[0])
    for g, w in zip(grads[1:], want[1:]):
        _rel_close(g, w)


def test_weightless_vmap_rules_launch_once_for_the_group(kernels):
    g = torch.Generator().manual_seed(5)
    k, b, m, s = 3, 4, 9, 6
    x = torch.randn(k, b, 16, generator=g, requires_grad=True)
    yt = torch.randn(k, b, 16, m, generator=g, requires_grad=True)
    qkv = torch.randn(k, b, s, 48, generator=g, requires_grad=True)
    z = torch.func.vmap(dotprod.dot_scores_tril)(x, yt)
    o = torch.func.vmap(attention.tiny_head_attention)(qkv)
    dz, do = torch.randn(z.shape, generator=g), torch.randn(o.shape, generator=g)
    got = torch.autograd.grad([z, o], [x, yt, qkv], [dz, do])
    assert kernels() == {"dotprod.fwd_n10": 1, "dotprod.bwd_n10": 1,
                         "attention.fwd_s6": 1, "attention.bwd_s6": 1}
    zl = torch.stack([dotprod.dot_scores_tril_plain(x[i], yt[i]) for i in range(k)])
    ol = torch.stack([attention.tiny_head_attention_plain(qkv[i]) for i in range(k)])
    want = torch.autograd.grad([zl, ol], [x, yt, qkv], [dz, do])
    _close(z, zl)
    _close(o, ol)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("laid_out", [False, True], ids=["views", "laid_out"])
@pytest.mark.parametrize("vmapped", [False, True], ids=["direct", "vmap"])
def test_dot_product_kernels_get_aligned_operands(kernels, monkeypatch, vmapped, laid_out):
    """bf16 operands reach the forward and backward launches contiguous and
    16-byte aligned (the bf16 kernels load 16 bytes at a time), called
    directly and under vmap: views off a boundary are copied, operands
    already so laid out pass as they are."""
    seen = []
    fwd, bwd = dotprod.dot_scores_tril_fwd_kernel, dotprod.dot_scores_tril_bwd_kernel

    def laid_out(launch):
        def call(x, yt, *rest):
            seen.append(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, yt)))
            return launch(x, yt, *rest)
        return call

    monkeypatch.setattr(dotprod, "dot_scores_tril_fwd_kernel", laid_out(fwd))
    monkeypatch.setattr(dotprod, "dot_scores_tril_bwd_kernel", laid_out(bwd))
    g = torch.Generator().manual_seed(6)
    k, b, m = 2, 3, 5
    if laid_out:
        xs = torch.randn(k, b, 16, generator=g).bfloat16()
        yts = torch.randn(k, b, 16, m, generator=g).bfloat16()
    else:
        xs = torch.randn(k * b * 16 + 1, generator=g).bfloat16()[1:].reshape(k, b, 16)
        yts = torch.randn(k, b, m, 16, generator=g).bfloat16().transpose(2, 3)
    xs.requires_grad_(True)
    yts.requires_grad_(True)
    call = torch.func.vmap(dotprod.dot_scores_tril) if vmapped else dotprod.dot_scores_tril
    x, yt = (xs, yts) if vmapped else (xs.reshape(k * b, 16), yts.reshape(k * b, 16, m))
    z = call(x, yt)
    dz = torch.randn(z.shape, generator=g).bfloat16()
    got = torch.autograd.grad(z, [xs, yts], dz)
    assert seen == [True, True]
    assert kernels() == {"dotprod.fwd_n6_bf16": 1, "dotprod.bwd_n6_bf16": 1}
    zp = dotprod.dot_scores_tril_plain(x, yt) if not vmapped else torch.stack(
        [dotprod.dot_scores_tril_plain(xs[i], yts[i]) for i in range(k)])
    want = torch.autograd.grad(zp, [xs, yts], dz)
    assert torch.equal(z, zp)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def _small_group(mode, k=3, space="xlarge"):
    jcfg, tcfg, params, model, picks = _setup(space, k=k, seed=7)
    (_, _), (ttr, tte) = _streams(train_bs=32, test_bs=48, n_train=64, n_test=48)
    ev = make_candidate_evaluator(tcfg, model, max_train_steps=2, max_eval_steps=1,
                                  finetune_mode=mode)
    return ev, picks, ttr, tte


def _run(group, ttr, tte, steps=2):
    losses = [group.step(*batch, i) for i, batch in zip(range(steps), ttr())]
    dense, cat, _ = next(iter(tte()))
    return torch.stack(losses), group.logits(dense, cat)


@pytest.mark.parametrize("mode", ["final-only", "whole", "layernorm-calibrate"])
def test_group_runs_each_kernel_once_a_node(kernels, mode):
    """A group step and an eval forward through the kernel route: each
    kernel once a node for the whole group (the segment-sum and the table
    update once a step), no vmap fallback, the plain route's numbers."""
    ev, picks, ttr, tte = _small_group(mode)
    nb, k = ev.supernet.cfg.num_blocks, len(picks)
    group = ev.group(picks)
    assert isinstance(group, FinalOnlyGroup if mode == "final-only" else BatchedWholeGroup)
    dense, cat, y = next(iter(ttr()))
    group.step(dense, cat, y, 0)
    step_launches = kernels()
    group.logits(dense, cat)
    eval_launches = kernels()
    want_eval = {"transformer_body.fwd_s64" + ("" if mode == "final-only" else f"_k{k}"): nb,
                 "dotprod.fwd_n46": nb}
    assert eval_launches == want_eval
    if mode == "final-only":
        assert step_launches == want_eval
    else:
        # The whole net is trained: every body with its candidate's
        # parameters; in layernorm-calibrate the body's two LayerNorms
        # train, so its parameters still differ between candidates after a
        # step; the table is frozen there.
        want = {f"transformer_body.fwd_train_s64_k{k}": nb,
                f"transformer_body.bwd_s64_k{k}": nb,
                "dotprod.fwd_n46": nb, "dotprod.bwd_n46": nb}
        if mode == "whole":
            want["table_update.table_update"] = 1
            want["segment_sum.segment_sum"] = 1
        assert step_launches == want

    got = _run(ev.group(picks), ttr, tte)
    kernels()
    plain = make_candidate_evaluator(ev.supernet.cfg, ev.supernet, max_train_steps=2,
                                     max_eval_steps=1, finetune_mode=mode, impl="plain")
    want = _run(plain.group(picks), ttr, tte)
    assert kernels() == {}
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("mode", ["final-only", "whole"])
def test_group_step_flops_equal_on_both_routes(kernels, mode):
    """profiling.dot_flops of a group step: the products the dispatcher sees
    plus the kernels' reports (each K-candidate launch K times the
    unbatched FLOPs) equal the plain route's count."""
    ev, picks, ttr, tte = _small_group(mode, k=2)
    plain = make_candidate_evaluator(ev.supernet.cfg, ev.supernet, max_train_steps=2,
                                     max_eval_steps=1, finetune_mode=mode, impl="plain")
    dense, cat, y = next(iter(ttr()))
    counts = [profiling.dot_flops(lambda: e.group(picks).step(dense, cat, y, 0))
              for e in (ev, plain)]
    assert counts[0] == counts[1] > 0
    one = profiling.dot_flops(lambda: plain.group(picks[:1]).step(dense, cat, y, 0))
    assert counts[1] > one


@pytest.mark.parametrize("mode", ["whole", "layernorm-calibrate"])
def test_batched_modes_match_jax_batched(mode):
    jcfg, tcfg, params, model, picks = _setup("xlarge", k=3, seed=5)
    (jtr, jte), (ttr, tte) = _streams(n_train=256, n_test=256)
    args = dict(max_train_steps=5, max_eval_steps=2, finetune_mode=mode)
    want = jax_make_evaluator(jcfg, params, batch_candidates=True, **args)(picks, jtr, jte)
    with _no_fallback():
        ev = make_candidate_evaluator(tcfg, model, **args)
        got = ev(picks, ttr, tte)
    assert isinstance(ev.last_group, BatchedWholeGroup)
    _assert_results(got, want, 2e-4, 2e-3)
    # The supernet itself is never changed.
    for name, t in from_jax_params(params, tcfg).items():
        assert torch.equal(model.state_dict()[name], t), name


def test_final_only_group_matches_one_candidate_runs():
    jcfg, tcfg, params, model, picks = _setup("xlarge", k=3, seed=9)
    (_, _), (ttr, tte) = _streams(n_train=256, n_test=256)
    ev = make_candidate_evaluator(tcfg, model, max_train_steps=4, max_eval_steps=2,
                                  eval_batch_chunk=64)
    with _no_fallback():
        got = ev(picks, ttr, tte)
    for i, choice in enumerate(picks):
        one = ev([choice], ttr, tte)[0]
        assert one["test_loss"] == pytest.approx(got[i]["test_loss"], rel=1e-6)
        assert one["test_auroc"] == pytest.approx(got[i]["test_auroc"], abs=1e-4)
        assert one["test_acc"] == pytest.approx(got[i]["test_acc"], abs=1e-4)


def test_vmap_fallback_is_refused_here():
    """The guard the tests above run under: an op without a batching rule
    raises instead of looping over the candidates."""
    with _no_fallback(), pytest.raises(RuntimeError):
        torch.func.vmap(lambda t: torch.ops.aten._test_functorch_fallback(t, t))(
            torch.ones(2, 3))


@contextlib.contextmanager
def _no_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)


def test_masks_map_over_a_stack_of_choices():
    """ChoiceMasks is a pytree node: vmap maps over the stacked choices."""
    _, tcfg, _, _, picks = _setup("autoctr", k=2, seed=3)
    masks = [choice_to_masks(c, tcfg.space, tcfg.num_blocks) for c in picks]
    stacked = ChoiceMasks.stack(masks).to("cpu")
    got = torch.func.vmap(lambda m: m.node_act.sum() + m.dense_dim.sum())(stacked)
    want = [float(m.node_act.sum() + m.dense_dim.sum()) for m in masks]
    assert got.tolist() == want
