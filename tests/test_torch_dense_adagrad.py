"""The dense parameters' global-norm clip and Adagrad as one list
(`nasrec_tpu_torch/ops/kernels/dense_adagrad.py`) on the CPU, where it runs
its plain version, against the clip and `adagrad_update_` written out as the
sparse step ran them before: bit for bit.  The sparse step against the same
step written out from its pieces, for Adagrad, SGD and Adam, with the clip
engaged and without one; a frozen parameter; the step's counter of fused
tensors.  The CUDA kernel runs on the card only (tests/test_torch_cuda.py).
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
from nasrec_tpu_torch.ops.kernels import dense_adagrad as da
from nasrec_tpu_torch.train import optim
from nasrec_tpu_torch.train.loop import TABLE, forward_embedded
from nasrec_tpu_torch.train.metrics import bce_with_logits
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
    rowwise_segment_sum_slotwise,
    sparse_adagrad_table_update,
    table_accumulator,
)

torch.set_num_threads(2)

LR, EPS = 0.05, 1e-2
SIZES = [(1,), (13,), (7, 5), (1201,), (33, 16)]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_same_bits(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(_bits(g), _bits(w)), f"{what} {i}"


def _lists(grad_scale, seed=0):
    rng = np.random.RandomState(seed)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in SIZES]
    accs = [torch.from_numpy(np.abs(rng.randn(*s)).astype(np.float32)) for s in SIZES]
    grads = [torch.from_numpy((rng.randn(*s) * grad_scale).astype(np.float32)) for s in SIZES]
    extra = torch.from_numpy(rng.randn(40, 16).astype(np.float32) * grad_scale)
    return params, accs, grads, extra


@pytest.mark.parametrize("case", ["clip_engaged", "clip_not_engaged", "no_clip", "extra"])
def test_plain_route_is_the_clip_and_adagrad_update_written_out(case):
    """clip_scale then adagrad_ on CPU tensors give the bits of the clip
    (sum of squares stacked and summed, global_norm_scale, g * scale) and
    `adagrad_update_`."""
    max_norm = None if case == "no_clip" else 5.0
    params, accs, grads, extra = _lists(3.0 if case == "clip_engaged" else 0.01)
    extra = extra if case == "extra" else None
    want_p, want_a = [p.clone() for p in params], [a.clone() for a in accs]
    g = grads
    if max_norm is not None:
        sq = torch.stack([torch.sum(torch.square(x)) for x in grads]).sum()
        if extra is not None:
            sq = sq + torch.sum(torch.square(extra))
        want_scale = optim.global_norm_scale(sq, max_norm)
        g = [x * want_scale for x in grads]
    optim.adagrad_update_(want_p, want_a, g, LR, EPS)

    scale = None
    if max_norm is not None:
        scale = da.clip_scale(grads, max_norm, extra)
        assert torch.equal(_bits(scale), _bits(want_scale))
        assert (float(scale) < 1.0) == (case == "clip_engaged")
    da.adagrad_(params, accs, grads, LR, EPS, scale)
    assert not da.LAUNCHES
    _assert_same_bits(params, want_p, "param")
    _assert_same_bits(accs, want_a, "acc")


def test_plain_route_refuses_the_kernel_on_the_cpu():
    params, accs, grads, _ = _lists(1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        da.adagrad_(params, accs, grads, LR, EPS, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        da.clip_scale(grads, 5.0, impl="kernel")
    da.adagrad_([], [], [], LR, EPS)
    assert not da.LAUNCHES


@pytest.mark.parametrize("name", ["adagrad", "sgd", "adam"])
def test_update_with_a_scale_is_the_update_of_scaled_gradients(name):
    """`Optimizer.update_` given the clip's scale leaves every parameter and
    slot with the bits of the update of the gradients times the scale, as
    the steps applied it before the optimizer took it."""
    params, _, grads, _ = _lists(3.0)
    names = [f"p{i}" for i in range(len(params))]
    opt = optim.make_optimizer(name)
    scale = torch.tensor(0.3706, dtype=torch.float32)
    runs = []
    for scaled in (False, True):
        ps = [p.clone() for p in params]
        state = opt.init(zip(names, ps))
        for _ in range(2):
            if scaled:
                opt.update_(state, names, ps, [g * scale for g in grads], LR)
            else:
                opt.update_(state, names, ps, grads, LR, scale)
        slots = [t for d in optim.slot_dicts(state) for t in d.values()]
        runs.append(ps + slots)
    _assert_same_bits(runs[0], runs[1], name)


def _model_and_batch(batch=16, vocab=30):
    plan = build_fixed_plan(get_best_arch("criteo-kaggle", "autoctr"), OPS_CONFIG_LIB["autoctr"],
                            7, 13, 26, [vocab] * 26)
    model = fixed_init(plan, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    data = (torch.from_numpy(rng.randn(batch, 13).astype(np.float32)),
            torch.from_numpy(rng.randint(0, vocab, (batch, 26)).astype(np.int32)),
            torch.from_numpy(rng.randint(0, 2, (batch, 1)).astype(np.float32)))
    return model, data


def _step_written_out(state, optimizer, grad_clip, dense, cat, y, lr, trainable=None):
    """One sparse step as the port ran it before the dense list: gradients,
    segment-sum, the clip scaling each gradient and the table's summed
    gradient, `optimizer.update_`, the table update."""
    model = state.model
    table = model.embedding.table
    named = [(n, p) for n, p in model.named_parameters() if n != TABLE]
    rest = [(n, p) for n, p in named if trainable is None or trainable[n]]
    idx = model.embedding.fused_index(cat)
    with torch.no_grad():
        looked = table.index_select(0, idx.reshape(-1)).reshape(idx.shape[0], -1)
    stem = looked.requires_grad_(True)
    logits = forward_embedded(model, dense, stem, None, "auto", torch.float32, False)
    grads = torch.autograd.grad(bce_with_logits(logits, y) + optim.l2_penalty(named, 0.0),
                                [p for _, p in rest] + [stem], allow_unused=True,
                                materialize_grads=True)
    with torch.no_grad():
        g_rest, d_stem = grads[:len(rest)], grads[len(rest)]
        rows, seg, _ = rowwise_segment_sum_slotwise(idx, d_stem.reshape(-1, table.shape[1]))
        if grad_clip is not None:
            sq = torch.stack([torch.sum(torch.square(g)) for g in g_rest]).sum()
            sq = sq + torch.sum(torch.square(seg))
            scale = optim.global_norm_scale(sq, grad_clip)
            g_rest = [g * scale for g in g_rest]
            seg = seg * scale
        optimizer.update_(state.opt_state, [n for n, _ in rest], [p for _, p in rest],
                          g_rest, lr)
        sparse_adagrad_table_update(table.data, table_accumulator(state.opt_state), rows, seg,
                                    lr, 1e-2)
    state.step += 1


def _state_tensors(state):
    out = dict(state.model.state_dict())
    for i, slots in enumerate(optim.slot_dicts(state.opt_state)):
        out.update({f"slot{i}.{k}": v for k, v in slots.items()})
    return out


@pytest.mark.parametrize("grad_clip", [1e-3, 1e3, None], ids=["clipped", "unclipped", "no_clip"])
@pytest.mark.parametrize("name", ["adagrad", "sgd", "adam"])
def test_sparse_step_is_the_step_written_out(name, grad_clip):
    """Two steps of the sparse step equal the step written out from its
    pieces, every parameter and every optimizer slot bit for bit, for each
    optimizer, with the clip engaged, not engaged and off."""
    model, data = _model_and_batch()
    ref_model = copy.deepcopy(model)
    opt = optim.make_optimizer(name, adagrad_eps=1e-8 if name == "adagrad" else 1e-2)
    state, ref = init_sparse_train_state(model, opt), init_sparse_train_state(ref_model, opt)
    step = make_sparse_embedding_train_step(lambda s: LR, optimizer=opt, grad_clip=grad_clip)
    for _ in range(2):
        step(state, *data)
        _step_written_out(ref, opt, grad_clip, *data, LR)
    got, want = _state_tensors(state), _state_tensors(ref)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def test_frozen_parameter_keeps_value_and_accumulator():
    """A parameter that `trainable` freezes is left out of the clip and the
    update: its value and its accumulator keep their bits; the others move
    as the step written out moves them."""
    model, data = _model_and_batch()
    ref_model = copy.deepcopy(model)
    names = [n for n, _ in model.named_parameters() if n != TABLE]
    frozen = names[len(names) // 2]
    trainable = {n: n != frozen for n in names + [TABLE]}
    opt = optim.make_optimizer("adagrad")
    state, ref = init_sparse_train_state(model, opt), init_sparse_train_state(ref_model, opt)
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    step = make_sparse_embedding_train_step(lambda s: LR, optimizer=opt, trainable=trainable)
    step(state, *data)
    _step_written_out(ref, opt, 5.0, *data, LR, trainable=trainable)
    got, want = _state_tensors(state), _state_tensors(ref)
    for k in (frozen, f"slot0.{frozen}"):
        assert torch.equal(_bits(got[k]), _bits(before[k])), k
    assert not torch.equal(got[names[0]], before[names[0]])
    for k in got:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("name,want", [("adagrad", {"train.dense_tensors_fused": 0}),
                                       ("sgd", None)])
def test_dense_update_counts_no_fused_tensor_on_the_cpu(name, want):
    """Under a profiler, `train.dense_update` counts the tensors the kernel
    updated: none on the CPU's plain route; the SGD route counts nothing."""
    model, data = _model_and_batch()
    opt = optim.make_optimizer(name)
    state = init_sparse_train_state(model, opt)
    step = make_sparse_embedding_train_step(lambda s: LR, optimizer=opt)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            step(state, *data)
        (span,) = [s for s in tracing.spans() if s.name == "train.dense_update"]
        assert span.counts == want
    finally:
        tracing.clear()
