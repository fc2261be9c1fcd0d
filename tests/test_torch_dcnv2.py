"""DLRM-DCNv2 (models/dcn.py) on the CPU at a small size: bags of 1 to 7 ids
over a few dozen rows a slot, 128-wide rows, a narrow dense part.

The port is held to the benchmark's plain reference, imported by path from
`benchmark/reference/dcnv2_ref.py` (the one reference, so that the two cannot
drift), on the weights that file draws from a seed: logits, loss and
gradients, then three sparse steps (losses, the touched rows of the table and
its accumulator, every dense parameter).  Also: the plain bag segment-sum
against float64 index_add_; the plain 128-wide table update against torch's
Adagrad on a dense table; four row shares of a table, pooled and updated
through `row_offset`, against the uncut table; one-hot bags (all 1) take the
one-hot path; the bag step's spans and counter; the FLOP count;
`main_train --net dcnv2`.

Tolerances (f32 on the CPU): the port and the reference compute the same
products in the same order but pool with other ops (embedding_bag against
a gather and a sum), so logits, losses and gradients agree to 1e-5 of their
scale; after three Adagrad steps, whose first moves each element by about lr
times its gradient's sign, parameters and accumulators to 1e-5.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nasrec_tpu_torch import profiling, tracing
from nasrec_tpu_torch.models.dcn import DCNv2Config, dcnv2_init
from nasrec_tpu_torch.ops.kernels.segment_sum import segment_sum_bags
from nasrec_tpu_torch.ops.kernels.table_update import table_update
from nasrec_tpu_torch.train.optim import make_optimizer, slot_dicts
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "dcnv2_ref", ROOT / "benchmark" / "reference" / "dcnv2_ref.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

CFG = {"num_dense": 13, "embedding_dim": 128, "vocab_sizes": [30, 45, 20, 60],
       "published_vocab_sizes": [120, 180, 77, 240], "multi_hot_sizes": [1, 3, 7, 2],
       "dense_arch_layer_sizes": [32, 128], "dcn_num_layers": 3, "dcn_low_rank_dim": 64,
       "over_arch_layer_sizes": [64, 32, 1]}
LR, EPS, B = 0.005, 1e-8, 64


def _port(seed=3):
    mcfg = DCNv2Config(vocab_sizes=tuple(CFG["vocab_sizes"]),
                       bag_sizes=tuple(CFG["multi_hot_sizes"]), num_dense=CFG["num_dense"],
                       emb_dim=CFG["embedding_dim"],
                       dense_arch=tuple(CFG["dense_arch_layer_sizes"]),
                       cross_layers=CFG["dcn_num_layers"], cross_rank=CFG["dcn_low_rank_dim"],
                       over_arch=tuple(CFG["over_arch_layer_sizes"][:-1]),
                       init_rows=tuple(CFG["published_vocab_sizes"]))
    model = dcnv2_init(mcfg, 0)
    model.load_state_dict(ref.make_weights(CFG, seed, "cpu"))
    return mcfg, model


def _batch(i, b=B):
    rng = np.random.RandomState(i)
    cols = np.repeat(np.asarray(CFG["vocab_sizes"]), CFG["multi_hot_sizes"])
    return (torch.as_tensor(rng.randn(b, 13).astype(np.float32)),
            torch.as_tensor((rng.random_sample((b, cols.size)) * cols).astype(np.int32)),
            torch.as_tensor((rng.random_sample((b, 1)) < 0.25).astype(np.float32)))


def _close(a, b, rel):
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= rel * scale, float((a - b).abs().max()) / scale


def test_forward_loss_and_gradients_match_the_reference():
    _, model = _port()
    dense, ids, y = _batch(0)
    idx = model.embedding.fused_index(ids)
    stem = model.embedding.pool(model.embedding.table, idx).requires_grad_(True)
    logits = model.forward_embedded(dense, stem)
    names = [n for n, _ in model.named_parameters() if n != ref.TABLE]
    params = dict(model.named_parameters())
    loss = ref.bce(logits, y)
    grads = torch.autograd.grad(loss, [params[n] for n in names] + [stem])

    w = ref.make_weights(CFG, 3, "cpu")
    p = {n: w[n].requires_grad_(True) for n in names}
    r_idx = ids.long() + ref.column_offsets(CFG, "cpu")[None, :]
    r_stem = ref.pool(w[ref.TABLE], r_idx, CFG).requires_grad_(True)
    r_logits = ref.forward_stem(p, CFG, dense, r_stem)
    r_loss = ref.bce(r_logits, y)
    r_grads = torch.autograd.grad(r_loss, [p[n] for n in names] + [r_stem])
    _close(stem.detach(), r_stem.detach(), 1e-6)
    _close(logits.detach(), r_logits.detach(), 1e-5)
    assert abs(float(loss.detach()) - float(r_loss.detach())) <= 1e-6 * abs(float(r_loss.detach()))
    for n, g, rg in zip(names + ["stem"], grads, r_grads):
        _close(g, rg, 1e-5)


def test_three_sparse_steps_match_the_reference():
    mcfg, model = _port()
    opt = make_optimizer("adagrad", EPS)
    state = init_sparse_train_state(model, opt)
    step = make_sparse_embedding_train_step(lambda s: LR, optimizer=opt, grad_clip=None,
                                            adagrad_eps=EPS, bag_sizes=mcfg.bag_sizes)
    trainer = ref.RefTrainer(CFG, ref.make_weights(CFG, 3, "cpu"), LR, EPS)
    batches = [_batch(i) for i in range(3)]
    for b in batches:
        _, m = step(state, *b)
        r = trainer.step(*b)
        assert abs(float(m["loss"]) - r) <= 1e-5 * abs(r)
    acc = slot_dicts(state.opt_state)[0]
    offsets = ref.column_offsets(CFG, "cpu")[None, :]
    touched = torch.unique(torch.cat([b[1].long() + offsets for b in batches]).reshape(-1))
    untouched = torch.ones(model.embedding.table.shape[0], dtype=torch.bool)
    untouched[touched] = False
    w0 = ref.make_weights(CFG, 3, "cpu")[ref.TABLE]
    table = model.embedding.table.detach()
    assert torch.equal(table[untouched], w0[untouched])              # no row it did not touch moved
    assert bool((acc[ref.TABLE][untouched] == 0).all())
    _close(table[touched], trainer.params[ref.TABLE][touched], 1e-5)
    _close(acc[ref.TABLE][touched], trainer.acc[ref.TABLE][touched], 1e-5)
    for n, p in model.named_parameters():
        if n != ref.TABLE:
            assert float((p.detach() - trainer.params[n]).abs().max()) <= 1e-5, n
            _close(acc[n], trainer.acc[n], 1e-5)


def test_plain_bag_segment_sum_against_float64():
    rng = np.random.RandomState(1)
    b, sizes, vocab = 50, [1, 3, 7, 2], [5, 1, 40, 2]
    cols = np.repeat(np.asarray(vocab), sizes)
    offsets = np.repeat(np.concatenate([[0], np.cumsum(vocab)[:-1]]), sizes)
    idx = torch.as_tensor(((rng.random_sample((b, cols.size)) * cols).astype(np.int64)
                           + offsets).astype(np.int32)).reshape(-1)
    bag_of = torch.repeat_interleave(torch.arange(b * len(sizes)),
                                     torch.as_tensor(sizes).repeat(b))
    g = torch.as_tensor(rng.randn(b * len(sizes), 128).astype(np.float32))
    rows, seg, is_end = segment_sum_bags(idx, bag_of, g)
    want = torch.zeros(sum(vocab), 128, dtype=torch.float64).index_add_(
        0, idx.long(), g.double()[bag_of])
    size = torch.zeros(sum(vocab), 128, dtype=torch.float64).index_add_(
        0, idx.long(), g.double()[bag_of].abs())
    assert torch.equal(rows, torch.sort(idx).values)
    assert torch.equal(rows[is_end], torch.unique(idx))
    assert bool((seg[~is_end] == 0).all())
    # An f32 sum of n terms: within n 2^-24 of the terms' sum of |g|.
    at = rows[is_end].long()
    n = torch.bincount(idx.long(), minlength=sum(vocab))[at].double()[:, None]
    assert bool(((seg[is_end].double() - want[at]).abs() <= n * 2.0 ** -24 * size[at]).all())


def test_plain_128_wide_table_update_is_torch_adagrad():
    rng = np.random.RandomState(2)
    vocab = 40
    table = torch.as_tensor(rng.randn(vocab, 128).astype(np.float32))
    acc = torch.as_tensor(rng.rand(vocab, 128).astype(np.float32))
    idx = torch.as_tensor(rng.randint(0, vocab, size=300).astype(np.int32))
    g = torch.as_tensor(rng.randn(300, 128).astype(np.float32))
    rows, seg, _ = segment_sum_bags(idx, torch.arange(300), g)
    dense = torch.zeros(vocab, 128).index_add_(0, rows.long(), seg)
    p = torch.nn.Parameter(table.clone())
    opt = torch.optim.Adagrad([p], lr=0.05, eps=EPS)
    opt.state[p]["sum"].copy_(acc)
    p.grad = dense
    opt.step()
    # A row whose summed gradient is zero (the last one here) is neither
    # written nor counted.
    zero = int(rows[-1])
    seg[rows == zero] = 0.0
    before = table[zero].clone()
    written = torch.zeros(1, dtype=torch.int64)
    table_update(table, acc, rows, seg, 0.05, EPS, written=written)
    keep = torch.arange(vocab) != zero
    assert torch.allclose(table[keep], p.detach()[keep], rtol=0, atol=1e-6)
    assert torch.allclose(acc[keep], opt.state[p]["sum"][keep], rtol=1e-6, atol=0)
    assert torch.equal(table[zero], before)
    assert int(written) == torch.unique(rows).numel() - 1


def test_row_shares_add_up_to_the_uncut_table():
    """Four row shares of the fused table (the deployment's cut) each pool
    the ids in their own rows; together they give the uncut pooled stem,
    and their updates through row_offset give the uncut update."""
    _, model = _port()
    emb, table = model.embedding, model.embedding.table.detach()
    idx = emb.fused_index(_batch(5)[1])
    rows_total = table.shape[0]
    share = -(-rows_total // 4)
    parts = [emb.pool(table[k * share:(k + 1) * share], idx, row_offset=k * share)
             for k in range(4)]
    _close(sum(parts), emb.pool(table, idx), 1e-6)
    rows, seg, _ = segment_sum_bags(idx.reshape(-1), emb.bag_index(B),
                                    torch.randn(B * 4, 128, generator=torch.Generator().manual_seed(0)))
    whole_t, whole_a = table.clone(), torch.rand(rows_total, 128)
    shares = [(whole_t[k * share:(k + 1) * share].clone(), whole_a[k * share:(k + 1) * share].clone())
              for k in range(4)]
    table_update(whole_t, whole_a, rows, seg, LR, EPS)
    for k, (t, a) in enumerate(shares):
        table_update(t, a, rows, seg, LR, EPS, row_offset=k * share)
    assert torch.equal(torch.cat([t for t, _ in shares]), whole_t)
    assert torch.equal(torch.cat([a for _, a in shares]), whole_a)


def test_one_hot_bags_take_the_one_hot_path(monkeypatch):
    """Bags all of size 1 are the one-hot step: the slotwise segment-sum and
    the gather, the same results as a step built without bags."""
    from nasrec_tpu_torch.train import sparse_embedding

    cfg = DCNv2Config(vocab_sizes=(30, 45, 20), bag_sizes=(1, 1, 1), dense_arch=(32, 128),
                      cross_rank=16, over_arch=(32,))
    calls = []
    monkeypatch.setattr(sparse_embedding, "segment_sum_bags",
                        lambda *a: calls.append(a) or None)
    out = []
    for bags in (None, cfg.bag_sizes):
        model = dcnv2_init(cfg, 0)
        state = init_sparse_train_state(model)
        step = make_sparse_embedding_train_step(lambda s: LR, bag_sizes=bags)
        rng = np.random.RandomState(0)
        batch = (torch.as_tensor(rng.randn(16, 13).astype(np.float32)),
                 torch.as_tensor(rng.randint(0, 20, size=(16, 3)).astype(np.int32)),
                 torch.ones(16, 1))
        step(state, *batch)
        out.append(model.state_dict())
    assert not calls
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])


def test_bags_refuse_a_mesh_of_several_ranks():
    from nasrec_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="one device"):
        make_sparse_embedding_train_step(lambda s: LR, bag_sizes=(1, 3), mesh=Mesh(1, 2))


def test_bag_step_records_its_spans_and_lookups():
    mcfg, model = _port()
    state = init_sparse_train_state(model)
    step = make_sparse_embedding_train_step(lambda s: LR, grad_clip=None,
                                            bag_sizes=mcfg.bag_sizes)
    tracing.clear()
    step(state, *_batch(1))
    assert tracing.device_counts() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, *_batch(0))
    spans = {s.name: s for s in tracing.spans()}
    counts = tracing.device_counts()
    tracing.clear()
    assert spans["train.lookup"].parent is spans["train.forward_backward"]
    assert spans["train.lookup"].counts["train.bag_positions"] == B * 13
    # Every row the batch touches gets a nonzero summed gradient here.
    touched = torch.unique(model.embedding.fused_index(_batch(0)[1])).numel()
    assert counts == {"train.rows_updated": touched}
    assert spans["model.cross"].parent is spans["train.forward_backward"]
    assert {"train.segment_sum", "train.table_update", "train.step"} <= set(spans)


def test_flops_of_the_model_are_its_matmuls():
    """profiling.count_flops (main_train's --report_flops line) of the plain
    forward at batch 1: 2 x the multiply-adds of every linear and cross
    product."""
    mcfg, model = _port()
    dense, ids = torch.zeros(1, 13), torch.zeros(1, 13, dtype=torch.int32)
    flops = profiling.count_flops(lambda m, d, c: m(d, c, "plain"), model, dense, ids)
    w, r = 128 * 5, 64
    assert flops == 2 * (13 * 32 + 32 * 128 + 3 * 2 * w * r + w * 64 + 64 * 32 + 32)
    assert ref.step_flops(CFG, 4) == 3 * 4 * flops - 2 * 4 * 13 * 32


def test_main_train_dcnv2_runs_three_steps(tmp_path):
    from nasrec_tpu_torch.cli import main_train

    out = main_train.main(["--net", "dcnv2", "--device", "cpu", "--data_source", "synthetic",
                           "--synthetic_vocab", "30", "--max_train_steps", "3",
                           "--max_eval_steps", "1", "--train_batch_size", "8",
                           "--test_batch_size", "16", "--logging_dir", str(tmp_path)])
    assert out["state"].step == 3 and out["config"].emb_dim == 128
    from nasrec_tpu_torch.configs.dcnv2 import CRITEO_1TB_ROWS

    assert out["state"].model.embedding.table.shape == (sum(min(v, 30) for v in CRITEO_1TB_ROWS),
                                                        128)
    tags = [json.loads(line)["tag"] for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any(t.startswith("Loss/train") for t in tags)
