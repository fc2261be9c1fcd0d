"""The port's search layer against the JAX package, on the host: the
tokenizer's random choices, mutations and hashes; the Searcher's random
search and regularized evolution with a scripted score function (histories
and all_results) for every criterion; `freeze_mask`'s trainable sets mapped
through the transplant; the EA export tool's files; the fixed-subnet CLI's
`--net supernet` options; the search branches that were refused before
they were ported (the cross-process fan-out now runs); and the search, the
re-scoring and the from-scratch evaluation on TSV shards; and the
final-only group's pruned body against the masked forward it replaces, with
the transformer and dot-product nodes it calls as that forward calls them.

Tolerance: none.  Choices, hashes, histories, trainable sets and exported
files must be equal.  The pruned body: each candidate's features, logits
and fine-tuned finals within 1e-5 of the masked forward's norm (f32; the
two add the same products in another order).
"""

import hashlib
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.search import SearchConfig as JaxSearchConfig
from nasrec_tpu.search import Searcher as JaxSearcher
from nasrec_tpu.search import Tokenizer as JaxTokenizer
from nasrec_tpu.tools.export_ea_results import export_best as jax_export_best
from nasrec_tpu.train.loop import freeze_mask as jax_freeze_mask

from nasrec_tpu_torch.cli import main_train
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
from nasrec_tpu_torch.models.transplant import from_jax_params
from nasrec_tpu_torch.search import SearchConfig, Searcher, Tokenizer
from nasrec_tpu_torch.tools.export_ea_results import export_best
from nasrec_tpu_torch.train.loop import FREEZE_MODES, freeze_mask
from nasrec_tpu_torch import workloads

ROOT = Path(__file__).resolve().parents[1]
PROXY = ROOT / "experiments" / "search_quality_proxy"
CRITERIA = ("test_loss", "test_acc", "test_auroc", "test_loss_penalty_lat")


@pytest.mark.parametrize("space,num_blocks,seed", [("xlarge", 7, 0), ("autoctr", 3, 1),
                                                   ("xlarge-zeros", 2, 2)])
def test_tokenizer_draws_the_jax_sequence(space, num_blocks, seed):
    """200 draws: a random choice, a mutation of it and of the previous
    draw, each hashed and tokenized."""
    jt = JaxTokenizer(num_blocks, JAX_OPS[space], seed=seed)
    tt = Tokenizer(num_blocks, OPS_CONFIG_LIB[space], seed=seed)
    prev = None
    for _ in range(200):
        want, got = jt.generate_random_choice(), tt.generate_random_choice()
        assert got == want
        assert tt.hash_choice(got) == jt.hash_choice(want)
        np.testing.assert_array_equal(tt.tokenize(got), jt.tokenize(want))
        for base in (want, prev) if prev is not None else (want,):
            mw, mg = jt.mutate_spec(base), tt.mutate_spec(base)
            assert mg == mw and tt.hash_choice(mg) == jt.hash_choice(mw)
        prev = want


def _scripted_eval(tokenizer):
    """A fixed function of the hash: the same scores in both packages."""

    def eval_fn(choices):
        out = []
        for c in choices:
            d = hashlib.sha256(tokenizer.hash_choice(c).encode()).digest()
            u = [b / 255.0 for b in d[:4]]
            out.append({"choice": c, "test_loss": 0.4 + 0.1 * u[0], "test_acc": 0.7 + 0.1 * u[1],
                        "test_auroc": 0.7 + 0.1 * u[2], "latency": 1.0 + u[3]})
        return out

    return eval_fn


@pytest.mark.parametrize("method", ["random", "regularized-ea"])
@pytest.mark.parametrize("criterion", CRITERIA)
def test_searcher_matches_jax(criterion, method):
    space, nb = "xlarge", 4
    cfg = dict(criterion=criterion, group_size=3, seed=5,
               beta=0.5 if criterion == "test_loss_penalty_lat" else 0.0, target_latency=1.5)
    runs = []
    for tok_cls, ops, searcher_cls, cfg_cls in (
            (JaxTokenizer, JAX_OPS, JaxSearcher, JaxSearchConfig),
            (Tokenizer, OPS_CONFIG_LIB, Searcher, SearchConfig)):
        tok = tok_cls(nb, ops[space], seed=5)
        calls = []
        score = _scripted_eval(tok)

        def eval_fn(choices, score=score, calls=calls):
            calls.append(len(choices))
            return score(choices)

        s = searcher_cls(eval_fn, tok, cfg_cls(**cfg), log_fn=lambda m: None)
        if method == "random":
            out = s.random_search_from_supernet(budget=10, top_k=4)
        else:
            out = s.regularized_evolution_from_supernet(
                n_generations=6, n_childs=4, init_population=9, sample_size=5, top_k=2)
        runs.append((out, s.all_results, calls))
    (want, want_all, want_calls), (got, got_all, got_calls) = runs
    assert got == want and got_all == want_all and got_calls == want_calls
    assert all(n <= 3 for n in got_calls)


def _jax_supernet_params(space="autoctr", num_blocks=2, vocab=(50,) * 26):
    jcfg = JaxSuperNetConfig(space=JAX_OPS[space], num_blocks=num_blocks, num_dense=13,
                             num_sparse=26, vocab_sizes=vocab, use_layernorm=True,
                             attention_impl="xla")
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB[space], num_blocks=num_blocks, num_dense=13,
                          num_sparse=26, vocab_sizes=vocab, use_layernorm=True)
    return jax.device_get(jax_supernet_init(jax.random.PRNGKey(0), jcfg)), tcfg


@pytest.mark.parametrize("space", ["autoctr", "xlarge"])
@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_mask_selects_the_jax_leaves(mode, space):
    """The JAX package's 0/1 mask tree, carried through the transplant, marks
    exactly the parameters the port trains (the layernorm-calibrate set is
    the one tests/test_train.py pins for JAX)."""
    params, tcfg = _jax_supernet_params(space)
    jmask = jax.device_get(jax_freeze_mask(params, mode))
    want = {name for name, t in from_jax_params(jmask, tcfg).items() if bool((t == 1).all())}
    got = freeze_mask(supernet_init(tcfg, 0, "cpu"), mode)
    assert {n for n, keep in got.items() if keep} == want
    if mode == "layernorm-calibrate":
        assert want and all(n.startswith("blocks.") for n in want)
        assert any(n.endswith(".ln.weight") for n in want)
        assert any("attn_ln" in n for n in want) == (space == "xlarge")


def test_export_ea_results_writes_the_jax_files(tmp_path):
    with open(PROXY / "all_results.pickle", "rb") as f:
        results = pickle.load(f)
    kw = dict(config="xlarge-zeros", num_blocks=2, use_layernorm=True, top_k=6,
              log_fn=lambda m: None)
    want = jax_export_best(results, str(tmp_path / "jax"), **kw)
    got = export_best(results, str(tmp_path / "port"), **kw)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert len(got) == 6
    for g, w in zip(got, want):
        assert Path(g).read_bytes() == Path(w).read_bytes()


def test_main_train_net_supernet_trains_the_full_path(monkeypatch):
    seen = {}

    def fake_train_supernet(sn, data, train):
        seen.update(sn=sn, data=data, train=train)
        return {"ok": True}

    monkeypatch.setattr(workloads, "train_supernet", fake_train_supernet)
    out = main_train.main(["--net", "supernet", "--data_source", "synthetic", "--device", "cpu",
                           "--max_train_steps", "3", "--last_n_blocks_out", "2"])
    assert out == {"ok": True}
    assert seen["sn"] == workloads.SupernetOptions(
        config="xlarge", num_blocks=7, use_layernorm=True, strategy="full-path",
        supernet_training_steps=0, last_n_blocks_out=2)
    assert seen["data"].data_source == "synthetic" and seen["train"].max_train_steps == 3
    assert seen["train"].device == "cpu" and seen["train"].learning_rate == 0.16


def _refusals():
    """The search branches once refused as unported.  `distribute` is ported
    (tests/test_torch_mesh.py runs it over two ranks): in one process a
    Searcher built with it evaluates every group itself."""
    seen = []

    def eval_fn(choices):
        seen.append(len(choices))
        return [{"choice": c, "test_loss": 0.5} for c in choices]

    def distribute():
        searcher = Searcher(eval_fn, Tokenizer(2, OPS_CONFIG_LIB["xlarge"], seed=0),
                            SearchConfig(distribute=True, group_size=2, seed=0),
                            log_fn=lambda s: None)
        return searcher.random_search_from_supernet(budget=5, top_k=2), seen

    return {"distribute": distribute}


@pytest.mark.parametrize("what", sorted(_refusals()))
def test_unported_search_branches_raise_up_front(what):
    top, seen = _refusals()[what]()
    assert len(top) == 2 and seen == [2, 2, 1]


@pytest.fixture(scope="module")
def tsv_data(tmp_path_factory):
    """A 2-shard criteo-shaped TSV root, read with the search's vocab cap."""
    from nasrec_tpu_torch.config import SEARCH_MAX_NUM_EMBEDDINGS
    from nasrec_tpu_torch.data.synthetic import write_tsv_shards

    root = tmp_path_factory.mktemp("tsv")
    write_tsv_shards(str(root), 13, 26, {"trainval": 2 * 64, "test": 2 * 40}, 2, seed=4)
    return workloads.DataOptions(root_dir=str(root), vocab_cap=SEARCH_MAX_NUM_EMBEDDINGS,
                                 train_batch_size=32, test_batch_size=32)


def _tsv_search_options(**kw):
    return workloads.SearchOptions(config="autoctr", num_blocks=2, max_train_steps=2,
                                   max_eval_steps=2, group_size=2, device="cpu", **kw)


def test_search_runs_on_tsv(tsv_data, tmp_path):
    """A random search over a supernet on TSV batches: its tables are the
    search cap's (500,000 rows a slot where the slot has more)."""
    out = workloads.search_from_supernet(_tsv_search_options(method="random", budget=3,
                                                             ea_top_k=2),
                                         tsv_data, logging_dir=str(tmp_path),
                                         log_fn=lambda m: None)
    assert len(out) == 2 and all(np.isfinite(r["test_loss"]) for r in out)
    with open(tmp_path / "all_results.pickle", "rb") as f:
        assert len(pickle.load(f)) == 3


def test_rescore_runs_on_tsv(tsv_data):
    tok = Tokenizer(2, OPS_CONFIG_LIB["autoctr"], seed=3)
    picks = [tok.generate_random_choice() for _ in range(3)]
    out = workloads.evaluate_choices_from_supernet(picks, _tsv_search_options(), tsv_data,
                                                   log_fn=lambda m: None)
    assert [r["choice"] for r in out] == picks
    assert all(np.isfinite(r["test_loss"]) and 0.0 <= r["test_auroc"] <= 1.0 for r in out)


def test_scratch_runs_on_tsv(tsv_data, tmp_path):
    out = workloads.eval_subnets_from_scratch(
        2, config="autoctr", num_blocks=2, data=tsv_data,
        train=workloads.TrainOptions(max_train_steps=2, test_interval=2, learning_rate=0.02,
                                     device="cpu"),
        logging_dir=str(tmp_path), log_fn=lambda m: None)
    assert len(out) == 2 and all(np.isfinite(r["test_loss"]) for r in out)
    assert (tmp_path / "from_scratch_results.pickle").exists()


# The final-only group's pruned body (search/pruned_body.py) against the
# masked forward it replaces: vmap(head_features_embedded) over the
# candidates' masks.  xlarge node indices: 0 linear-2d, 1 dot-product,
# 2 sigmoid-gating, 3 sum, 4 transformer, 5 linear-3d; xlarge-zeros: 0
# linear-2d, 1 dot-product, 2 sigmoid-gating, 3 sum, 4 zeros-2d,
# 5 transformer, 6 zeros-3d, 7 linear-3d.

PRUNE_TOL = 1e-5        # relative to the norm of the masked forward's value


def _spec(dense, sparse, left, right, nodes, d=1024, s=64, interact=1, fm=1):
    return ({"dense_idx": dense, "sparse_idx": sparse, "dense_left_idx": left,
             "dense_right_idx": right},
            {"active_nodes": nodes, "dense_in_dims": d, "sparse_in_dims": s,
             "dense_sparse_interact": interact, "deep_fm": fm})


def _choice(*blocks):
    return {"macro": [b[0] for b in blocks], "micro": [b[1] for b in blocks]}


def _sampled(space, nb, seed, k=4):
    from nasrec_tpu_torch.sampling import ChoiceSampler

    s = ChoiceSampler(OPS_CONFIG_LIB[space], nb, strategy="default",
                      anypath_choice="binomial-0.5", seed=seed)
    return [s() for _ in range(k)]


def _pruning_cases():
    from nasrec_tpu_torch.choices import full_path_choice

    return {
        "sampled-0": ("xlarge", 3, _sampled("xlarge", 3, 0)),
        "sampled-1": ("xlarge", 3, _sampled("xlarge", 3, 1)),
        "sampled-2": ("xlarge-zeros", 3, _sampled("xlarge-zeros", 3, 2)),
        "all-on": ("xlarge", 3, [full_path_choice(OPS_CONFIG_LIB["xlarge"], 3)]
                   + _sampled("xlarge", 3, 3, k=1)),
        # the head reads the last two blocks (last_n_blocks_out 2)
        "last-two-blocks-out": ("xlarge", 3, _sampled("xlarge", 3, 5), 2),
        # block 1 computes nothing but its deep-fm term and its merge
        "zeros-only-block": ("xlarge-zeros", 3, [
            _choice(_spec([0], [0], [0], [0], [0, 7], 256, 32),
                    _spec([0, 1], [0, 1], [1], [0], [4, 6], 512, 48),
                    _spec([1, 2], [2], [2], [1], [2, 5], 128, 16)),
            _choice(_spec([0], [0], [0], [0], [3, 5], 64, 64),
                    _spec([1], [1], [0], [1], [4, 6], 1024, 16, interact=0, fm=0),
                    _spec([2], [0, 2], [2], [2], [0, 7], 32, 64))]),
        # no block reads block 1 (virtual block 2): its GEMMs are all cut
        "dead-block": ("xlarge", 3, [
            _choice(_spec([0], [0], [0], [0], [0, 5], 128, 48),
                    _spec([0, 1], [1], [1], [0], [3, 4], 768, 64),
                    _spec([0, 1], [0, 1], [1], [0], [2, 5], 512, 32)),
            _choice(_spec([0], [0], [0], [0], [0, 1, 2, 3, 4, 5]),
                    _spec([1], [0], [0], [1], [0, 5]),
                    _spec([1], [1], [0], [0], [0, 1, 4]))]),
        "interact-and-deep-fm-off": ("xlarge", 3, [
            _choice(*[_spec(list(range(i + 1)), list(range(i + 1)), [i], [0],
                            [0, 1, 2, 3, 4, 5], 256 * (i + 1), 16 * (i + 1), 0, 0)
                      for i in range(3)])]),
        # left and right read different blocks, each at its own width
        "disjoint-gating": ("xlarge", 3, [
            _choice(_spec([0], [0], [0], [0], [0, 2, 5], 64, 16),
                    _spec([0, 1], [0, 1], [0], [1], [2, 3, 4], 256, 48),
                    _spec([2], [1, 2], [2], [1], [2, 3, 5], 1024, 64)),
            _choice(_spec([0], [0], [0], [0], [2, 4], 32, 32),
                    _spec([1], [0], [1], [0], [2, 5], 16, 64, fm=0),
                    _spec([0, 2], [2], [0], [2], [2, 3, 4], 768, 16, interact=0))]),
    }


def _pruning_net(space, nb, last_n=1, vocab=40):
    """A supernet with every bias and LayerNorm offset away from 0, so that a
    zero input column or a zero-filled GEMM would show."""
    cfg = SuperNetConfig(space=OPS_CONFIG_LIB[space], num_blocks=nb, num_dense=13,
                         num_sparse=26, vocab_sizes=(vocab,) * 26, use_layernorm=True,
                         last_n_blocks_out=last_n)
    net = supernet_init(cfg, 5, "cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    return net


def _masked_group(net, choices):
    """A FinalOnlyGroup whose body is the masked forward."""
    from nasrec_tpu_torch.search.worker import FinalOnlyGroup
    from nasrec_tpu_torch.train.optim import make_lr_schedule

    group = FinalOnlyGroup(net, choices, make_lr_schedule("cosine", 0.04, 3, 0), 5.0, 1e-2,
                           "auto")

    @torch.no_grad()
    def features(dense, cat):
        stem = net.embedding(cat)
        return torch.func.vmap(lambda m: net.head_features_embedded(dense, stem, m, "auto"))(
            group.masks)

    return group, features


def _pruning_batches(vocab=40, rows=48, n=4):
    g = torch.Generator().manual_seed(3)
    return [(torch.randn(rows, 13, generator=g),
             torch.randint(0, vocab, (rows, 26), generator=g, dtype=torch.int32),
             torch.randint(0, 2, (rows, 1), generator=g).float()) for _ in range(n)]


def _rel_each(got, want):
    """The largest over the candidates (axis 0) of |got - want| / |want|."""
    return max(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
               for a, b in zip(got, want))


@pytest.mark.parametrize("case", sorted(_pruning_cases()))
def test_pruned_final_only_body_matches_the_masked_forward(case):
    """The group's pruned features, its logits, and its finals after 3
    fine-tune steps (then its logits again) against the same group whose
    body is the masked forward, each candidate within 1e-5 of the norm."""
    space, nb, choices, *last_n = _pruning_cases()[case]
    net = _pruning_net(space, nb, *last_n)
    batches = _pruning_batches()
    pruned, _ = _masked_group(net, choices)
    masked, masked_features = _masked_group(net, choices)
    masked.features = masked_features
    dense, cat, _ = batches[-1]
    assert _rel_each(pruned.features(dense, cat), masked_features(dense, cat)) <= PRUNE_TOL
    assert _rel_each(pruned.logits(dense, cat), masked.logits(dense, cat)) <= PRUNE_TOL
    for i, batch in enumerate(batches[:3]):
        pruned.step(*batch, i)
        masked.step(*batch, i)
    assert _rel_each(pruned.weight, masked.weight) <= PRUNE_TOL
    assert _rel_each(pruned.bias, masked.bias) <= PRUNE_TOL
    assert _rel_each(pruned.logits(dense, cat), masked.logits(dense, cat)) <= PRUNE_TOL
    if case == "all-on":
        assert pruned.body.macs_run > pruned.body.macs_masked // 2
    else:
        assert pruned.body.macs_run < pruned.body.macs_masked


@pytest.mark.parametrize("space", ["xlarge", "xlarge-zeros"])
def test_pruned_body_calls_the_hand_written_nodes_as_the_masked_forward(space):
    """Forward hooks on every Transformer and DotProduct: a pruned group's
    fine-tune step and eval chunk call them as often and in the same order
    as the masked forward, on the same inputs folded: the masked forward
    calls each under vmap on one candidate's rows [B, ...] (and its mask
    [W]), which the kernels' vmap rule folds to one launch over [K B, ...];
    the pruned body calls each once on the K candidates' rows [K B, ...]
    (and their masks [K, W]).  So the kernels launch alike, as the search
    benchmark's kernel bound counts them."""
    from nasrec_tpu_torch.ops.attention import Transformer
    from nasrec_tpu_torch.ops.interactions import DotProduct

    net = _pruning_net(space, 3)
    choices = _sampled(space, 3, 4) + _pruning_cases()["dead-block"][2][:1] * (space == "xlarge")
    k = len(choices)
    calls = []
    for name, mod in net.named_modules():
        if isinstance(mod, (Transformer, DotProduct)):
            mod.register_forward_hook(lambda m, args, out, name=name: calls.append(
                (name, tuple(tuple(a.shape) for a in args if torch.is_tensor(a)),
                 tuple(out.shape))))
    seen = []
    for masked in (False, True):
        group, features = _masked_group(net, choices)
        if masked:
            group.features = features
        train, test = _pruning_batches(rows=32, n=1)[0], _pruning_batches(rows=64, n=1)[0]
        group.step(*train, 0)
        group.logits(*test[:2])
        seen.append(list(calls))
        calls.clear()

    def fold(shape):
        return (k * shape[0],) + shape[1:] if len(shape) > 1 else (k,) + shape

    pruned, masked = seen
    assert [c[0] for c in pruned] == [c[0] for c in masked]
    assert len(masked) == 2 * 3 * 2 and {c[1][0][0] for c in masked} == {32, 64}
    for (_, args, out), (_, margs, mout) in zip(pruned, masked):
        assert args == tuple(fold(a) for a in margs) and out == fold(mout)
