"""The port's search layer against the JAX package, on the host: the
tokenizer's random choices, mutations and hashes; the Searcher's random
search and regularized evolution with a scripted score function (histories
and all_results) for every criterion; `freeze_mask`'s trainable sets mapped
through the transplant; the EA export tool's files; the fixed-subnet CLI's
`--net supernet` options; the search branches that were refused before
they were ported (the cross-process fan-out now runs); and the search, the
re-scoring and the from-scratch evaluation on TSV shards.

Tolerance: none.  Choices, hashes, histories, trainable sets and exported
files must be equal.
"""

import hashlib
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest

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
