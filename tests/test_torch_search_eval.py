"""The port's weight-shared candidate evaluation and search workloads against
the JAX package, on the CPU at a small size (2 blocks, vocab <= 60, <= 10
fine-tune steps): the final-only evaluator (K = 3 candidates in one group,
and the same three one at a time), the whole-net and LayerNorm-calibrate
modes in both forms against the JAX evaluator's same form, the divergence sentinel, the
committed JAX supernet checkpoint's logits, `evaluate_choices_from_supernet`
and random `search_from_supernet` on a checkpoint the JAX package wrote, and
both search CLIs.

The same seed-made numpy batches go through both packages.  Tolerance (f32):
final-only test_loss rel 1e-4, AUROC and accuracy abs 1e-3, and K = 3 against
three K = 1 runs rel 1e-6 (AUROC and accuracy abs 1e-4: a logit that
rounds otherwise in a batched product may swap one pair of examples); whole
and layernorm-calibrate, each form against the JAX package's same form and
the port's two forms against each other, test_loss rel 2e-4, AUROC abs 2e-3
(the JAX package's own test of its two forms); logits of the committed checkpoint
abs 1e-5; the workloads' losses rel 1e-4.
"""

import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu import choices as jax_choices
from nasrec_tpu import workloads as jax_workloads
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.data.synthetic import SyntheticSpec, synthetic_arrays
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_apply as jax_supernet_apply
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.search import Tokenizer as JaxTokenizer
from nasrec_tpu.search import make_candidate_evaluator as jax_make_evaluator
from nasrec_tpu.train.checkpoint import load_any_checkpoint as jax_load_checkpoint
from nasrec_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from nasrec_tpu_torch import choices, workloads
from nasrec_tpu_torch.cli import eval_subnet_from_scratch, eval_subnet_from_supernet
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_apply, supernet_init
from nasrec_tpu_torch.models.transplant import from_jax_params
from nasrec_tpu_torch.search import make_candidate_evaluator
from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PROXY = ROOT / "experiments" / "search_quality_proxy"
SPEC = SyntheticSpec(vocab=60)


def _setup(space, vocab=SPEC.vocab, num_blocks=2, k=3, seed=7):
    kw = dict(num_blocks=num_blocks, num_dense=13, num_sparse=26,
              vocab_sizes=(vocab,) * 26, use_layernorm=True)
    jcfg = JaxSuperNetConfig(space=JAX_OPS[space], attention_impl="xla", **kw)
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB[space], **kw)
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(seed), jcfg))
    model = supernet_init(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    tok = JaxTokenizer(num_blocks, JAX_OPS[space], seed=seed)
    return jcfg, tcfg, params, model, [tok.generate_random_choice() for _ in range(k)]


def _streams(train_bs=64, test_bs=128, n_train=512, n_test=384):
    """(train_iter_fn, test_iter_fn) for JAX (numpy) and for the port (torch
    tensors), over the same seed-made arrays; the train stream ends after
    n_train examples, so a longer fine-tune restarts it."""
    tr, te = synthetic_arrays(n_train, SPEC, 0), synthetic_arrays(n_test, SPEC, 1)

    def make(arrs, bs, conv):
        def it():
            for i in range(0, len(arrs[2]) - bs + 1, bs):
                yield tuple(conv(a[i:i + bs]) for a in arrs)
        return it

    return ((make(tr, train_bs, np.asarray), make(te, test_bs, np.asarray)),
            (make(tr, train_bs, torch.from_numpy), make(te, test_bs, torch.from_numpy)))


def _assert_results(got, want, loss_rel, metric_abs):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["choice"] == w["choice"]
        assert g["test_loss"] == pytest.approx(w["test_loss"], rel=loss_rel)
        assert g["test_auroc"] == pytest.approx(w["test_auroc"], abs=metric_abs)
        assert g["test_acc"] == pytest.approx(w["test_acc"], abs=metric_abs)


@pytest.mark.parametrize("space", ["autoctr", "xlarge"])
def test_final_only_evaluator_matches_jax(space):
    jcfg, tcfg, params, model, picks = _setup(space)
    (jtr, jte), (ttr, tte) = _streams()
    args = dict(max_train_steps=10, max_eval_steps=3, eval_batch_chunk=64)
    want = jax_make_evaluator(jcfg, params, **args)(picks, jtr, jte)
    ev = make_candidate_evaluator(tcfg, model, **args)
    got = ev(picks, ttr, tte)
    _assert_results(got, want, 1e-4, 1e-3)
    assert ev.last_group.weight.shape == (3, tcfg.head_width(), 1)
    assert ev.last_group.bias.shape == (3, 1)
    # The group's candidates advance independently: K = 3 equals three K = 1.
    for k, choice in enumerate(picks):
        one = ev([choice], ttr, tte)[0]
        assert one["test_loss"] == pytest.approx(got[k]["test_loss"], rel=1e-6)
        assert one["test_auroc"] == pytest.approx(got[k]["test_auroc"], abs=1e-4)
        assert one["test_acc"] == pytest.approx(got[k]["test_acc"], abs=1e-4)
    # The supernet itself is never changed.
    for name, t in from_jax_params(params, tcfg).items():
        assert torch.equal(model.state_dict()[name], t), name


@pytest.mark.parametrize("mode", ["whole", "layernorm-calibrate"])
def test_sequential_modes_match_jax(mode):
    """Both forms of the whole-net and LayerNorm-calibrate modes: the default
    (one K-candidate step a group) against the JAX package's batched form,
    batch_candidates=False against its sequential form, and the port's two
    forms against each other within what the JAX package's own two forms are
    held to (tests/test_search.py :: test_batched_whole_finetune_matches_sequential)."""
    # Whole-net fine-tunes can amplify rounding: from another seed (11) one
    # candidate's loss moves by 9e-5 between the JAX package's own two forms.
    jcfg, tcfg, params, model, picks = _setup("autoctr", k=2, seed=7)
    (jtr, jte), (ttr, tte) = _streams()
    args = dict(max_train_steps=9, max_eval_steps=2, finetune_mode=mode)
    want = jax_make_evaluator(jcfg, params, **args)(picks, jtr, jte)
    got = make_candidate_evaluator(tcfg, model, **args)(picks, ttr, tte)
    _assert_results(got, want, 2e-4, 2e-3)
    want_seq = jax_make_evaluator(jcfg, params, batch_candidates=False, **args)(picks, jtr, jte)
    got_seq = make_candidate_evaluator(tcfg, model, batch_candidates=False, **args)(
        picks, ttr, tte)
    _assert_results(got_seq, want_seq, 2e-4, 2e-3)
    _assert_results(got_seq, got, 2e-4, 2e-3)


def test_diverged_candidate_gets_the_sentinel():
    jcfg, tcfg, params, model, picks = _setup("autoctr", k=2)
    (jtr, jte), (ttr, tte) = _streams()
    args = dict(learning_rate=float("inf"), max_train_steps=2, max_eval_steps=1)
    want = jax_make_evaluator(jcfg, params, **args)(picks, jtr, jte)
    got = make_candidate_evaluator(tcfg, model, **args)(picks, ttr, tte)
    sentinel = {"test_acc": -1, "test_auroc": -1, "test_loss": 999.99}
    assert got == want == [{"choice": c, **sentinel} for c in picks]


def test_committed_jax_checkpoint_logits_match_jax():
    """The JAX-trained supernet of experiments/search_quality_proxy
    (xlarge-zeros, 2 blocks, LayerNorm, vocab 500) in the port: the logits of
    two of its recorded candidates at batch 64."""
    kw = dict(num_blocks=2, num_dense=13, num_sparse=26, vocab_sizes=(500,) * 26,
              use_layernorm=True)
    jcfg = JaxSuperNetConfig(space=JAX_OPS["xlarge-zeros"], attention_impl="xla", **kw)
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge-zeros"], **kw)
    path = str(PROXY / "supernet_checkpoint.pkl")
    jparams = jax_load_checkpoint(path)["params"]
    model = supernet_init(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(load_any_checkpoint(path)["params"], tcfg))
    with open(PROXY / "all_results.pickle", "rb") as f:
        records = pickle.load(f)
    dense, cat, _ = synthetic_arrays(64, SyntheticSpec(vocab=500, signal_scale=0.7,
                                                       interaction_pairs=16), seed=1)
    for rec in records[:2]:
        want = jax_supernet_apply(jcfg, jparams, dense, cat, jax_choices.choice_to_masks(
            rec["choice"], JAX_OPS["xlarge-zeros"], 2))
        got = supernet_apply(model, torch.from_numpy(dense), torch.from_numpy(cat),
                             choices.choice_to_masks(rec["choice"],
                                                     OPS_CONFIG_LIB["xlarge-zeros"], 2))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _jax_checkpoint(tmp_path, vocab=40):
    jcfg = JaxSuperNetConfig(space=JAX_OPS["xlarge"], num_blocks=2, num_dense=13,
                             num_sparse=26, vocab_sizes=(vocab,) * 26, use_layernorm=True,
                             attention_impl="xla")
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(4), jcfg))
    path = str(tmp_path / "supernet_checkpoint.pkl")
    jax_save_checkpoint(path, {"params": params, "step": 3})
    return path


DATA = dict(data_source="synthetic", train_batch_size=32, test_batch_size=64,
            synthetic_train_examples=256, synthetic_test_examples=192, synthetic_vocab=40)
SEARCH = dict(config="xlarge", num_blocks=2, max_train_steps=5, max_eval_steps=2,
              group_size=2, seed=3, ea_top_k=2)


def test_search_workloads_on_a_jax_checkpoint_match_jax(tmp_path):
    ckpt = _jax_checkpoint(tmp_path)
    quiet = dict(log_fn=lambda m: None)
    jso = jax_workloads.SearchOptions(method="random", budget=4, ckpt_path=ckpt, **SEARCH)
    tso = workloads.SearchOptions(method="random", budget=4, ckpt_path=ckpt, device="cpu",
                                  **SEARCH)
    want_top = jax_workloads.search_from_supernet(
        jso, jax_workloads.DataOptions(**DATA), logging_dir=str(tmp_path / "jax"), **quiet)
    got_top = workloads.search_from_supernet(
        tso, workloads.DataOptions(**DATA), logging_dir=str(tmp_path / "port"), **quiet)
    _assert_results(got_top, want_top, 1e-4, 1e-3)
    for name in ("results.pickle", "all_results.pickle"):
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        _assert_results(got, want, 1e-4, 1e-3)
    assert len(got) == 4

    picks = [r["choice"] for r in want[:3]]
    want = jax_workloads.evaluate_choices_from_supernet(
        picks, jso, jax_workloads.DataOptions(**DATA), **quiet)
    got = workloads.evaluate_choices_from_supernet(
        picks, tso, workloads.DataOptions(**DATA), **quiet)
    _assert_results(got, want, 1e-4, 1e-3)


def test_search_clis_on_cpu(tmp_path):
    ckpt = _jax_checkpoint(tmp_path)
    base = ["--device", "cpu", "--data_source", "synthetic", "--synthetic_vocab", "40",
            "--config", "xlarge", "--num_blocks", "2", "--ckpt_path", ckpt,
            "--max_train_steps", "4", "--max_eval_steps", "1", "--group_size", "2",
            "--train_batch_size", "32", "--test_batch_size", "64"]
    top = eval_subnet_from_supernet.main(base + ["--method", "random", "--budget", "3",
                                                 "--logging_dir", str(tmp_path / "random")])
    with open(tmp_path / "random" / "all_results.pickle", "rb") as f:
        explored = pickle.load(f)
    assert len(explored) == 3 and len(top) == 2
    assert all(np.isfinite(r["test_loss"]) for r in explored)

    records = [{"choice": r["choice"], "test_loss": 0.5 + i} for i, r in enumerate(explored)]
    with open(tmp_path / "records.pickle", "wb") as f:
        pickle.dump(records, f)
    cached = eval_subnet_from_supernet.main(base + [
        "--method", "cached", "--choice_from_pickle_file", str(tmp_path / "records.pickle"),
        "--logging_dir", str(tmp_path / "cached")])
    with open(tmp_path / "cached" / "results.pickle", "rb") as f:
        assert pickle.load(f) == cached
    assert [r["gt_test_loss"] for r in cached] == [0.5, 1.5, 2.5]
    assert [r["choice"] for r in cached] == [r["choice"] for r in explored]

    # From scratch: the JAX tokenizer's draws, in the JAX layout.
    out = eval_subnet_from_scratch.main([
        "--device", "cpu", "--data_source", "synthetic", "--config", "xlarge",
        "--num_blocks", "2", "--num_subnets", "2", "--max_train_steps", "3",
        "--max_eval_steps", "1", "--train_batch_size", "32", "--test_batch_size", "64",
        "--learning_rate", "0.02", "--seed", "5", "--logging_dir", str(tmp_path / "scratch")])
    with open(tmp_path / "scratch" / "from_scratch_results.pickle", "rb") as f:
        assert pickle.load(f) == out
    tok = JaxTokenizer(2, JAX_OPS["xlarge"], seed=5)
    for r in out:
        want = tok.generate_random_choice()
        assert r["choice"] == want and r["hash_token"] == tok.hash_choice(want)
        assert list(r) == ["choice", "test_loss", "test_auroc", "test_acc", "hash_token"]
        assert np.isfinite(r["test_loss"])


def test_from_scratch_records_the_sentinel(monkeypatch):
    """A diverged run (the loop's sentinel logs, or no test at all) is
    recorded as the JAX package records it."""
    logs = {"test_loss": [], "test_AUROC": [], "test_Accuracy": []}
    monkeypatch.setattr(workloads, "train_fixed_subnet", lambda *a, **k: {"logs": [logs]})
    out = workloads.eval_subnets_from_scratch(
        1, config="autoctr", num_blocks=2, data=workloads.DataOptions(data_source="synthetic"),
        train=workloads.TrainOptions(device="cpu"), log_fn=lambda m: None)
    assert (out[0]["test_loss"], out[0]["test_auroc"], out[0]["test_acc"]) == (999.99, -1, -1)
