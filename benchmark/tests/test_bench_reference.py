"""The reference against the port's plain path at a tiny size on the CPU:
the same weights give the same logits and the same first steps, for the
fixed subnet and for the supernet under a sampled subnet's masks; the
reference's TSV parse gives the port's parsers' batches."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lib import traffic
from lib.weights import make_weights
from reference import nasrec_ref, tsv_ref

BENCH = Path(__file__).resolve().parents[1]
VOCAB_CAP = 300


def _cfg(name, **kw):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(kw)
    vocab = [min(v, VOCAB_CAP) for v in cfg["vocab_sizes"]]
    return cfg, vocab


def _batch(cfg, vocab, b=64, i=0):
    return traffic.device_batch(7, i, b, vocab, cfg["num_dense"], 0.25, "cpu")


def test_fixed_forward_and_weights_match_the_port():
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init

    cfg, vocab = _cfg("criteo-xlarge")
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(lambda: nasrec_ref.FixedRef(cfg, vocab)),
                                  vocab)
    ref = nasrec_ref.build(lambda: nasrec_ref.FixedRef(cfg, vocab), make_weights(specs, 7, "cpu"))
    plan = build_fixed_plan(cfg["choice"], OPS_CONFIG_LIB["xlarge"], 7, 13, 26, vocab)
    port = fixed_init(plan, seed=0)
    port.load_state_dict(make_weights(specs, 7, "cpu"), strict=True)
    dense, cat, _ = _batch(cfg, vocab)
    stem = port.embedding(cat)
    with torch.no_grad():
        want = port.forward_embedded(dense, stem, impl="plain")
        got = ref.forward_stem(dense, stem)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert ref.live == list(port.live)


def test_supernet_forward_matches_the_port():
    from nasrec_tpu_torch.choices import choice_to_masks
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.sampling import ChoiceSampler

    cfg, vocab = _cfg("criteo-supernet", num_blocks=3)
    space = OPS_CONFIG_LIB["xlarge"]
    port = supernet_init(SuperNetConfig(space=space, num_blocks=3, num_dense=13, num_sparse=26,
                                        vocab_sizes=tuple(vocab)))
    fn = lambda: nasrec_ref.SuperNetRef(cfg, vocab)
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(fn), vocab)
    port.load_state_dict(make_weights(specs, 3, "cpu"), strict=True)
    ref = nasrec_ref.build(fn, make_weights(specs, 3, "cpu"))
    dense, cat, _ = _batch(cfg, vocab)
    sampler = ChoiceSampler(space, 3, anypath_choice="binomial-0.5", seed=5)
    for _ in range(4):
        choice = sampler()
        nasrec_ref.check_choice(cfg, choice)
        with torch.no_grad():
            want = port(dense, cat, choice_to_masks(choice, space, 3), impl="plain")
            stem = port.embedding(cat)
            got = ref.forward_stem(dense, stem, nasrec_ref.choice_masks(cfg, choice, "cpu"))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reference_step_matches_the_port_step():
    """Three sparse-embedding steps of the port's plain path against the
    reference's dense Adagrad: losses, every parameter, every accumulator."""
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init
    from nasrec_tpu_torch.train.optim import slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    cfg, vocab = _cfg("criteo-xlarge")
    fn = lambda: nasrec_ref.FixedRef(cfg, vocab)
    specs = nasrec_ref.init_specs(nasrec_ref.shapes_of(fn), vocab)
    plan = build_fixed_plan(cfg["choice"], OPS_CONFIG_LIB["xlarge"], 7, 13, 26, vocab)
    port = fixed_init(plan)
    port.load_state_dict(make_weights(specs, 11, "cpu"))
    lr = lambda s: 0.05
    state = init_sparse_train_state(port)
    step = make_sparse_embedding_train_step(lr, impl="plain")
    trainer = nasrec_ref.RefTrainer(nasrec_ref.build(fn, make_weights(specs, 11, "cpu")), lr)
    for i in range(3):
        b = _batch(cfg, vocab, 128, i)
        _, m = step(state, *b)
        assert trainer.step(*b) == pytest.approx(float(m["loss"]), rel=1e-6)
    accs = slot_dicts(state.opt_state)[0]
    for n, p in port.named_parameters():
        torch.testing.assert_close(trainer.params[n], p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(trainer.acc[n], accs[n], rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("native", [False, True])
def test_tsv_parse_matches_the_port(native, tmp_path):
    from nasrec_tpu_torch.data.pipeline import make_dataset_iterators

    cfg, _ = _cfg("criteo-xlarge")
    vocab = cfg["vocab_sizes"]
    spec = {"shards": 2, "rows_per_shard": 512, "missing_rate": 0.15, "short_rate": 0.05}
    shards = traffic.tsv_shards(9, spec, 13, 26, 0.25)
    for s, text in enumerate(shards):
        (tmp_path / f"shard-{s}").mkdir()
        (tmp_path / f"shard-{s}" / "trainval.txt").write_bytes(text)
    it, _ = make_dataset_iterators("criteo-kaggle", str(tmp_path), train_batch_size=128,
                                   test_batch_size=128, validate_split="trainval",
                                   use_native=native)
    for k, got in enumerate(it()):
        want = tsv_ref.parse(traffic.tsv_batch_lines(shards, k, 128), 13, vocab)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert k == 7
