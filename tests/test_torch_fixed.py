"""The port's fixed-subnet model against the JAX package: the same plan, and
the same logits for all six published best archs from transplanted weights.

Tolerance (f32 forward): rtol 1e-5 / atol 1e-6 on the plan, rtol 1e-4 /
atol 1e-5 on the logits, which pass through seven blocks and a 2048-wide
head whose sums the two frameworks order differently.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import build_fixed_plan as jax_build_plan
from nasrec_tpu.models import fixed_apply as jax_fixed_apply
from nasrec_tpu.models import fixed_init as jax_fixed_init

from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_apply, fixed_init
from nasrec_tpu_torch.models.transplant import from_jax_params

torch.set_num_threads(2)

ARCHS = [(d, s) for d in ("criteo-kaggle", "avazu", "kdd") for s in ("xlarge", "autoctr")]
VOCAB_CAP = 40


def _plans(dataset, space, vocab):
    spec = DATASETS[dataset]
    jplan = jax_build_plan(jax_best_arch(dataset, space), JAX_OPS[space], 7,
                           spec.num_dense, spec.num_sparse, vocab)
    tplan = build_fixed_plan(get_best_arch(dataset, space), OPS_CONFIG_LIB[space], 7,
                             spec.num_dense, spec.num_sparse, vocab)
    return spec, jplan, tplan


@pytest.mark.parametrize("dataset,space", ARCHS)
def test_build_fixed_plan_matches_jax(dataset, space):
    spec = DATASETS[dataset]
    _, jplan, tplan = _plans(dataset, space, (VOCAB_CAP,) * spec.num_sparse)
    assert tplan.blocks == tuple(
        type(tplan.blocks[0])(**dataclasses.asdict(b)) for b in jplan.blocks)
    for f in ("num_blocks", "num_dense", "num_sparse", "vocab_sizes", "emb_dim",
              "use_layernorm", "activation", "head_width", "last_n_blocks_out"):
        assert getattr(tplan, f) == getattr(jplan, f), f


@pytest.mark.parametrize("dataset,space", ARCHS)
def test_fixed_apply_logits_match_jax(dataset, space):
    spec = DATASETS[dataset]
    vocab = tuple(min(v, VOCAB_CAP) for v in spec.raw_vocab_sizes)
    _, jplan, tplan = _plans(dataset, space, vocab)
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(1), jplan))
    model = fixed_init(tplan, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tplan))

    rng = np.random.RandomState(0)
    b = 32
    dense = rng.randn(b, spec.num_dense).astype(np.float32)
    cat = np.stack([rng.randint(0, v, size=b) for v in vocab], 1).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, d, c: jax_fixed_apply(jplan, p, d, c))(
        params, dense, cat))
    with torch.no_grad():
        got = fixed_apply(model, torch.from_numpy(dense), torch.from_numpy(cat)).numpy()
    assert got.shape == want.shape == (b, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_blocks_nothing_reads_are_skipped():
    """criteo-kaggle/xlarge: block 6 reads blocks 0-2 only and the head reads
    block 6, so blocks 3-5 (one of them a transformer node) never run; the
    logits above are the JAX package's all the same."""
    from nasrec_tpu_torch.models.fixed import live_blocks

    spec = DATASETS["criteo-kaggle"]
    _, _, tplan = _plans("criteo-kaggle", "xlarge", (VOCAB_CAP,) * spec.num_sparse)
    assert live_blocks(tplan) == (True, True, True, False, False, False, True)
    _, _, aplan = _plans("kdd", "autoctr", (VOCAB_CAP,) * DATASETS["kdd"].num_sparse)
    assert all(live_blocks(aplan))

    model = fixed_init(tplan, seed=0, device="cpu")
    ran = []
    for i, block in enumerate(model.blocks):
        block.register_forward_hook(lambda *_, i=i: ran.append(i))
    rng = np.random.RandomState(0)
    dense = torch.from_numpy(rng.randn(4, spec.num_dense).astype(np.float32))
    cat = torch.from_numpy(rng.randint(0, VOCAB_CAP, size=(4, spec.num_sparse)).astype(np.int32))
    fixed_apply(model, dense, cat).sum().backward()
    assert ran == [0, 1, 2, 6]
    assert all(p.grad is not None for b in (0, 1, 2, 6) for p in model.blocks[b].parameters())
    assert all(p.grad is None for b in (3, 4, 5) for p in model.blocks[b].parameters())
