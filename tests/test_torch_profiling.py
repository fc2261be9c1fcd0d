"""The port's profiling layer (`nasrec_tpu_torch/profiling.py`) against the
JAX package's (`nasrec_tpu/profiling.py`), on the host.

- `count_params` equals the JAX count of the transplanted tree.
- `dot_flops` of each node type equals the JAX `dot_flops` of the same node
  function (JAX on its plain `xla` path); each kernel's FLOP formula equals
  its plain version's dispatcher count, forward and backward.
- `dot_flops` of a fixed subnet's forward (plain, on the meta device) equals
  the JAX `dot_flops` of the same plan's jaxpr after dead-code elimination
  with the port's notion of liveness: every node of a block that the logits
  depend on is kept, as the port computes it (`models/fixed.py ::
  live_blocks`); the blocks nothing reads are dropped.
- The cost model ranks candidates as the JAX package's does.
- `chained_rate`, `timing_fallbacks`, `measure_latency` and `calibrate_chip`.

Tolerance: none for counts (exact integers); the rank test's is stated there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.interpreters.partial_eval import dce_jaxpr

from nasrec_tpu import profiling as jprof
from nasrec_tpu.config import DATASETS as JAX_DATASETS
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import fixed as jfixed
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.ops import attention as jatt
from nasrec_tpu.ops import common as jcommon
from nasrec_tpu.ops import interactions as jint
from nasrec_tpu.ops import linear as jlin
from nasrec_tpu.search.tokenizer import Tokenizer as JaxTokenizer

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models import fixed as tfixed
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
from nasrec_tpu_torch.models.transplant import to_jax_params
from nasrec_tpu_torch.ops.attention import Transformer
from nasrec_tpu_torch.ops.common import Linear
from nasrec_tpu_torch.ops.interactions import FM3D, DotProduct, SigmoidGating, Sum
from nasrec_tpu_torch.ops.kernels import attention, dotprod, transformer_body
from nasrec_tpu_torch.ops.linear import ElasticLinear, ElasticLinear3D

SPEC = JAX_DATASETS["criteo-kaggle"]
VOCAB = tuple([1000] * SPEC.num_sparse)
E = 16
B = 32
KEY = jax.random.PRNGKey(0)


def _gen():
    return torch.Generator().manual_seed(0)


def _pair(shape_np):
    x = np.random.RandomState(1).randn(*shape_np).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


# --------------------------------------------------------------------------
# count_params
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["xlarge", "autoctr"])
def test_count_params_of_a_best_arch_equals_jax(arch):
    choice = get_best_arch("criteo-kaggle", arch)
    plan = tfixed.build_fixed_plan(choice, OPS_CONFIG_LIB[arch], len(choice["macro"]),
                                   SPEC.num_dense, SPEC.num_sparse, VOCAB)
    model = tfixed.fixed_init(plan, 0)
    jplan = jfixed.build_fixed_plan(jax_best_arch("criteo-kaggle", arch), JAX_OPS[arch],
                                    len(choice["macro"]), SPEC.num_dense, SPEC.num_sparse, VOCAB)
    want = jprof.count_params(jfixed.fixed_init(KEY, jplan))
    assert profiling.count_params(model) == jprof.count_params(to_jax_params(model)) == want
    assert profiling.count_params(model.state_dict()) == want


def test_count_params_of_the_supernet_equals_jax():
    kw = dict(num_blocks=2, num_dense=13, num_sparse=26, vocab_sizes=(50,) * 26,
              use_layernorm=True)
    model = supernet_init(SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], **kw), 0)
    want = jprof.count_params(jax_supernet_init(
        KEY, JaxSuperNetConfig(space=JAX_OPS["xlarge"], attention_impl="xla", **kw)))
    assert profiling.count_params(model) == jprof.count_params(to_jax_params(model)) == want


# --------------------------------------------------------------------------
# dot_flops per node
# --------------------------------------------------------------------------


def _node_cases():
    """name -> (jax fn, jax args, torch fn, torch args): one node function
    each, at batch 32, with every projection of the node present."""
    d40, t40 = _pair((B, 40))
    d24, t24 = _pair((B, 24))
    s10, u10 = _pair((B, 10 * E))
    s64, u64 = _pair((B, 64 * E))
    cases = {}
    cases["linear"] = (
        lambda p, x: jlin.elastic_linear_apply(p, x, "relu", None),
        (jlin.elastic_linear_init(KEY, 40, 24, False), d40),
        lambda m, x: m(x, "relu"), (ElasticLinear(40, 24, False, _gen()), t40))
    cases["dot-product"] = (
        lambda p, d, s: jint.dot_product_apply_flat(p, d, s, 10, E, None, impl="xla"),
        (jint.dot_product_init(KEY, 40, 10, 24, E, False), d40, s10),
        lambda m, d, s: m(d, s, 10, E, "plain"),
        (DotProduct(40, 10, 24, E, False, _gen()), t40, u10))
    for slots_in, slots_out, (js, ts) in ((10, 16, (s10, u10)), (64, 64, (s64, u64))):
        cases[f"transformer-s{slots_out}"] = (
            lambda p, s, si=slots_in: jatt.transformer_apply_flat(p, s, si, E, None, impl="xla"),
            (jatt.transformer_init(KEY, slots_in, slots_out, E, False), js),
            lambda m, s: m(s, E, impl="plain"),
            (Transformer(slots_in, slots_out, E, False, _gen()), ts))
    cases["linear-3d"] = (
        lambda p, s: jlin.elastic_linear3d_apply_flat(p, s, 10, E, "relu", None),
        (jlin.elastic_linear3d_init(KEY, 10, 7, False), s10),
        lambda m, s: m(s, E, "relu"), (ElasticLinear3D(10, 7, False, _gen()), u10))
    cases["fm"] = (
        lambda p, s: jint.fm3d_apply_flat(p, s, 10, E, None),
        (jint.fm3d_init(KEY, E, 24, False), s10),
        lambda m, s: m(s, 10, E), (FM3D(E, 24, False, _gen()), u10))
    cases["sum"] = (
        lambda p, a, b: jint.sum_apply(p, a, b, None),
        (jint.sum_init(KEY, 40, 24, 32, False), d40, d24),
        lambda m, a, b: m(a, b), (Sum(40, 24, 32, False, _gen()), t40, t24))
    cases["gating"] = (
        lambda p, a, b: jint.sigmoid_gating_apply(p, a, b, None),
        (jint.sigmoid_gating_init(KEY, 40, 24, 32, False), d40, d24),
        lambda m, a, b: m(a, b), (SigmoidGating(40, 24, 32, False, _gen()), t40, t24))
    cases["final"] = (
        jcommon.linear_apply, (jcommon.linear_init(KEY, 40, 1), d40),
        lambda m, x: m(x), (Linear(40, 1, True, _gen()), t40))
    return cases


NODES = ("linear", "dot-product", "transformer-s16", "transformer-s64", "linear-3d", "fm",
         "sum", "gating", "final")


@pytest.mark.parametrize("node", NODES)
def test_dot_flops_of_a_node_equals_jax(node):
    jfn, jargs, tfn, targs = _node_cases()[node]
    want = jprof.dot_flops(jfn, *jargs)
    assert want > 0
    assert profiling.dot_flops(tfn, *targs) == want


def test_fm_counts_its_backward_as_the_jax_gradient_does():
    """The FM's slot sums are no product here; its report covers the JAX
    package's two products forward and their two input gradients backward."""
    s10, u10 = _pair((B, 10 * E))
    jp = jint.fm3d_init(KEY, E, E, False)            # feat == out: no projection
    grad = jax.grad(lambda s: jint.fm3d_apply_flat(jp, s, 10, E, None).sum())
    model = FM3D(E, E, False, _gen())

    def fwd_bwd(s):
        s = s.clone().requires_grad_(True)
        model(s, 10, E).sum().backward()

    assert profiling.dot_flops(fwd_bwd, u10) == jprof.dot_flops(grad, s10) == \
        2 * jprof.dot_flops(lambda s: jint.fm3d_apply_flat(jp, s, 10, E, None), s10)


def _fwd_bwd_count(plain, *inputs):
    def run(*xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        out = plain(*xs)
        out.backward(torch.ones_like(out))
    return profiling.dot_flops(plain, *inputs), profiling.dot_flops(run, *inputs)


@pytest.mark.parametrize("batch,n", [(32, 9), (7, 46)])
def test_dot_product_kernel_reports_its_plain_versions_count(batch, n):
    x, yt = torch.randn(batch, E), torch.randn(batch, E, n - 1)
    fwd, both = _fwd_bwd_count(dotprod.dot_scores_tril_plain, x, yt)
    assert fwd == dotprod.matmul_flops(batch, n)
    assert both == 3 * dotprod.matmul_flops(batch, n)


@pytest.mark.parametrize("batch,slots", [(32, 16), (5, 64)])
def test_attention_kernel_reports_its_plain_versions_count(batch, slots):
    qkv = torch.randn(batch, slots, 3 * E)
    fwd, both = _fwd_bwd_count(attention.tiny_head_attention_plain, qkv)
    assert fwd == attention.matmul_flops(batch, slots)
    assert both == 3 * attention.matmul_flops(batch, slots)


@pytest.mark.parametrize("batch,slots", [(32, 16), (5, 64)])
def test_body_kernel_reports_its_plain_versions_count(batch, slots):
    node = Transformer(slots, slots, E, False, _gen())
    params = [p.detach() for p in node.body_params()]

    def plain(x, *ps):
        return transformer_body.transformer_body_plain(x, ps)

    fwd, both = _fwd_bwd_count(plain, torch.randn(batch, slots, E), *params)
    assert fwd == transformer_body.matmul_flops(batch, slots)
    assert both == 3 * transformer_body.matmul_flops(batch, slots)


def test_kernel_reports_reach_only_open_counts():
    profiling.report_matmul_flops(10 ** 9)        # no count open: dropped
    inner = []

    def nested():
        profiling.report_matmul_flops(5)
        inner.append(profiling.dot_flops(profiling.report_matmul_flops, 7))

    assert not profiling.counting()
    assert profiling.dot_flops(nested) == 12 and inner == [7]
    assert not profiling.counting()


def test_dot_flops_counts_a_backward_as_the_jax_package_does():
    """A two-layer MLP: forward and the gradients of both weights, not of the
    input (tests/test_misc.py holds the JAX count to the same)."""
    w1, w2 = torch.ones(128, 256, requires_grad=True), torch.ones(256, 32, requires_grad=True)
    x = torch.ones(64, 128)
    fwd = 2 * 64 * 128 * 256 + 2 * 64 * 256 * 32
    assert profiling.dot_flops(lambda: torch.tanh(x @ w1) @ w2) == fwd
    assert profiling.dot_flops(lambda: (torch.tanh(x @ w1) @ w2).sum().backward()) == \
        3 * fwd - 2 * 64 * 128 * 256


# --------------------------------------------------------------------------
# dot_flops per plan
# --------------------------------------------------------------------------

PLAN_BATCH = 512


def _choices():
    tok = JaxTokenizer(7, JAX_OPS["xlarge"], seed=0)
    out = {"xlarge-best": ("xlarge", 7, jax_best_arch("criteo-kaggle", "xlarge")),
           "autoctr-best": ("autoctr", 7, jax_best_arch("criteo-kaggle", "autoctr"))}
    for i in range(8):
        out[f"seed0-{i}"] = ("xlarge", 7, tok.generate_random_choice())
    return out


CHOICES = _choices()


def _jax_count(space, blocks, choice, live) -> tuple:
    """(raw, dce, live-dce): the JAX dot_flops of fixed_apply's jaxpr as
    traced, after dead-code elimination, and after elimination with every
    output of the blocks in `live` kept (the port's liveness)."""
    plan = jfixed.build_fixed_plan(choice, JAX_OPS[space], blocks, SPEC.num_dense,
                                   SPEC.num_sparse, VOCAB)
    params = jfixed.fixed_init(KEY, plan)
    dense = jnp.zeros((PLAN_BATCH, SPEC.num_dense))
    cat = jnp.zeros((PLAN_BATCH, SPEC.num_sparse), jnp.int32)
    raw = jax.make_jaxpr(lambda p, d, c: jfixed.fixed_apply(plan, p, d, c))(params, dense, cat)
    dce, _ = dce_jaxpr(raw.jaxpr, [True])

    outs = []
    make_block = jfixed._make_block_fn

    def keeping(plan_, i, bp):
        block = make_block(plan_, i, bp)

        def run(*args):
            dense_out, sparse_out = block(*args)
            if live[i]:
                outs.extend([dense_out, sparse_out])
            return dense_out, sparse_out
        return run

    def forward_and_live_outputs(p, d, c):
        outs.clear()
        return jfixed.fixed_apply(plan, p, d, c), list(outs)

    jfixed._make_block_fn = keeping
    try:
        kept = jax.make_jaxpr(forward_and_live_outputs)(params, dense, cat)
    finally:
        jfixed._make_block_fn = make_block
    kept_dce, _ = dce_jaxpr(kept.jaxpr, [True] * len(kept.jaxpr.outvars))
    count = jprof._dot_flops_of_jaxpr
    return count(raw.jaxpr), count(dce), count(kept_dce)


def _counts(name) -> tuple:
    """(port, JAX raw, JAX after DCE, JAX after DCE with the port's liveness)
    of a plan's forward at batch 512."""
    space, blocks, choice = CHOICES[name]
    plan = tfixed.build_fixed_plan(choice, OPS_CONFIG_LIB[space], blocks, SPEC.num_dense,
                                   SPEC.num_sparse, VOCAB)
    meta = torch.device("meta")
    model = tfixed.fixed_init(plan, 0, meta)
    dense = torch.zeros(PLAN_BATCH, SPEC.num_dense, device=meta)
    cat = torch.zeros(PLAN_BATCH, SPEC.num_sparse, dtype=torch.int32, device=meta)
    got = profiling.dot_flops(lambda m, d, c: tfixed.fixed_apply(m, d, c, impl="plain"),
                              model, dense, cat)
    return (got,) + _jax_count(space, blocks, choice, tfixed.live_blocks(plan))


@pytest.mark.parametrize("name", sorted(CHOICES))
def test_dot_flops_of_a_plan_equals_the_jax_count_with_the_ports_liveness(name):
    got, raw, dce, live_dce = _counts(name)
    assert got == live_dce
    # The port computes no dead block, and never less than XLA would run.
    assert dce <= got <= raw


def test_the_jax_count_charges_the_dead_blocks_of_xlarge():
    """A fault of the JAX package (ROADMAP.md, Queue C): its cost model
    traces without dead-code elimination, so the three blocks of the xlarge
    best arch that nothing reads are counted; the port counts what runs."""
    assert _counts("xlarge-best") == (1_524_999_168, 3_288_130_560, 1_524_999_168,
                                      1_524_999_168)


# --------------------------------------------------------------------------
# tensor_bytes and the cost model: the ranking
# --------------------------------------------------------------------------

CALIB = {"matmul_flops_per_s": 4.0e14, "copy_bytes_per_s": 2.5e12}


def _spearman(a, b):
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1])


def test_cost_model_ranks_candidates_as_the_jax_package_does():
    """18 candidates (the two best arches and 16 Tokenizer draws of seed 1),
    at batch 512 with 1000 rows a slot, one calibration for both packages.
    The port's estimate over the JAX package's ran from 0.349 to 0.696 on
    these, Spearman 0.953 (the JAX count charges dead blocks and counts the
    output of each jaxpr equation, reshapes and transposes included, where
    the port counts one aten op's output and none of a view); the ranks must
    agree to a Spearman correlation of 0.9 or more."""
    tok = JaxTokenizer(7, JAX_OPS["xlarge"], seed=1)
    cases = [CHOICES["xlarge-best"], CHOICES["autoctr-best"]] + [
        ("xlarge", 7, tok.generate_random_choice()) for _ in range(16)]
    meta = torch.device("meta")
    dense_t = torch.zeros(PLAN_BATCH, SPEC.num_dense, device=meta)
    cat_t = torch.zeros(PLAN_BATCH, SPEC.num_sparse, dtype=torch.int32, device=meta)
    dense_j = jnp.zeros((PLAN_BATCH, SPEC.num_dense))
    cat_j = jnp.zeros((PLAN_BATCH, SPEC.num_sparse), jnp.int32)
    ours, theirs = [], []
    for space, blocks, choice in cases:
        plan = tfixed.build_fixed_plan(choice, OPS_CONFIG_LIB[space], blocks, SPEC.num_dense,
                                       SPEC.num_sparse, VOCAB)
        ours.append(profiling.estimate_latency_cost_model(
            lambda m, d, c: tfixed.fixed_apply(m, d, c, impl="plain"),
            (tfixed.fixed_init(plan, 0, meta), dense_t, cat_t), CALIB))
        jplan = jfixed.build_fixed_plan(choice, JAX_OPS[space], blocks, SPEC.num_dense,
                                        SPEC.num_sparse, VOCAB)
        theirs.append(jprof.estimate_latency_cost_model(
            lambda p, d, c, pl=jplan: jfixed.fixed_apply(pl, p, d, c),
            (jfixed.fixed_init(KEY, jplan), dense_j, cat_j), CALIB))
    assert np.all(np.isfinite(ours)) and np.all(np.asarray(ours) > 0)
    assert _spearman(ours, theirs) >= 0.9


def test_tensor_bytes_counts_inputs_once_and_each_output():
    w = torch.nn.Linear(8, 4, bias=False)
    x = torch.zeros(2, 8)
    # inputs: x (64 B) and the weight (128 B); outputs: mm [2, 4] (32 B) and
    # relu (32 B); the transpose of the weight is a view (0 B).
    assert profiling.tensor_bytes(lambda m, x: torch.relu(m(x)), w, x) == 64 + 128 + 32 + 32
    assert profiling.cost_analysis_of(lambda m, x: torch.relu(m(x)), w, x) == {
        "flops": 2.0 * 2 * 8 * 4, "bytes_accessed": 256.0}
    assert profiling.count_flops(lambda m, x: m(x), w, x) == 2.0 * 2 * 8 * 4


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def test_chained_rate_takes_the_slope_and_counts_its_fallbacks(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: clock[0])

    def fixed_cost_plus(per_iter):
        def run_k(k):
            clock[0] += 0.5 + per_iter * k
        return run_k

    profiling.timing_fallbacks(reset=True)
    assert profiling.chained_rate(fixed_cost_plus(0.01), 2, 10) == pytest.approx(0.01)
    assert profiling.timing_fallbacks() == 0

    def stalled_small_window(k):           # the small window always the slower
        clock[0] += 3.0 if k == 2 else 1.0

    rate = profiling.chained_rate(stalled_small_window, 2, 10)
    assert rate == pytest.approx(1.0 / 10)   # the raw large-window rate
    assert profiling.timing_fallbacks(reset=True) == 1
    assert profiling.timing_fallbacks() == 0


def test_measure_latency_and_calibration_give_positive_rates_on_the_cpu():
    lin = torch.nn.Linear(32, 32)
    x = torch.randn(16, 32)
    mean, std = profiling.measure_latency(lambda m, x: m(x), (lin, x), num_warmup_steps=1,
                                          num_trials=20, num_windows=2)
    assert math.isfinite(mean) and mean > 0 and math.isfinite(std) and std >= 0
    calib = profiling.calibrate_chip(matmul_dim=64, copy_mb=1, trials=4, device="cpu")
    assert set(calib) == {"matmul_flops_per_s", "copy_bytes_per_s"}
    assert all(math.isfinite(v) and v > 0 for v in calib.values())


if __name__ == "__main__":
    # The table of ROADMAP.md's Queue A and C entries: each plan's matmul
    # FLOPs at batch 512, and what the port computes beyond the elimination
    # XLA does (nodes of a live block whose outputs nothing reads).
    print("plan\tport\tjax_raw\tjax_dce\tjax_dce_port_liveness\tport_minus_jax_dce")
    for name in sorted(CHOICES):
        got, raw, dce, live_dce = _counts(name)
        print(f"{name}\t{got}\t{raw}\t{dce}\t{live_dce}\t{got - dce}")
