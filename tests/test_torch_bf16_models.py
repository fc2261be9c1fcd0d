"""bf16 compute in the port against the JAX package: the operators, the
fixed and supernet forwards, and the fixed-subnet and supernet workloads,
with `compute_dtype` bfloat16 on both sides from the same float32 weights
and the same inputs.  The JAX side runs attention_impl="pallas" (its kernels
in interpret mode on the CPU), whose body and dot-product compute in f32 and
round once, as the port's kernels and their plain versions do.

The rule under test is the JAX package's: parameters, gradients, table and
optimizer state stay float32, activations are bf16, LayerNorm statistics and
the attention softmax are f32, the logits f32.  The two frameworks round at
other places inside an op (a bf16 linear rounds its product and then its
bias add in JAX, once in PyTorch), so a value one op deep can differ by a bf16
ulp (2^-8 relative), and the difference grows through the ops after it.
Tolerances, each a few bf16 ulps at the depth it is taken:
  - one op (Linear, LayerNorm): 2 ulps relative (rtol 2^-7);
  - a node (DotProduct with its projections, FM3D, the transformer node):
    rtol 2e-2 and atol 2e-2 of the output's largest magnitude; the float32
    parameter gradients 4e-2 of the largest element, the bf16 input
    gradients 4e-2 of theirs;
  - seven blocks and the head (logits): atol 5e-2 of the largest logit;
  - three train steps: losses within rtol 2e-2, AUROC and accuracy within
    2e-2.
The transformer node's slot-projection bias gradient is held to the JAX
package's float32 gradient instead: JAX reduces the bias's cotangent over the
batch and features (2048 values here) in bf16, 0.25 from its f32 value where
the largest element is 2.06, while PyTorch reduces it with f32 sums and
rounds once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu import workloads as jax_workloads
from nasrec_tpu import choices as jax_choices
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.configs import get_best_arch as jax_best_arch
from nasrec_tpu.models import build_fixed_plan as jax_build_plan
from nasrec_tpu.models import fixed_apply as jax_fixed_apply
from nasrec_tpu.models import fixed_init as jax_fixed_init
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_apply as jax_supernet_apply
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.ops import common as jcommon
from nasrec_tpu.ops import interactions as jint
from nasrec_tpu.ops.attention import transformer_apply_flat, transformer_init

from nasrec_tpu_torch import choices, workloads
from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.configs import get_best_arch
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_apply, fixed_init
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_apply, supernet_init
from nasrec_tpu_torch.models.transplant import from_jax_params, state_dict_from_jax
from nasrec_tpu_torch.ops.attention import Transformer
from nasrec_tpu_torch.ops.common import LayerNorm, Linear
from nasrec_tpu_torch.ops.interactions import FM3D, DotProduct
from nasrec_tpu_torch.train.optim import slot_dicts

torch.set_num_threads(2)

E = 16
BF = torch.bfloat16


def _gen():
    return torch.Generator().manual_seed(0)


def _bf16_input(rng, *shape, scale=1.0):
    """A bf16-exact numpy array, so both sides see the same input."""
    return np.asarray(jnp.asarray(scale * rng.randn(*shape), jnp.bfloat16).astype(jnp.float32))


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1e-6), err_msg=what)


def _check_node(jparams, jfn, module, tfn, inputs, fwd_rel=2e-2, grad_rel=4e-2, seed=0,
                against_f32=()):
    """Outputs in bf16 and the gradients of sum(out * co): bf16 input
    gradients, float32 parameter gradients; the parameters in `against_f32`
    against the JAX function's float32 gradients (see the module docstring)."""
    rng = np.random.RandomState(seed)
    jparams = jax.device_get(jparams)
    module.load_state_dict(state_dict_from_jax(jparams))
    jx = [jnp.asarray(x, jnp.bfloat16) for x in inputs]
    out_j = jfn(jparams, *jx)
    assert out_j.dtype == jnp.bfloat16
    co = _bf16_input(rng, *out_j.shape)
    g_j = jax.grad(lambda p, *xs: jnp.sum(jfn(p, *xs).astype(jnp.float32) * co),
                   argnums=tuple(range(len(inputs) + 1)))(jparams, *jx)

    xs = [torch.tensor(x).to(BF).requires_grad_(True) for x in inputs]
    out_t = tfn(module, *xs)
    assert out_t.dtype == BF
    _close(out_t.detach().float().numpy(), np.asarray(out_j, np.float32), fwd_rel, "out")
    (out_t.float() * torch.from_numpy(co)).sum().backward()
    for x, gx in zip(xs, g_j[1:]):
        assert x.grad.dtype == BF
        _close(x.grad.float().numpy(), np.asarray(gx, np.float32), grad_rel, "input grad")
    want = state_dict_from_jax(jax.device_get(g_j[0]))
    if against_f32:
        g32 = jax.grad(lambda p, *xs: jnp.sum(jfn(p, *xs) * co))(
            jparams, *[jnp.asarray(x) for x in inputs])
        want.update({n: t for n, t in state_dict_from_jax(jax.device_get(g32)).items()
                     if n in against_f32})
    for n, p in module.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n
        _close(p.grad.numpy(), want[n].numpy(), grad_rel, n)


def test_linear_and_layernorm_in_bf16():
    rng = np.random.RandomState(0)
    x = _bf16_input(rng, 12, 24)
    lin = Linear(24, 40, True, _gen())
    jp = jcommon.linear_init(jax.random.PRNGKey(0), 24, 40)
    jp = {"w": np.asarray(jp["w"]), "b": rng.randn(40).astype(np.float32)}
    lin.load_state_dict({"weight": torch.from_numpy(jp["w"].T.copy()),
                         "bias": torch.from_numpy(jp["b"])})
    y = lin(torch.from_numpy(x).to(BF)).detach()
    want = jcommon.linear_apply(jp, jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want.astype(jnp.float32)).max()))

    ln = LayerNorm(40, init=0.17)
    scale, bias = (0.17 + 0.1 * rng.randn(40)).astype(np.float32), rng.randn(40).astype(np.float32)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    z = ln(y).detach()
    want = jcommon.ln_apply({"scale": scale, "bias": bias}, jnp.asarray(y.float().numpy(),
                                                                         jnp.bfloat16))
    assert z.dtype == BF and ln.weight.dtype == torch.float32
    np.testing.assert_allclose(z.float().numpy(), np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want.astype(jnp.float32)).max()))


@pytest.mark.parametrize("dense_in,slots,out_dim,use_ln", [(32, 20, 64, False),
                                                          (32, 20, 64, True)])
def test_dot_product_node_in_bf16(dense_in, slots, out_dim, use_ln):
    rng = np.random.RandomState(4)
    b = 128                  # the JAX Pallas dot-product's lane tile
    jp = jint.dot_product_init(jax.random.PRNGKey(1), dense_in, slots, out_dim, E, use_ln)
    _check_node(jp, lambda p, d, s: jint.dot_product_apply_flat(p, d, s, slots, E,
                                                                impl="pallas"),
                DotProduct(dense_in, slots, out_dim, E, use_ln, _gen()),
                lambda m, d, s: m(d, s, slots, E),
                [_bf16_input(rng, b, dense_in), _bf16_input(rng, b, slots * E)])


def test_fm3d_in_bf16():
    rng = np.random.RandomState(3)
    slots = 9
    jp = jint.fm3d_init(jax.random.PRNGKey(0), E, 48, False)
    _check_node(jp, lambda p, x: jint.fm3d_apply_flat(p, x, slots, E),
                FM3D(E, 48, False, _gen()), lambda m, x: m(x, slots, E),
                [_bf16_input(rng, 12, slots * E, scale=0.5)])


@pytest.mark.parametrize("use_ln", [False, True])
def test_transformer_node_in_bf16(use_ln):
    in_slots, out_slots, b = 26, 32, 128
    rng = np.random.RandomState(7)
    jp = jax.device_get(transformer_init(jax.random.PRNGKey(11), in_slots, out_slots, E, use_ln))
    node = Transformer(in_slots, out_slots, E, use_ln, _gen())
    _check_node(jp, lambda p, x: transformer_apply_flat(p, x, in_slots, E, None, 8, "pallas"),
                node, lambda m, x: m(x, E), [_bf16_input(rng, b, in_slots * E)],
                against_f32=("proj.bias",))


def _logit_check(got, want):
    assert got.dtype == torch.float32
    want = np.asarray(want)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=5e-2 * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("space", ["xlarge", "autoctr"])
def test_fixed_apply_in_bf16_matches_jax(space):
    spec = DATASETS["criteo-kaggle"]
    vocab = tuple(min(v, 40) for v in spec.raw_vocab_sizes)
    jplan = jax_build_plan(jax_best_arch("criteo-kaggle", space), JAX_OPS[space], 7, 13, 26,
                           vocab, attention_impl="pallas")
    tplan = build_fixed_plan(get_best_arch("criteo-kaggle", space), OPS_CONFIG_LIB[space], 7,
                             13, 26, vocab)
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(1), jplan))
    model = fixed_init(tplan, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tplan))
    rng = np.random.RandomState(2)
    dense = rng.randn(128, 13).astype(np.float32)
    cat = np.stack([rng.randint(0, v, size=128) for v in vocab], 1).astype(np.int32)
    want = jax_fixed_apply(jplan, params, dense, cat, compute_dtype=jnp.bfloat16)
    got = fixed_apply(model, torch.from_numpy(dense), torch.from_numpy(cat),
                      compute_dtype=BF)
    _logit_check(got, want)
    # The body of the model ran in bf16: a float32 run differs.
    f32 = fixed_apply(model, torch.from_numpy(dense), torch.from_numpy(cat))
    assert not torch.equal(f32, got)


def test_supernet_apply_in_bf16_matches_jax():
    vocab = (40,) * 26
    kw = dict(num_blocks=2, num_dense=13, num_sparse=26, vocab_sizes=vocab, use_layernorm=True)
    jcfg = JaxSuperNetConfig(space=JAX_OPS["xlarge"], attention_impl="pallas", **kw)
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], **kw)
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(5), jcfg))
    model = supernet_init(tcfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    rng = np.random.RandomState(3)
    dense = rng.randn(128, 13).astype(np.float32)
    cat = rng.randint(0, 40, size=(128, 26)).astype(np.int32)
    choice = jax_choices.full_path_choice(JAX_OPS["xlarge"], 2)
    want = jax_supernet_apply(jcfg, params, dense, cat,
                              jax_choices.choice_to_masks(choice, JAX_OPS["xlarge"], 2),
                              compute_dtype=jnp.bfloat16)
    got = supernet_apply(model, torch.from_numpy(dense), torch.from_numpy(cat),
                         choices.choice_to_masks(choice, OPS_CONFIG_LIB["xlarge"], 2),
                         compute_dtype=BF)
    _logit_check(got, want)


def _data(pkg):
    return pkg.DataOptions(data_source="synthetic", train_batch_size=128, test_batch_size=128,
                           synthetic_vocab=50, synthetic_train_examples=1024,
                           synthetic_test_examples=256)


def _train(pkg, **kw):
    return pkg.TrainOptions(max_train_steps=3, display_interval=1, test_interval=2,
                            compute_dtype="bfloat16", learning_rate=0.02, **kw)


def _assert_logs_close(got, want):
    assert len(got["train_loss"]) == 3 and len(got["test_loss"]) == 2
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-2, err_msg=key)
    for key in ("test_AUROC", "test_Accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-2, err_msg=key)


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_train_fixed_subnet_in_bf16_matches_jax(monkeypatch, optimizer):
    payload = {**jax_best_arch("criteo-kaggle", "autoctr"), "config": "autoctr"}
    jplan = jax_build_plan(payload, JAX_OPS["autoctr"], 7, 13, 26, (50,) * 26,
                           attention_impl="pallas")
    params = jax.device_get(jax_fixed_init(jax.random.PRNGKey(0), jplan))

    def from_jax_init(plan, seed, device):
        model = real_init(plan, seed, device)
        model.load_state_dict(from_jax_params(params, plan))
        return model

    real_init = workloads.fixed_init
    monkeypatch.setattr(workloads, "fixed_init", from_jax_init)
    kw = dict(optimizer=optimizer, learning_rate=0.02 if optimizer == "adagrad" else 1e-3)
    want = jax_workloads.train_fixed_subnet(
        payload, _data(jax_workloads),
        jax_workloads.TrainOptions(max_train_steps=3, display_interval=1, test_interval=2,
                                   compute_dtype="bfloat16", attention_impl="pallas", **kw),
        log_fn=lambda s: None)["logs"][0]
    got = workloads.train_fixed_subnet(
        payload, _data(workloads),
        workloads.TrainOptions(max_train_steps=3, display_interval=1, test_interval=2,
                               compute_dtype="bf16", device="cpu", **kw),
        log_fn=lambda s: None)
    model = got["state"].model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for slot in slot_dicts(got["state"].opt_state)
               for t in slot.values())
    _assert_logs_close(got["logs"][0], want)


def test_train_supernet_in_bf16_matches_jax(monkeypatch):
    sn = dict(config="autoctr", num_blocks=2, supernet_training_steps=0)
    jcfg = JaxSuperNetConfig(space=JAX_OPS["autoctr"], num_blocks=2, num_dense=13, num_sparse=26,
                             vocab_sizes=(50,) * 26, use_layernorm=True, attention_impl="pallas")
    params = jax.device_get(jax_supernet_init(jax.random.PRNGKey(0), jcfg))

    def from_jax_init(cfg, seed, device):
        model = real_init(cfg, seed, device)
        model.load_state_dict(from_jax_params(params, cfg))
        return model

    real_init = workloads.supernet_init
    monkeypatch.setattr(workloads, "supernet_init", from_jax_init)
    want = jax_workloads.train_supernet(
        jax_workloads.SupernetOptions(**sn), _data(jax_workloads),
        jax_workloads.TrainOptions(max_train_steps=3, display_interval=1, test_interval=2,
                                   max_eval_steps=1, compute_dtype="bfloat16",
                                   attention_impl="pallas", learning_rate=0.02),
        log_fn=lambda s: None)["logs"][0]
    seen = []
    real_step = workloads.make_sparse_embedding_train_step

    def spy_step(*args, **kwargs):
        seen.append(kwargs["compute_dtype"])
        return real_step(*args, **kwargs)

    monkeypatch.setattr(workloads, "make_sparse_embedding_train_step", spy_step)
    got = workloads.train_supernet(
        workloads.SupernetOptions(**sn), _data(workloads),
        workloads.TrainOptions(max_train_steps=3, display_interval=1, test_interval=2,
                               max_eval_steps=1, compute_dtype="bfloat16", device="cpu",
                               learning_rate=0.02),
        log_fn=lambda s: None)
    assert seen == [BF]
    assert all(p.dtype == torch.float32 for p in got["state"].model.parameters())
    _assert_logs_close(got["logs"][0], want)


@pytest.mark.parametrize("cli", ["main_train", "train_supernet", "eval_subnet_from_scratch"])
def test_clis_train_in_bf16(cli, tmp_path, monkeypatch):
    """--compute_dtype bfloat16 reaches the model: every linear and every
    transformer body runs on bf16 activations, the parameters stay float32,
    and configs_args.json records the flag."""
    import json

    from nasrec_tpu_torch.cli import eval_subnet_from_scratch, main_train, train_supernet
    from nasrec_tpu_torch.ops import attention as attention_ops
    from nasrec_tpu_torch.ops import common as common_ops

    body_dtypes, linear_dtypes = [], []
    real_body, real_linear = attention_ops.transformer_body, common_ops.linear_cast

    def spy_body(x, *args, **kwargs):
        body_dtypes.append(x.dtype)
        return real_body(x, *args, **kwargs)

    def spy_linear(x, *args):
        linear_dtypes.append(x.dtype)
        return real_linear(x, *args)

    monkeypatch.setattr(attention_ops, "transformer_body", spy_body)
    monkeypatch.setattr(common_ops, "linear_cast", spy_linear)
    common = ["--data_source", "synthetic", "--device", "cpu", "--compute_dtype", "bfloat16",
              "--max_train_steps", "2", "--max_eval_steps", "1", "--train_batch_size", "32",
              "--test_batch_size", "64", "--learning_rate", "0.02",
              "--logging_dir", str(tmp_path)]
    if cli == "main_train":
        out = main_train.main(common + ["--arch", "criteo-kaggle/xlarge"])
        state = out["state"]
    elif cli == "train_supernet":
        out = train_supernet.main(common + ["--config", "xlarge", "--num_blocks", "2",
                                            "--supernet_training_steps", "2"])
        state = out["state"]
    else:
        out = eval_subnet_from_scratch.main(common + ["--config", "xlarge", "--num_blocks", "2",
                                                      "--num_subnets", "1"])
        assert np.isfinite(out[0]["test_loss"])
        state = None
    if state is not None:
        assert state.step == 2
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        assert all(np.isfinite(out["logs"][0]["train_loss"]))
    assert linear_dtypes and set(linear_dtypes) == {BF}
    if cli != "eval_subnet_from_scratch":       # its random subnet may hold no transformer
        assert body_dtypes and set(body_dtypes) == {BF}
    with open(tmp_path / "configs_args.json") as f:
        assert json.load(f)["train"]["compute_dtype"] == "bfloat16"
