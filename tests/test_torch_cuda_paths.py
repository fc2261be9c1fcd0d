"""The port's paths on the card, kernels against plain versions: the
published best archs' sparse steps at batch 32768 (criteo-kaggle, avazu and
kdd, xlarge and autoctr; f32 and bf16; an eval forward; the xlarge archs'
transformer nodes unfused too); criteo-kaggle/xlarge at Criteo's full
vocab and batch 32768, its dense-gradient step for Adam, SGD and Adagrad
step by step against the plain step, and its sparse step with 2
micro-batches against 1; the supernet's masked steps; a whole-net search
group of 8 candidates at the search's size (whole-net and
LayerNorm-calibrate, as one K-candidate program and one candidate at a
time), and a final-only group's pruned body against the masked forward at
the same size; the CLIs
(main_train on synthetic data and on TSV shards, with --report_flops and
--profile_dir; train_supernet resumed from its checkpoint, and in bf16; the
search CLI with --method random and cached and with the latency criterion
once per estimator; eval_subnet_from_scratch); the committed proxy
supernet's ranking of its candidates; and the search fanned out over two
processes on the one card.  Each path's launches are counted a step and
held to what its model's nodes launch: `_fixed_shapes` reads a FixedModel's
live blocks, `_supernet_shapes` a supernet's config.

The kernels alone, at edge shapes and at the main paths' shapes, are
tests/test_torch_cuda.py.  Both files run on the card without
tests/conftest.py (which imports JAX), and without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py \\
        tests/test_torch_cuda_paths.py

Tolerances.  f32 steps from the same weights: losses within 1e-4, the last
step's logits within 1e-3 and every parameter within 1e-4 (absolute), an
eval forward's logits within 1e-3.  bf16 (activations in bf16, parameters,
table, optimizer state and logits f32): each step of the plain path starts
from the kernel path's state before it (`_lockstep`: a bf16 rounding that
lands the other way in one step moves the next step's inputs by an ulp), the
loss within 1e-3 of itself, logits within 2^-5 of the largest logit (or 1),
parameters within 1e-4, optimizer slots within 2^-6 of their largest element
(or 1).  The unfused transformer nodes against the fused ones over the first
steps: losses within 1e-4 (f32), within 2e-2 of the loss (bf16, rounded
after every op in the unfused form, once in the fused one).
"""

import copy
import math
import pickle
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_cuda import _launched, _launches, _max_diff, dev  # noqa: F401  (dev: the fixture)

pytestmark = pytest.mark.cuda

PROXY_DIR = Path(__file__).resolve().parents[1] / "experiments" / "search_quality_proxy"
BATCH = 32768
VOCAB_CAP = 100_000            # rows a slot: full vocab is xlarge.uniform's gate
STEPS, UNFUSED_STEPS = 3, 2
ARCHS = [f"{d}/{s}" for d in ("criteo-kaggle", "avazu", "kdd") for s in ("xlarge", "autoctr")]
DTYPES = [torch.float32, torch.bfloat16]
# The supernet and the search at their canonical sizes: 7 blocks, batch 512,
# eval batch 4096; groups of 8, test batch 8192 in eval chunks of 1024.
SN_BLOCKS, SN_BATCH, SN_EVAL_BATCH, SN_STEPS = 7, 512, 4096, 12
GROUP, TEST_BATCH, CHUNK = 8, 8192, 1024
SN_CLI = ["--data_source", "synthetic", "--device", "cuda", "--config", "xlarge",
          "--num_blocks", str(SN_BLOCKS), "--use_layernorm", "1",
          "--train_batch_size", str(SN_BATCH), "--test_batch_size", str(SN_EVAL_BATCH),
          "--max_eval_steps", "1", "--display_interval", "1",
          "--supernet_training_steps", "4", "--learning_rate", "0.02"]
SEARCH_CLI = ["--data_source", "synthetic", "--device", "cuda", "--max_train_steps", "5",
              "--max_eval_steps", "1", "--train_batch_size", str(SN_BATCH)]


def _fixed_shapes(model):
    """(S of each transformer body, n of each dot product) in the live blocks
    of a FixedModel: its forward's kernel shapes."""
    from nasrec_tpu_torch.ops.attention import Transformer
    from nasrec_tpu_torch.ops.interactions import DotProduct, dot_product_slot_dim

    live = [b for b, on in zip(model.blocks, model.live) if on]
    return ([n.proj.out_features for b in live for n in b.nodes.children()
             if isinstance(n, Transformer)],
            [1 + dot_product_slot_dim(b.bp.dense_dim) for b in live for n in b.nodes.children()
             if isinstance(n, DotProduct)])


def _supernet_shapes(cfg):
    """The same for a supernet: every block runs every node whatever its
    gates, at the space's widest."""
    from nasrec_tpu_torch.ops.interactions import dot_product_slot_dim

    space, k = cfg.space, cfg.num_blocks
    n = 1 + dot_product_slot_dim(space.max_dense_dim)
    return ([space.max_sparse_dim] * k * ("transformer" in space.node_names),
            [n] * k * ("dot-product" in space.node_names))


def _expected(shapes, train, dtype=torch.float32, fused=True, times=1):
    """The launches of `times` train steps (or forwards) of a model of
    `shapes`: each dot product's and body's kernels (the attention core's in
    the unfused form), and a step's segment-sum, table update, clip and
    dense update (f32 whatever the compute dtype)."""
    bodies, dots = shapes
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    kinds = ("fwd", "bwd") if train else ("fwd",)
    out = Counter(f"dot_{k}_n{n}{sfx}" for n in dots for k in kinds)
    if fused:
        out.update(f"body_{k}_s{s}{sfx}" for s in bodies
                   for k in (("fwd_train", "bwd") if train else ("fwd",)))
    else:
        out.update(f"attn_{k}_s{s}{sfx}" for s in bodies for k in kinds)
    if train:
        out.update(("segment_sum", "table_update", "clip_scale", "adagrad"))
    return {k: v * times for k, v in out.items()}


def _best_model(arch, dev, vocab_cap=VOCAB_CAP):
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
    from nasrec_tpu_torch.configs import get_best_arch
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_init

    dataset, space = arch.split("/")
    spec = DATASETS[dataset]
    vocab = spec.vocab_sizes(vocab_cap)
    plan = build_fixed_plan(get_best_arch(dataset, space), OPS_CONFIG_LIB[space], 7,
                            spec.num_dense, spec.num_sparse, vocab)
    return fixed_init(plan, seed=0, device=dev), spec.num_dense


def _batches(dev, n, batch, vocab, num_dense, seed):
    """n batches on the card: N(0,1) dense, each slot's index uniform over
    its rows, 0/1 labels."""
    rng = np.random.RandomState(seed)
    slots = np.asarray(vocab)
    return [tuple(torch.as_tensor(a, device=dev) for a in (
        rng.randn(batch, num_dense).astype(np.float32),
        (rng.random_sample((batch, slots.size)) * slots).astype(np.int32),
        rng.randint(0, 2, size=(batch, 1)).astype(np.float32))) for _ in range(n)]


def _schedule(base_lr=0.16):
    from nasrec_tpu_torch.train.optim import make_lr_schedule

    return make_lr_schedule("cosine", base_lr, 10_000, 1_000)


def _run(step, state, batches, masks=None):
    """Each batch through `step`: (losses, last logits, each step's launches)."""
    losses, launches = [], []
    for i, batch in enumerate(batches):
        before = _launches()
        state, m = step(state, *batch, *(() if masks is None else (masks[i],)))
        launches.append(_launched(before))
        losses.append(float(m["loss"]))
    assert all(math.isfinite(x) for x in losses), losses
    return losses, m["logits"], launches


def _lockstep(step_k, state_k, step_p, state_p, batches, masks=None):
    """Each batch through the kernel path's step, and through the plain
    path's from the kernel path's state before it.  Returns each kernel
    step's launches and the largest differences (see the module docstring)."""
    from nasrec_tpu_torch.train.optim import copy_state_, slot_dicts

    out = {"launches": [], "losses": [], "loss_rel": 0.0, "logit_rel": 0.0, "param": 0.0,
           "slot": 0.0}
    for i, batch in enumerate(batches):
        extra = () if masks is None else (masks[i],)
        state_p.model.load_state_dict(state_k.model.state_dict())
        copy_state_(state_p.opt_state, state_k.opt_state)
        state_p.step = state_k.step
        before = _launches()
        state_k, mk = step_k(state_k, *batch, *extra)
        out["launches"].append(_launched(before))
        before = _launches()
        state_p, mp = step_p(state_p, *batch, *extra)
        assert not _launched(before)
        lk, lp = float(mk["loss"]), float(mp["loss"])
        assert math.isfinite(lk) and math.isfinite(lp)
        out["losses"].append(lk)
        out["loss_rel"] = max(out["loss_rel"], abs(lk - lp) / abs(lp))
        scale = max(mp["logits"].abs().max().item(), 1.0)
        out["logit_rel"] = max(out["logit_rel"],
                               (mk["logits"] - mp["logits"]).abs().max().item() / scale)
        out["param"] = max(out["param"], _max_diff(state_k.model, state_p.model))
        out["slot"] = max([out["slot"]] + [
            (a[k] - b[k]).abs().max().item() / max(b[k].abs().max().item(), 1.0)
            for a, b in zip(slot_dicts(state_k.opt_state), slot_dicts(state_p.opt_state))
            for k in a])
    assert out["loss_rel"] <= 1e-3 and out["logit_rel"] <= 2 ** -5, out
    assert out["param"] <= 1e-4 and out["slot"] <= 2 ** -6, out
    return out


def _unfused(model):
    from nasrec_tpu_torch.ops.attention import Transformer

    for node in model.modules():
        if isinstance(node, Transformer):
            node.fused = False
    return model


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_best_arch_steps_kernel_path_matches_plain(dev, arch, dtype):
    """The published best arch's sparse steps at batch 32768 through the
    kernels against the plain versions from the same weights and batches,
    every kernel of the live nodes launched once a step; an eval forward;
    for an arch with transformer nodes, the first steps again with the nodes
    unfused (the attention kernel in the body kernels' place)."""
    from nasrec_tpu_torch.train.loop import make_eval_step
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model_k, num_dense = _best_model(arch, dev)
    model_p, model_u = copy.deepcopy(model_k), copy.deepcopy(model_k)
    shapes = _fixed_shapes(model_k)
    batches = _batches(dev, STEPS, BATCH, model_k.plan.vocab_sizes, num_dense, 0)

    def make(impl):
        return make_sparse_embedding_train_step(_schedule(), grad_clip=5.0, impl=impl,
                                                compute_dtype=dtype)

    if dtype == torch.float32:
        losses_k, logits_k, launched = _run(make("auto"), init_sparse_train_state(model_k),
                                            batches)
        assert all(x == _expected(shapes, True) for x in launched)
        losses_p, logits_p, launched = _run(make("plain"), init_sparse_train_state(model_p),
                                            batches)
        assert not any(launched)
        assert max(abs(a - b) for a, b in zip(losses_k, losses_p)) <= 1e-4
        assert (logits_k - logits_p).abs().max().item() <= 1e-3
        assert _max_diff(model_k, model_p) <= 1e-4
        tol = 1e-3
    else:
        res = _lockstep(make("auto"), init_sparse_train_state(model_k), make("plain"),
                        init_sparse_train_state(model_p), batches)
        assert all(x == _expected(shapes, True, dtype) for x in res["launches"])
        assert all(p.dtype == torch.float32 for p in model_k.parameters())
        losses_k = res["losses"]
        model_p.load_state_dict(model_k.state_dict())
    before = _launches()
    eval_k = make_eval_step("auto", compute_dtype=dtype)(model_k, *batches[0][:2])
    assert _launched(before) == _expected(shapes, False, dtype)
    eval_p = make_eval_step("plain", compute_dtype=dtype)(model_p, *batches[0][:2])
    assert eval_k.dtype == torch.float32 and tuple(eval_k.shape) == (BATCH, 1)
    assert bool(torch.isfinite(eval_k).all())
    if dtype == torch.bfloat16:
        tol = 2 ** -5 * max(eval_p.abs().max().item(), 1.0)
    assert (eval_k - eval_p).abs().max().item() <= tol

    if shapes[0]:
        losses_u, _, launched = _run(make("auto"), init_sparse_train_state(_unfused(model_u)),
                                     batches[:UNFUSED_STEPS])
        assert all(x == _expected(shapes, True, dtype, fused=False) for x in launched)
        gaps = [abs(a - b) for a, b in zip(losses_u, losses_k)]
        if dtype == torch.float32:
            assert max(gaps) <= 1e-4
        else:
            assert max(g / abs(b) for g, b in zip(gaps, losses_k)) <= 2e-2


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_supernet_steps_kernel_path_matches_plain(dev, dtype):
    """One-shot supernet training over the search-capped Criteo table (7
    xlarge blocks with LayerNorm, batch 512): 12 masked steps, masks from the
    port's ChoiceSampler through the device mask buffer (4 full-path steps,
    then subnets, some with a transformer or a dot-product gate of 0), each
    launching every block's body and dot-product kernels, against the plain
    versions from the same weights; then an eval forward at batch 4096 on
    the full path."""
    from nasrec_tpu_torch.choices import choice_to_masks, full_path_choice
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB, SEARCH_MAX_NUM_EMBEDDINGS
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.sampling import ChoiceSampler, DeviceMaskBuffer
    from nasrec_tpu_torch.train.loop import make_eval_step
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    space = OPS_CONFIG_LIB["xlarge"]
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(SEARCH_MAX_NUM_EMBEDDINGS)
    cfg = SuperNetConfig(space=space, num_blocks=SN_BLOCKS, num_dense=13, num_sparse=26,
                         vocab_sizes=vocab, use_layernorm=True)
    model_k = supernet_init(cfg, seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    sampler = ChoiceSampler(space, SN_BLOCKS, strategy="default", anypath_choice="binomial-0.5",
                            supernet_training_steps=4, seed=0)
    buffer = DeviceMaskBuffer(sampler, size=SN_STEPS, device=dev)
    masks = [buffer() for _ in range(SN_STEPS)]
    act = buffer.buffer.node_act.cpu().numpy()
    full = choice_to_masks(full_path_choice(space, SN_BLOCKS), space, SN_BLOCKS)
    assert any(all(np.array_equal(a.cpu().numpy(), b)
                   for a, b in zip(buffer.buffer.select(i).astuple(), full.astuple()))
               for i in range(SN_STEPS))
    for node in ("transformer", "dot-product"):
        assert (act[:, :, space.node_names.index(node)] == 0).any(), node
    batches = _batches(dev, SN_STEPS, SN_BATCH, vocab, 13, 1)
    rng = np.random.RandomState(2)
    eval_in = (torch.as_tensor(rng.randn(SN_EVAL_BATCH, 13).astype(np.float32), device=dev),
               _batches(dev, 1, SN_EVAL_BATCH, vocab, 13, 3)[0][1], full.to(dev))
    shapes = _supernet_shapes(cfg)

    def make(impl):
        return make_sparse_embedding_train_step(_schedule(0.12), grad_clip=5.0, impl=impl,
                                                has_masks=True, compute_dtype=dtype)

    if dtype == torch.float32:
        losses_k, logits_k, launched = _run(make("auto"), init_sparse_train_state(model_k),
                                            batches, masks)
        assert all(x == _expected(shapes, True) for x in launched)
        losses_p, logits_p, launched = _run(make("plain"), init_sparse_train_state(model_p),
                                            batches, masks)
        assert not any(launched)
        assert max(abs(a - b) for a, b in zip(losses_k, losses_p)) <= 1e-4
        assert (logits_k - logits_p).abs().max().item() <= 1e-3
        assert _max_diff(model_k, model_p) <= 1e-4
    else:
        res = _lockstep(make("auto"), init_sparse_train_state(model_k), make("plain"),
                        init_sparse_train_state(model_p), batches, masks)
        assert all(x == _expected(shapes, True, dtype) for x in res["launches"])
        model_p.load_state_dict(model_k.state_dict())
    before = _launches()
    eval_k = make_eval_step("auto", has_masks=True, compute_dtype=dtype)(model_k, *eval_in)
    assert _launched(before) == _expected(shapes, False, dtype)
    eval_p = make_eval_step("plain", has_masks=True, compute_dtype=dtype)(model_p, *eval_in)
    assert eval_k.dtype == torch.float32 and bool(torch.isfinite(eval_k).all())
    tol = 1e-3 if dtype == torch.float32 else 2 ** -5 * max(eval_p.abs().max().item(), 1.0)
    assert (eval_k - eval_p).abs().max().item() <= tol


# criteo-kaggle/xlarge's dense-gradient step (the whole table a parameter)
# per (optimizer, wd, constant lr).
DENSE_SETTINGS = [("adam", 0.0, 1e-3), ("sgd", 0.0, 0.01), ("adagrad", 1e-6, 0.01)]
SPARSE_ONLY = ("segment_sum", "table_update", "clip_scale", "adagrad")


def _adam_edges(g_k, g_p, mu, nu, count, lr):
    """Elements whose Adam step, lr mu_hat / (sqrt(nu_hat) + eps), the two
    paths' gradients set more than 5e-5 apart: gradients of opposite signs,
    or the step's slope in the gradient, |d step / d g|, times the
    gradients' difference above 5e-5 (tiny gradients, where sqrt(nu_hat) +
    eps is small, make the slope steep).  mu, nu: the plain path's moments
    after the step; the gradients themselves are held through the moments."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    sv = torch.sqrt(nu / c2)
    slope = ((1.0 - b1) / c1 / (sv + eps)
             + (mu / c1).abs() * (1.0 - b2) / c2 * g_p.abs()
             / (sv.clamp(min=eps) * (sv + eps) ** 2))
    return ((g_k > 0) != (g_p > 0)) | (lr * slope * (g_k - g_p).abs() > 5e-5)


@pytest.mark.parametrize("optimizer,wd,lr", DENSE_SETTINGS)
def test_dense_step_matches_plain_at_full_vocab(dev, optimizer, wd, lr):
    """criteo-kaggle/xlarge's dense-gradient step at Criteo's full vocab and
    batch 32768: 3 steps through the kernels, each followed by the plain step
    from the kernel path's state.  A kernel step launches the body and
    dot-product kernels of the live nodes, and with Adagrad the list update;
    no segment-sum, table update or list clip (the optimizer updates the
    whole table, and the step clips with the table's norm).  Loss within
    1e-4, logits 1e-3, every parameter 1e-4 but Adam's edge elements
    (`_adam_edges`: Adam moves an element by about lr whatever its
    gradient's size, so a gradient whose sign or rounding parts the paths
    ends a step up to 2 lr apart), Adam's moments within 1e-4 of their
    largest magnitude (or 1), the other slots within 1e-4."""
    from nasrec_tpu_torch.train.loop import init_train_state, make_train_step
    from nasrec_tpu_torch.train.optim import Optimizer, copy_state_, make_optimizer, slot_dicts

    model_k, _ = _best_model("criteo-kaggle/xlarge", dev, vocab_cap=None)
    model_p = copy.deepcopy(model_k)
    batches = _batches(dev, STEPS, BATCH, model_k.plan.vocab_sizes, 13, 2)
    want = {k: v for k, v in _expected(_fixed_shapes(model_k), True).items()
            if k not in SPARSE_ONLY}
    if optimizer == "adagrad":
        want["adagrad"] = 1
    grads = {}

    def make(model, impl):
        """The step through `impl` and its state; the optimizer keeps each
        step's gradients (times the clip's scale) in grads[impl]."""
        opt = make_optimizer(optimizer)

        def update_(state, names, params, g, lr_now, scale=None, impl=impl):
            grads[impl] = dict(zip(names, g if scale is None else [x * scale for x in g]))
            opt.update_(state, names, params, g, lr_now, scale, impl)

        step = make_train_step(Optimizer(opt.init, update_), lambda s: lr, l2_reg=wd,
                               grad_clip=5.0, impl=impl)
        return step, init_train_state(model, opt)

    (step_k, state_k), (step_p, state_p) = make(model_k, "auto"), make(model_p, "plain")
    adam = optimizer == "adam"
    for batch in batches:
        with torch.no_grad():
            for pk, pp in zip(model_k.parameters(), model_p.parameters()):
                pp.copy_(pk)
        copy_state_(state_p.opt_state, state_k.opt_state)
        before = _launches()
        state_k, mk = step_k(state_k, *batch)
        assert _launched(before) == want
        before = _launches()
        state_p, mp = step_p(state_p, *batch)
        assert not _launched(before)
        assert abs(float(mk["loss"]) - float(mp["loss"])) <= 1e-4
        assert (mk["logits"] - mp["logits"]).abs().max().item() <= 1e-3
        slots_k, slots_p = slot_dicts(state_k.opt_state), slot_dicts(state_p.opt_state)
        for (name, pk), pp in zip(model_k.named_parameters(), model_p.parameters()):
            d = (pk - pp).detach().abs()
            if adam:
                d[_adam_edges(grads["auto"][name], grads["plain"][name], slots_p[0][name],
                              slots_p[1][name], int(state_p.opt_state.count), lr)] = 0.0
            assert d.max().item() <= 1e-4, name
            for sk, sp in zip(slots_k, slots_p):
                scale = max(1.0, sp[name].abs().max().item()) if adam else 1.0
                assert (sk[name] - sp[name]).abs().max().item() <= 1e-4 * scale, name
    assert not adam or int(state_k.opt_state.count) == STEPS


def test_micro_batched_step_matches_one_slice_at_full_vocab(dev):
    """criteo-kaggle/xlarge's sparse step at Criteo's full vocab and batch
    32768 with 2 micro-batches against 1, 2 steps from the same weights: each
    slice launches the body and dot-product kernels, the step one segment-sum,
    table update, clip and dense update; losses within 1e-4, the last
    logits 1e-3, parameters and accumulators 1e-4."""
    from nasrec_tpu_torch.train.optim import slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    model_1, _ = _best_model("criteo-kaggle/xlarge", dev, vocab_cap=None)
    model_2 = copy.deepcopy(model_1)
    step_launches = _expected(_fixed_shapes(model_1), True)
    batches = _batches(dev, 2, BATCH, model_1.plan.vocab_sizes, 13, 3)
    out = []
    for model, micro in ((model_1, 1), (model_2, 2)):
        state = init_sparse_train_state(model)
        step = make_sparse_embedding_train_step(_schedule(), grad_clip=5.0, microbatch=micro)
        losses, logits, launched = _run(step, state, batches)
        want = {k: v * (1 if k in SPARSE_ONLY else micro) for k, v in step_launches.items()}
        assert all(x == want for x in launched)
        out.append((losses, logits, slot_dicts(state.opt_state)[0]))
    (l1, g1, a1), (l2, g2, a2) = out
    assert max(abs(a - b) for a, b in zip(l1, l2)) <= 1e-4
    assert (g1 - g2).abs().max().item() <= 1e-3
    assert _max_diff(model_1, model_2) <= 1e-4
    assert max((a1[k] - a2[k]).abs().max().item() for k in a1) <= 1e-4


def _k_form(launches, k):
    """A step's or forward's launches as one K-candidate program: the body's
    under its K-candidate names; the dense update is the group's own loop."""
    return {(f"{n}_k{k}" if n.startswith("body_") else n): v for n, v in launches.items()
            if n not in ("clip_scale", "adagrad")}


@pytest.mark.parametrize("mode", ["whole", "layernorm-calibrate"])
def test_whole_net_search_group_at_the_search_size(dev, mode):
    """A group of 8 candidates of the 7-block xlarge supernet (LayerNorm)
    over the search-capped Criteo table, fine-tuned at batch 512 (lr 0.04)
    and scored on a test batch of 8192 in eval chunks of 1024, as one
    K-candidate program: over 3 steps each step launches the K-candidate
    body's kernels and the dot-product kernels once a block for the group,
    and in the whole-net mode one segment-sum and one table update over the
    8 stacked tables (the LayerNorm-calibrate mode leaves the table frozen);
    every score is finite.  LayerNorm-calibrate: the 3 steps' test losses
    within 1e-4 of the plain path's.  Whole-net: also one candidate at a
    time, each step a supernet step's launches; after one step the test
    losses of the two forms, each through the kernels and the plain
    versions, within 1e-4 of each other.  (From the untrained supernet the
    whole-net fine-tune diverges, test losses 4 to 14 after 3 steps, and
    routes that round apart then part by up to 9.3e-3 on the H100, two
    plain routes by up to 8.7e-4.)"""
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB, SEARCH_MAX_NUM_EMBEDDINGS
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.search import Tokenizer, make_candidate_evaluator

    space = OPS_CONFIG_LIB["xlarge"]
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(SEARCH_MAX_NUM_EMBEDDINGS)
    cfg = SuperNetConfig(space=space, num_blocks=SN_BLOCKS, num_dense=13, num_sparse=26,
                         vocab_sizes=vocab, use_layernorm=True)
    model = supernet_init(cfg, seed=0, device=dev)
    tok = Tokenizer(SN_BLOCKS, space, seed=0)
    picks = [tok.generate_random_choice() for _ in range(GROUP)]
    train = _batches(dev, 3, SN_BATCH, vocab, 13, 4)
    test = _batches(dev, 1, TEST_BATCH, vocab, 13, 5)

    def run(batched, impl, steps):
        before = _launches()
        res = make_candidate_evaluator(
            cfg, model, learning_rate=0.04, max_train_steps=steps, max_eval_steps=1,
            eval_batch_chunk=CHUNK, finetune_mode=mode, batch_candidates=batched, impl=impl)(
            picks, lambda: iter(train), lambda: iter(test))
        assert all(math.isfinite(r["test_loss"]) and r["test_loss"] < 999 for r in res)
        return [r["test_loss"] for r in res], _launched(before)

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    shapes, chunks = _supernet_shapes(cfg), TEST_BATCH // CHUNK
    step, forward = _expected(shapes, True), _expected(shapes, False)
    if mode != "whole":
        step = {k: v for k, v in step.items() if k not in ("segment_sum", "table_update")}
    want = Counter({k: 3 * v for k, v in _k_form(step, GROUP).items()})
    want.update({k: chunks * v for k, v in _k_form(forward, GROUP).items()})
    losses, launched = run(True, "auto", 3)
    assert launched == dict(want)
    if mode != "whole":
        plain, launched = run(True, "plain", 3)
        assert not launched and gap(losses, plain) <= 1e-4
        return
    want = Counter({k: 3 * GROUP * v for k, v in step.items()})
    want.update({k: chunks * GROUP * v for k, v in forward.items()})
    assert run(False, "auto", 3)[1] == dict(want)
    (batched, _), (one, _) = run(True, "auto", 1), run(False, "auto", 1)
    (batched_p, launched), (one_p, launched_one) = run(True, "plain", 1), run(False, "plain", 1)
    assert not launched and not launched_one
    assert gap(batched, batched_p) <= 1e-4 and gap(one, one_p) <= 1e-4
    assert gap(batched, one) <= 1e-4 and gap(batched_p, one_p) <= 1e-4


def test_pruned_final_only_group_at_the_search_size(dev):
    """The final-only group's pruned body (search/pruned_body.py) against
    the masked forward, vmap(head_features_embedded) over the masks, at the
    supernet.search cell's size: a group of 8 from the cell's sampler
    (default strategy, binomial-0.5) on the 7-block xlarge supernet over the
    search-capped Criteo table (LayerNorm, biases and LayerNorm offsets
    drawn away from 0), 3 fine-tune steps at batch 512, then a test batch of
    8192 in eval chunks of 1024: each candidate's logits within the cell's
    eval_logit_gap limit, 5e-5 of their norm, and the kernels launched alike
    on both."""
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB, SEARCH_MAX_NUM_EMBEDDINGS
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.sampling import ChoiceSampler
    from nasrec_tpu_torch.search.worker import FinalOnlyGroup
    from nasrec_tpu_torch.train.optim import make_lr_schedule

    space = OPS_CONFIG_LIB["xlarge"]
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(SEARCH_MAX_NUM_EMBEDDINGS)
    cfg = SuperNetConfig(space=space, num_blocks=SN_BLOCKS, num_dense=13, num_sparse=26,
                         vocab_sizes=vocab, use_layernorm=True)
    model = supernet_init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, device=dev, generator=gen))
    sampler = ChoiceSampler(space, SN_BLOCKS, strategy="default", anypath_choice="binomial-0.5",
                            seed=23)
    picks = [sampler() for _ in range(GROUP)]
    train = _batches(dev, 3, SN_BATCH, vocab, 13, 6)
    (dense, cat, _), = _batches(dev, 1, TEST_BATCH, vocab, 13, 7)

    def run(masked):
        group = FinalOnlyGroup(model, picks, make_lr_schedule("cosine", 0.04, 3, 0), 5.0, 1e-2,
                               "auto")
        if masked:
            def features(d, c):
                with torch.no_grad():
                    stem = model.embedding(c)
                    return torch.func.vmap(lambda m: model.head_features_embedded(
                        d, stem, m, "auto"))(group.masks)
            group.features = features
        before = _launches()
        for i, batch in enumerate(train):
            group.step(*batch, i)
        logits = torch.cat([group.logits(dense[s:s + CHUNK], cat[s:s + CHUNK])
                            for s in range(0, TEST_BATCH, CHUNK)], dim=1)
        return logits.double().cpu(), _launched(before), group.body

    got, launched, body = run(False)
    want, launched_masked, _ = run(True)
    gaps = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(got, want)]
    assert max(gaps) <= 5e-5, gaps
    assert launched == launched_masked
    assert body.macs_run < 0.15 * body.macs_masked


def _main_train(args):
    from nasrec_tpu_torch.cli import main_train

    before = _launches()
    out = main_train.main(args + ["--device", "cuda"])
    return out, _launched(before)


@pytest.mark.parametrize("space,dtype", [("autoctr", "float32"), ("xlarge", "float32"),
                                         ("xlarge", "bfloat16")])
def test_main_train_learns_the_synthetic_signal(dev, space, dtype):
    """main_train on synthetic data with a planted signal: 40 steps lower the
    test loss and lift the AUROC above 0.6, every kernel of a step launches
    at every step and the forward's at every test, in the compute dtype;
    the parameters stay f32.  (lr 0.02: at the default 0.16 a run this short
    has no warmup and diverges, in the JAX package as here.)"""
    out, launched = _main_train([
        "--arch", f"criteo-kaggle/{space}", "--data_source", "synthetic",
        "--max_train_steps", "40", "--max_eval_steps", "1", "--train_batch_size", "2048",
        "--test_batch_size", "8192", "--learning_rate", "0.02", "--display_interval", "10",
        "--test_interval", "20", "--compute_dtype", dtype])
    logs, model = out["logs"][0], out["state"].model
    dt = getattr(torch, dtype)
    train, evals = (_expected(_fixed_shapes(model), t, dt) for t in (True, False))
    assert all(math.isfinite(x) for x in logs["train_loss"] + logs["test_loss"])
    assert logs["test_loss"][-1] < logs["test_loss"][0] and logs["test_AUROC"][-1] > 0.6
    assert set(launched) == set(train) | set(evals)
    assert all(launched[k] >= 40 for k in train) and all(launched[k] >= 1 for k in evals)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_main_train_on_tsv_shards(dev, tmp_path):
    """main_train --root_dir on Criteo-shaped TSV shards written from a seed
    (4 shards; empty, negative and short fields), parsed by the C++ parser:
    every whole training batch of each shard (the short rest dropped), then
    one test pass whose last batch of each shard is short; each step and each
    test batch launches its kernels."""
    from nasrec_tpu_torch.data.native import binding
    from nasrec_tpu_torch.data.synthetic import write_tsv_shards

    shards, batch, test_batch = 4, 4096, 4096
    write_tsv_shards(str(tmp_path), 13, 26, {"trainval": shards * 10_000, "test": shards * 5_000},
                     shards, seed=0)
    assert binding.native_available(), binding.build_error()
    steps, tests = shards * (10_000 // batch), shards * 2
    out, launched = _main_train([
        "--arch", "criteo-kaggle/xlarge", "--root_dir", str(tmp_path),
        "--train_batch_size", str(batch), "--test_batch_size", str(test_batch),
        "--max_train_steps", str(steps), "--test_only_at_last_step", "1",
        "--learning_rate", "0.02", "--display_interval", "1"])
    logs = out["logs"][0]
    shapes = _fixed_shapes(out["state"].model)
    want = Counter(_expected(shapes, True, times=steps))
    want.update(_expected(shapes, False, times=tests))
    assert launched == dict(want)
    assert len(logs["train_loss"]) == steps and all(math.isfinite(x) for x in logs["train_loss"])
    assert len(logs["test_loss"]) == 1 and math.isfinite(logs["test_loss"][0])
    assert 0.0 <= logs["test_AUROC"][0] <= 1.0


def test_main_train_reports_flops_and_writes_a_trace(dev, tmp_path, capsys):
    """--report_flops 1 --profile_dir on 3 xlarge steps at batch 512: one
    FLOPS line, the model graph and a trace file."""
    out, _ = _main_train([
        "--arch", "criteo-kaggle/xlarge", "--data_source", "synthetic",
        "--max_train_steps", "3", "--max_eval_steps", "1", "--train_batch_size", "512",
        "--test_batch_size", "512", "--test_interval", "3", "--learning_rate", "0.02",
        "--report_flops", "1", "--logging_dir", str(tmp_path / "flops"),
        "--profile_dir", str(tmp_path / "trace")])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("FLOPS:")]
    trace = tmp_path / "trace" / "trace.json"
    assert len(lines) == 1 and out["state"].step == 3
    assert trace.is_file() and trace.stat().st_size > 0
    assert (tmp_path / "flops" / "model_graph" / "modules.txt").is_file()


@pytest.fixture(scope="module")
def supernet_run(tmp_path_factory):
    """train_supernet on synthetic data at 7 blocks and batch 512 (6 steps),
    then resumed from its checkpoint for 3 more; the searches below run on
    the resumed run's checkpoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from nasrec_tpu_torch.cli import train_supernet

    tmp = tmp_path_factory.mktemp("supernet")
    before = _launches()
    first = train_supernet.main(SN_CLI + ["--max_train_steps", "6", "--test_interval", "6",
                                          "--logging_dir", str(tmp / "first")])
    launched = _launched(before)
    second = train_supernet.main(SN_CLI + [
        "--max_train_steps", "3", "--test_interval", "3", "--logging_dir", str(tmp / "second"),
        "--checkpoint_path", str(tmp / "first" / "supernet_checkpoint.pkl")])
    return {"first": first, "second": second, "launched": launched, "dir": tmp,
            "ckpt": tmp / "second" / "supernet_checkpoint.pkl"}


def test_train_supernet_resumes_and_reloads(supernet_run):
    """Each step launches every block's kernels, each test forward the
    forward's; the run resumes at its step, writes the CLI's files, and its
    checkpoint reloads into a fresh model with equal eval logits."""
    from nasrec_tpu_torch.choices import choice_to_masks, full_path_choice
    from nasrec_tpu_torch.models.supernet import supernet_init
    from nasrec_tpu_torch.models.transplant import from_jax_params
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint
    from nasrec_tpu_torch.train.loop import make_eval_step

    first, second, tmp = supernet_run["first"], supernet_run["second"], supernet_run["dir"]
    logs1, logs2 = first["logs"][0], second["logs"][0]
    cfg = second["cfg"]
    shapes = _supernet_shapes(cfg)
    want = Counter(_expected(shapes, True, times=6))
    want.update(_expected(shapes, False, times=len(logs1["test_loss"])))
    assert supernet_run["launched"] == dict(want)
    assert all(math.isfinite(x) for x in logs1["train_loss"] + logs2["train_loss"]
               + logs1["test_loss"] + logs2["test_loss"])
    ckpt = load_any_checkpoint(str(supernet_run["ckpt"]))
    assert len(logs1["train_loss"]) == first["state"].step == 6
    assert second["state"].step == int(ckpt["step"]) == 9
    assert {"configs_args.json", "metrics.jsonl", "supernet_checkpoint.pkl",
            "train_test_logs.json", "train_test_logs.pickle"} <= {
        p.name for p in (tmp / "first").iterdir()}
    fresh = supernet_init(cfg, seed=123, device="cuda")
    fresh.load_state_dict(from_jax_params(ckpt["params"], cfg))
    rng = np.random.RandomState(2)
    dense = torch.as_tensor(rng.randn(SN_EVAL_BATCH, 13).astype(np.float32), device="cuda")
    cat = torch.as_tensor(rng.randint(0, cfg.vocab_sizes[0], size=(SN_EVAL_BATCH, 26))
                          .astype(np.int32), device="cuda")
    masks = choice_to_masks(full_path_choice(cfg.space, SN_BLOCKS), cfg.space,
                            SN_BLOCKS).to("cuda")
    step = make_eval_step(has_masks=True)
    assert torch.equal(step(fresh, dense, cat, masks),
                       step(second["state"].model, dense, cat, masks))


def test_train_supernet_in_bf16(dev, tmp_path):
    """train_supernet --compute_dtype bfloat16 for 3 steps: every step's
    kernels launch in bf16 (the segment-sum, the table update and the list
    kernels in f32), and the flag is in configs_args.json."""
    import json

    from nasrec_tpu_torch.cli import train_supernet

    before = _launches()
    out = train_supernet.main(SN_CLI + ["--compute_dtype", "bfloat16", "--max_train_steps", "3",
                                        "--test_interval", "3", "--logging_dir", str(tmp_path)])
    launched = _launched(before)
    logs, bf = out["logs"][0], torch.bfloat16
    shapes = _supernet_shapes(out["cfg"])
    want = Counter(_expected(shapes, True, bf, times=3))
    want.update(_expected(shapes, False, bf, times=len(logs["test_loss"])))
    assert launched == dict(want) and out["state"].step == 3
    assert all(math.isfinite(x) for x in logs["train_loss"] + logs["test_loss"])
    with open(tmp_path / "configs_args.json") as f:
        assert json.load(f)["train"]["compute_dtype"] == "bfloat16"


def _search_cfg(space="xlarge", blocks=SN_BLOCKS, vocab=1000):
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig

    return SuperNetConfig(space=OPS_CONFIG_LIB[space], num_blocks=blocks, num_dense=13,
                          num_sparse=26, vocab_sizes=(vocab,) * 26, use_layernorm=True)


def test_search_cli_random_and_cached(supernet_run, tmp_path):
    """eval_subnet_from_supernet --method random on the supernet run's
    checkpoint (one group of 8, 5 fine-tune steps and 8 eval chunks, each
    launching every block's eval forward kernels once for the group), and
    --method cached on the first 8 records of the committed proxy's search,
    whose recorded losses come back as gt_test_loss."""
    from nasrec_tpu_torch.cli import eval_subnet_from_supernet

    before = _launches()
    top = eval_subnet_from_supernet.main(SEARCH_CLI + [
        "--method", "random", "--budget", "8", "--group_size", str(GROUP), "--config", "xlarge",
        "--num_blocks", str(SN_BLOCKS), "--ckpt_path", str(supernet_run["ckpt"]),
        "--test_batch_size", str(TEST_BATCH), "--logging_dir", str(tmp_path / "random")])
    launched = _launched(before)
    with open(tmp_path / "random" / "all_results.pickle", "rb") as f:
        explored = pickle.load(f)
    assert launched == _expected(_supernet_shapes(_search_cfg()), False,
                                 times=5 + TEST_BATCH // CHUNK)
    assert len(explored) == 8 and len(top) == 2
    assert (tmp_path / "random" / "results.pickle").is_file()

    with open(PROXY_DIR / "results.pickle", "rb") as f:
        records = pickle.load(f)[:8]
    with open(tmp_path / "records.pickle", "wb") as f:
        pickle.dump(records, f)
    cached = eval_subnet_from_supernet.main(SEARCH_CLI + [
        "--method", "cached", "--choice_from_pickle_file", str(tmp_path / "records.pickle"),
        "--config", "xlarge-zeros", "--num_blocks", "2", "--synthetic_vocab", "500",
        "--ckpt_path", str(PROXY_DIR / "supernet_checkpoint.pkl"), "--test_batch_size", "4096",
        "--logging_dir", str(tmp_path / "cached")])
    assert (tmp_path / "cached" / "results.pickle").is_file()
    assert [r["gt_test_loss"] for r in cached] == [r["test_loss"] for r in records]
    assert all(math.isfinite(r["test_loss"]) and r["test_loss"] < 999
               for r in explored + list(cached))


def test_eval_subnet_from_scratch(dev, tmp_path):
    from nasrec_tpu_torch.cli import eval_subnet_from_scratch

    out = eval_subnet_from_scratch.main(SEARCH_CLI + [
        "--config", "xlarge", "--num_blocks", "7", "--num_subnets", "2",
        "--test_batch_size", "4096", "--learning_rate", "0.02", "--display_interval", "5",
        "--test_interval", "5", "--logging_dir", str(tmp_path)])
    assert len(out) == 2 and (tmp_path / "from_scratch_results.pickle").is_file()
    assert all(math.isfinite(r["test_loss"]) and r["test_loss"] < 999 for r in out)


@pytest.mark.parametrize("estimator", ["cost-model", "measured"])
def test_latency_search_once_per_estimator(supernet_run, tmp_path, monkeypatch, estimator):
    """The search CLI with --criterion test_loss_penalty_lat on the supernet
    run's checkpoint: a regularized EA of 8 initial candidates and one
    generation of 8 children.  Each candidate gets a finite latency and
    loss; the measured estimator times the subnet's forward through the
    kernels (its dot-product and body forwards launch inside
    measure_latency), the cost model launches nothing there and reports
    this process's estimate of each candidate; the evaluator's launches are
    its group steps' and eval chunks'."""
    from nasrec_tpu_torch import profiling, workloads
    from nasrec_tpu_torch.cli import eval_subnet_from_supernet

    inside, measure = Counter(), profiling.measure_latency

    def counted(*a, **kw):
        before = _launches()
        out = measure(*a, **kw)
        inside.update(_launched(before))
        return out

    monkeypatch.setattr(profiling, "measure_latency", counted)
    before = _launches()
    eval_subnet_from_supernet.main(SEARCH_CLI + [
        "--config", "xlarge", "--num_blocks", str(SN_BLOCKS),
        "--ckpt_path", str(supernet_run["ckpt"]), "--method", "regularized-ea",
        "--group_size", str(GROUP), "--test_batch_size", str(TEST_BATCH),
        "--criterion", "test_loss_penalty_lat", "--beta", "0.5", "--target_latency", "0.001",
        "--latency_batch_size", str(SN_BATCH), "--latency_estimator", estimator,
        "--init_population", "8", "--n_generations", "1", "--n_childs", "8",
        "--sample_size", "4", "--ea_top_k", "2", "--logging_dir", str(tmp_path)])
    total = Counter(_launched(before))
    with open(tmp_path / "all_results.pickle", "rb") as f:
        results = pickle.load(f)
    assert len(results) == 16
    assert all(math.isfinite(r["test_loss"]) and r["test_loss"] < 999 for r in results)
    assert all(math.isfinite(r["latency"]) and r["latency"] > 0 for r in results)
    total.subtract(inside)
    assert +total == _expected(_supernet_shapes(_search_cfg()), False,
                               times=2 * (5 + TEST_BATCH // CHUNK))
    if estimator == "measured":
        assert any(k.startswith("dot_fwd_n") for k in inside)
        assert any(k.startswith("body_fwd_s") for k in inside)
    else:
        assert not inside
        cost_model = workloads._choice_latency_fn(
            workloads.SearchOptions(config="xlarge", num_blocks=SN_BLOCKS,
                                    latency_batch_size=SN_BATCH, device="cuda"),
            workloads.DataOptions(data_source="synthetic"))
        assert [r["latency"] for r in results] == [cost_model(r["choice"]) for r in results]


def test_search_quality_proxy_ranks_as_recorded(dev):
    """The JAX-trained supernet of experiments/search_quality_proxy
    (xlarge-zeros, 2 blocks, LayerNorm, vocab 500) re-scores the 24 initial
    candidates of its search with the proxy's protocol (fine-tune stream
    seed 303, test stream seed 1, 200 steps at batch 512, 24 test batches of
    4096, lr 0.04, groups of 8) through the kernels: the Spearman
    correlation with the losses the TPU recorded is 0.7 or more."""
    from scipy.stats import spearmanr

    from nasrec_tpu_torch.data.synthetic import SyntheticSpec, synthetic_batches
    from nasrec_tpu_torch.models.supernet import supernet_init
    from nasrec_tpu_torch.models.transplant import from_jax_params
    from nasrec_tpu_torch.search import make_candidate_evaluator
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint

    spec = SyntheticSpec(vocab=500, signal_scale=0.7, interaction_pairs=16, interaction_scale=1.0)
    cfg = _search_cfg("xlarge-zeros", 2, spec.vocab)
    model = supernet_init(cfg, seed=0, device=dev)
    ckpt = load_any_checkpoint(str(PROXY_DIR / "supernet_checkpoint.pkl"))
    model.load_state_dict(from_jax_params(ckpt["params"], cfg))
    with open(PROXY_DIR / "all_results.pickle", "rb") as f:
        records = pickle.load(f)[:24]
    ev = make_candidate_evaluator(cfg, model, learning_rate=0.04, max_train_steps=200,
                                  max_eval_steps=24)
    before, got = _launches(), []
    for g in range(0, len(records), GROUP):
        got += [r["test_loss"] for r in ev(
            [r["choice"] for r in records[g:g + GROUP]],
            lambda: synthetic_batches(1_000_000, SN_BATCH, spec, seed=303, loop=True, device=dev),
            lambda: synthetic_batches(200_000, 4096, spec, seed=1, device=dev))]
    assert set(_launched(before)) == set(_expected(_supernet_shapes(cfg), False))
    assert all(math.isfinite(x) and x < 999 for x in got)
    assert spearmanr([r["test_loss"] for r in records], got)[0] >= 0.7


def test_search_fanout_two_processes_match_one(supernet_run, tmp_path):
    """The search CLI (16 candidates in two groups of 8) on the supernet
    run's checkpoint in two processes on the one card: results.pickle and
    all_results.pickle hold one process's choices in order, metrics within
    1e-6 relative; no process printed an abort or left a process group up."""
    from nasrec_tpu_torch.tools import search_fanout_demo as fanout

    cli = ["-m", "nasrec_tpu_torch.cli.eval_subnet_from_supernet", *SEARCH_CLI[:2],
           *SEARCH_CLI[4:], "--method", "random", "--budget", "16", "--group_size", str(GROUP),
           "--config", "xlarge", "--num_blocks", str(SN_BLOCKS),
           "--ckpt_path", str(supernet_run["ckpt"]), "--test_batch_size", str(TEST_BATCH)]
    _, single = fanout.run_single(cli, str(tmp_path / "one"), "cuda", 600)
    _, pair = fanout.run_pair(cli, str(tmp_path / "two"), "cuda", 600)
    assert not any(fanout.exit_faults(o) for o in single + pair)
    assert fanout.search_seconds(single[0]) > 0
    assert max(fanout.search_seconds(o) for o in pair) > 0
    assert fanout.compare(str(tmp_path / "one"), str(tmp_path / "two"), rel_tol=1e-6) == 16
