"""The Avazu and KDD best models in the port against the JAX package: two
sparse-embedding train steps of avazu/{xlarge, autoctr} and kdd/{xlarge,
autoctr} from the same transplanted weights on the same batches
(table_update="scatter", JAX attention_impl="xla"), the kdd/xlarge steps in
bf16, and one masked supernet step of each dataset at the supernet
launchers' settings (space xlarge, 7 blocks, LayerNorm, strategy default with
binomial-0.5 fan-in, lr 0.12).  The fixed subnets start from the JAX
package's initialisation, as tests/test_torch_train_step.py's do; the
supernets from the port's, transplanted into the JAX pytree (the JAX
initialisation of a 7-block supernet takes about 18 s on the CPU).

These archs put the kernels' plain versions at shapes the Criteo archs do
not: the dot-product at n = 33 (avazu/autoctr), the transformer body at
S = 16 on a training path (avazu/xlarge, kdd/xlarge), and KDD's 3-slot dense
input.  Tables are capped at 50 rows a slot, so a batch repeats rows.

The step harness is tests/test_torch_train_step.py's.  The supernet cases
run from tests/test_torch_datasets_supernet_{avazu,kdd}.py, one a file, so
that their JAX compiles run on two workers under --dist loadfile.

Tolerances.  f32: rtol 1e-4 / atol 1e-5 on the losses, logits, parameters,
embedding table and Adagrad accumulators (as tests/test_torch_train_step.py).
bf16 (as tests/test_torch_bf16_models.py, whose JAX side runs its kernels in
interpret mode, attention_impl="pallas"): losses within rtol 2e-2, logits
within 5e-2 of the largest logit; parameters, table and accumulators stay
float32, and each one's movement over the two steps (from the weights both
sides start from, and from zero accumulators) within twice the distance of
JAX's bf16 movement from the float32 step's, plus 2e-2 of JAX's largest
movement of the leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nasrec_tpu import choices as jax_choices
from nasrec_tpu import sampling as jax_sampling
from nasrec_tpu.config import OPS_CONFIG_LIB as JAX_OPS
from nasrec_tpu.models.supernet import SuperNetConfig as JaxSuperNetConfig
from nasrec_tpu.models.supernet import supernet_apply_embedded as jax_supernet_embedded
from nasrec_tpu.models.supernet import supernet_init as jax_supernet_init
from nasrec_tpu.train import make_optimizer
from nasrec_tpu.train.loop import init_train_state

from nasrec_tpu_torch import choices
from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.models.fixed import fixed_init
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
from nasrec_tpu_torch.models.transplant import from_jax_params, to_jax_params
from nasrec_tpu_torch.train.optim import make_lr_schedule
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)

from test_torch_train_step import (
    TOL,
    assert_state_matches,
    capped_vocab,
    check_two_sparse_steps,
    fixed_pair,
    jax_state_dicts,
    run_both_steps,
    step_batches,
)

torch.set_num_threads(2)

ARCHS = [(d, s) for d in ("avazu", "kdd") for s in ("xlarge", "autoctr")]


def _jax_params(model, jax_init):
    """The port model's weights as the JAX package's pytree, which must have
    the structure and shapes of `jax_init`'s (traced, not run)."""
    params = jax.tree_util.tree_map(jnp.array, to_jax_params(model))     # copies
    want = jax.eval_shape(jax_init, jax.random.PRNGKey(3))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(params),
                                                   jax.tree_util.tree_leaves(want)))
    return params


@pytest.mark.parametrize("dataset,space", ARCHS, ids=lambda v: v)
def test_two_sparse_steps_match_jax(dataset, space):
    check_two_sparse_steps(dataset, space, "xla", 64)


def test_kdd_xlarge_bf16_steps_match_jax():
    """kdd/xlarge carries the transformer body at S = 16 (block 6) beside
    S = 48 and 64; both sides compute in bf16 with float32 state.  The JAX
    fused body in interpret mode needs a batch its lane tile divides: 128."""
    japply, tplan, model, params = fixed_pair("kdd", "xlarge", "pallas", jnp.bfloat16)
    batches = step_batches("kdd", tplan.vocab_sizes, 128)
    jstate, jm, tstate, tm = run_both_steps(japply, model, tplan, params, batches, 0.02,
                                            compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    want = np.asarray(jm["logits"])
    assert tm["logits"].dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(tm["logits"].numpy(), want, rtol=0,
                               atol=5e-2 * max(float(np.abs(want).max()), 1.0))
    # Each leaf's movement over the two steps against JAX's: a gradient that
    # the bf16 backward drops or scales shows here, where the loss hides it.
    # bf16 itself moves a leaf away from the float32 step's movement (the
    # port's, held to JAX's at TOL by test_two_sparse_steps_match_jax): the
    # port's bf16 movement must lie within twice JAX's own spread of the
    # float32 one, plus 2e-2 of JAX's largest movement of the leaf.
    model32 = fixed_init(tplan, seed=0, device="cpu")
    model32.load_state_dict(from_jax_params(params, tplan))
    state32 = init_sparse_train_state(model32)
    step32 = make_sparse_embedding_train_step(make_lr_schedule("cosine", 0.02, 10, 1))
    for batch in batches:
        state32, _ = step32(state32, *(torch.from_numpy(x) for x in batch))
    start_p, start_a = jax_state_dicts(init_train_state(params, make_optimizer("adagrad")),
                                       tplan)
    want_p, want_a = jax_state_dicts(jstate, tplan)
    got_p, f32_p = tstate.model.state_dict(), model32.state_dict()
    assert set(got_p) == set(want_p) == set(tstate.opt_state)
    for name in want_p:
        for what, got, f32, end, start in (
                ("param", got_p[name], f32_p[name], want_p[name], start_p[name]),
                ("acc", tstate.opt_state[name], state32.opt_state[name], want_a[name],
                 start_a[name])):
            assert got.dtype == torch.float32, (what, name)
            moved = (end - start).numpy()
            spread = float(np.abs(moved - (f32 - start).numpy()).max())
            np.testing.assert_allclose((got - start).numpy(), moved, rtol=0,
                                       atol=2 * spread + 2e-2 * float(np.abs(moved).max()),
                                       err_msg=f"{what} {name}")


def check_masked_supernet_step(dataset):
    """One step of the supernet the train_supernet launchers train, on a
    subnet the launchers' sampler draws after its warm-up, port against JAX
    within TOL."""
    spec, vocab = DATASETS[dataset], capped_vocab(dataset)
    kw = dict(num_blocks=7, num_dense=spec.num_dense, num_sparse=spec.num_sparse,
              vocab_sizes=vocab, use_layernorm=True)
    jcfg = JaxSuperNetConfig(space=JAX_OPS["xlarge"], attention_impl="xla", **kw)
    tcfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], **kw)
    model = supernet_init(tcfg, seed=5, device="cpu")
    params = _jax_params(model, lambda key: jax_supernet_init(key, jcfg))
    sampler = jax_sampling.ChoiceSampler(JAX_OPS["xlarge"], 7, strategy="default",
                                         anypath_choice="binomial-0.5",
                                         supernet_training_steps=0, seed=4)
    pick = sampler()
    assert pick != jax_choices.full_path_choice(JAX_OPS["xlarge"], 7)
    jmask = jax_choices.choice_to_masks(pick, JAX_OPS["xlarge"], 7)
    tmask = choices.choice_to_masks(pick, OPS_CONFIG_LIB["xlarge"], 7).to("cpu")
    jstate, jm, tstate, tm = run_both_steps(
        lambda p, d, s, m: jax_supernet_embedded(jcfg, p, d, s, m), model, tcfg, params,
        step_batches(dataset, vocab, 32, n=1), 0.12, masks=([jmask], [tmask]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["logits"].numpy(), np.asarray(jm["logits"]), **TOL)
    assert_state_matches(tstate, jstate, tcfg, TOL)
