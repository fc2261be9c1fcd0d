"""One masked supernet step of kdd at the train_supernet launcher's
settings (space xlarge, 7 blocks, LayerNorm), the port against the JAX
package (tests/test_torch_datasets.py :: check_masked_supernet_step); a file
of its own, so that its JAX compile runs on a worker of its own under
--dist loadfile."""

from test_torch_datasets import check_masked_supernet_step


def test_masked_supernet_step_matches_jax():
    check_masked_supernet_step("kdd")
