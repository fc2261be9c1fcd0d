"""On-card check of the kernel path's fixed-subnet forward (port of
`nasrec_tpu/tools/body_device_check.py`).

Runs the criteo-kaggle/xlarge best arch's forward (7 blocks; the transformer
body kernel at S = 64 and 48, the dot-product kernel at n = 40 and 9) at the
CLIs' default eval batch, 16368 = 31 x 512 + 496 rows (no multiple of any
tile the kernels use), with 1000 rows a slot (the table's size does not
matter to these kernels), through impl="kernel" and impl="plain" from the
same weights and inputs, and holds the logits to 1e-3 (absolute; the tolerance
tests/test_torch_cuda_paths.py holds a forward's logits to).  Prints BODY_DEVICE_CHECK_OK.
Without a card it raises: it never runs the plain version in the kernel's
place.

Run: python -m nasrec_tpu_torch.tools.body_device_check [batch]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

LOGIT_TOL = 1e-3
EVAL_BATCH = 16368


def main(batch: int = EVAL_BATCH) -> float:
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
    from nasrec_tpu_torch.configs import get_best_arch
    from nasrec_tpu_torch.device import resolve_device
    from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_apply, fixed_init

    dev = resolve_device("cuda")
    # The plain path's linears are cuBLAS f32 products: full f32, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = DATASETS["criteo-kaggle"]
    vocab = tuple([1000] * spec.num_sparse)
    plan = build_fixed_plan(get_best_arch("criteo-kaggle", "xlarge"), OPS_CONFIG_LIB["xlarge"],
                            7, spec.num_dense, spec.num_sparse, vocab)
    model = fixed_init(plan, 0, dev)
    rng = np.random.RandomState(11)
    dense = torch.as_tensor(rng.randn(batch, spec.num_dense).astype(np.float32), device=dev)
    cat = torch.as_tensor(np.stack([rng.randint(0, v, size=batch) for v in vocab], 1)
                          .astype(np.int32), device=dev)
    with torch.no_grad():
        logits = {impl: fixed_apply(model, dense, cat, impl=impl) for impl in ("kernel", "plain")}
    if not torch.isfinite(logits["kernel"]).all():
        raise AssertionError("the kernel path's logits are not finite")
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    if diff > LOGIT_TOL:
        raise AssertionError(f"the kernel path's forward differs from the plain path's at batch "
                             f"{batch}: max abs diff {diff:.3e} > {LOGIT_TOL}")
    print(f"BODY_DEVICE_CHECK_OK device={torch.cuda.get_device_name(dev)} batch={batch} "
          f"max_abs_diff={diff:.3e}", flush=True)
    return diff


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else EVAL_BATCH)
