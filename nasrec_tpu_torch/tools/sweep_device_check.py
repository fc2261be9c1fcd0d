"""On-card check of the table-update kernel under skewed traffic (the
counterpart of `nasrec_tpu/tools/sweep_device_check.py`, whose TPU tiles do
not exist here).

Every position falls in a narrow band of rows in the middle of the table,
about 48 to a row, and the rows of the band that are multiples of 7 get a
zero gradient from each of their positions.  The gradients go through the
port's segment-sum (`train/sparse_embedding.py ::
rowwise_segment_sum_slotwise`) and the touched-row Adagrad update, once
through the kernel and once through the plain version, from the same table
and accumulator.  Every row without a nonzero summed gradient (outside the
band, and the zero-gradient rows inside it) must keep its bits; the touched
rows must match the plain version to rtol 1e-5, atol 1e-6.  Prints
SWEEP_DEVICE_CHECK_OK.  Without a card it raises: it never runs the plain
version in the kernel's place.

Run: python -m nasrec_tpu_torch.tools.sweep_device_check
"""

from __future__ import annotations

import numpy as np
import torch

VOCAB = 3 * 131_072
BAND = 4096
POSITIONS = 6 * 32_768
LR = 0.12


def main() -> int:
    from nasrec_tpu_torch.device import resolve_device
    from nasrec_tpu_torch.ops.kernels.table_update import table_update
    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    dev = resolve_device("cuda")
    rng = np.random.RandomState(7)
    idx = VOCAB // 2 - BAND // 2 + rng.randint(0, BAND, size=POSITIONS)
    g = (rng.randn(POSITIONS, 16) * 0.05).astype(np.float32)
    g[idx % 7 == 0] = 0.0
    rows, seg, _ = rowwise_segment_sum_slotwise(
        torch.as_tensor(idx[:, None].astype(np.int32), device=dev),
        torch.as_tensor(g, device=dev))
    table0 = torch.as_tensor(rng.randn(VOCAB, 16).astype(np.float32), device=dev)
    acc0 = torch.as_tensor(np.abs(rng.randn(VOCAB, 16)).astype(np.float32), device=dev)
    out = {}
    for impl in ("kernel", "plain"):
        table, acc = table0.clone(), acc0.clone()
        table_update(table, acc, rows.to(torch.int32).contiguous(), seg.contiguous(), LR,
                     impl=impl)
        out[impl] = (table, acc)
    torch.cuda.synchronize(dev)

    touched = torch.zeros(VOCAB, dtype=torch.bool, device=dev)
    touched[rows.long()[(seg != 0).any(dim=1)]] = True
    zero_grad_rows = int(np.unique(idx[idx % 7 == 0]).size)
    if touched.sum().item() + zero_grad_rows != np.unique(idx).size:
        raise AssertionError("the segment-sum's touched rows disagree with the traffic")
    for name, (table, acc) in out.items():
        if not (torch.equal(table[~touched], table0[~touched])
                and torch.equal(acc[~touched], acc0[~touched])):
            raise AssertionError(f"{name}: a row without a nonzero gradient changed its bits")
    for i, what in enumerate(("table", "accumulator")):
        got, want = out["kernel"][i][touched], out["plain"][i][touched]
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"touched rows of the {what}: kernel and plain differ by "
                                 f"{(got - want).abs().max().item():.3e}")
    print(f"SWEEP_DEVICE_CHECK_OK device={torch.cuda.get_device_name(dev)} "
          f"touched={int(touched.sum().item())}/{VOCAB} zero_gradient_rows={zero_grad_rows}",
          flush=True)
    return 0


if __name__ == "__main__":
    main()
