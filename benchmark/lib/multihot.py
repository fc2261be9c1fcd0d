"""Multi-hot traffic (DLRM-DCNv2's cells): batches made on the device from
the run's seed.  Batch i of a run is drawn from its own generator (seed, i),
so any batch can be made again without the ones before it.

A batch is (dense f32 [B, D] ~ N(0, 1), ids int32 [B, H], labels f32 [B, 1]
~ Bernoulli(label_rate)).  Slot s's bag of multi_hot_sizes[s] ids sits in
columns [sum(sizes[:s]), sum(sizes[:s + 1])) of ids, each id uniform over the
slot's vocab_sizes[s] rows (the card's share of its table) and drawn
independently of the others in its bag, so a bag may repeat an id.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lib.weights import generator


def column_rows(vocab: Sequence[int], sizes: Sequence[int]) -> list:
    """The rows each column of a batch's ids draws from."""
    return [int(v) for v, h in zip(vocab, sizes) for _ in range(h)]


def device_batch(seed: int, i: int, batch: int, vocab: Sequence[int], sizes: Sequence[int],
                 num_dense: int, label_rate: float,
                 device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    g = generator(seed, f"batch-{i}", device)
    dense = torch.randn(batch, num_dense, generator=g, device=device)
    rows = torch.as_tensor(column_rows(vocab, sizes), dtype=torch.float64, device=device)
    u = torch.rand(batch, rows.numel(), generator=g, device=device, dtype=torch.float64)
    ids = (u * rows).to(torch.int32)
    y = (torch.rand(batch, 1, generator=g, device=device) < label_rate).float()
    return dense, ids, y


def unique_rows(ids: torch.Tensor, vocab: Sequence[int], sizes: Sequence[int]) -> int:
    """Distinct table rows that a batch's ids touch (a slot's rows are its
    own: the same id in two slots is two rows)."""
    starts, s = [], 0
    for v in vocab:
        starts.append(s)
        s += int(v)
    offsets = torch.as_tensor(column_rows(starts, sizes), dtype=torch.int64, device=ids.device)
    return int(torch.unique(ids.long() + offsets[None, :]).numel())
