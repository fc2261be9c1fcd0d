"""Fused multi-table embedding stem (port of `nasrec_tpu/models/embedding.py`).

All per-slot tables are concatenated row-wise into ONE [total_vocab, emb_dim]
f32 table with per-slot row offsets, so the stem is a single gather of the
[B*S] fused indices.  The gather is a plain `index_select`: the JAX package
leaves it to XLA too.

Multi-hot slots (DLRM-DCNv2, models/dcn.py): slot s looks up a bag of
`bag_sizes[s]` ids a row and sum-pools them.  A batch's ids are then
[B, H] with H = sum(bag_sizes), slot s's bag in its columns
[sum(bag_sizes[:s]), sum(bag_sizes[:s + 1])), and the pooled stem is still
the flat [B, S*E] that a one-hot stem is.  One-hot is the case where every
bag size is 1.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nasrec_tpu_torch.ops.common import xavier_normal_


def table_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Starting row of each per-slot table inside the fused table."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes))[:-1]]).astype(np.int32)


class EmbeddingStem(nn.Module):
    """One fused table; each per-slot part is xavier-normal with its own fan-in
    (ref: nasrec/utils/train_utils.py:76-77), or with init="uniform"
    U(-1/sqrt(rows), 1/sqrt(rows)) of its own rows (`init_rows`, the slot's
    whole table where this stem holds a share of it; DLRM-DCNv2).  The table
    is trained by the sparse step's touched-row update, never by autograd.
    `bag_sizes` (one a slot, default all 1) makes the slots multi-hot."""

    def __init__(self, vocab_sizes: Sequence[int], emb_dim: int,
                 generator: torch.Generator, device=None,
                 bag_sizes: Optional[Sequence[int]] = None, init: str = "xavier",
                 init_rows: Optional[Sequence[int]] = None):
        super().__init__()
        total = int(np.sum(vocab_sizes))
        self.table = nn.Parameter(torch.empty(total, emb_dim, device=device),
                                  requires_grad=False)
        start = 0
        for v, n in zip(vocab_sizes, init_rows or vocab_sizes):
            part = self.table.data[start:start + int(v)]
            if init == "xavier":
                xavier_normal_(part, int(v), emb_dim, generator)
            elif init == "uniform":
                if part.device.type != "meta":
                    bound = 1.0 / math.sqrt(int(n))
                    part.uniform_(-bound, bound, generator=generator)
            else:
                raise ValueError(f"unknown table init {init!r}")
            start += int(v)
        self.bag_sizes = tuple(int(h) for h in (bag_sizes or [1] * len(vocab_sizes)))
        if len(self.bag_sizes) != len(vocab_sizes) or min(self.bag_sizes) < 1:
            raise ValueError(f"one bag size >= 1 a slot expected, got {self.bag_sizes} for "
                             f"{len(vocab_sizes)} slots")
        self.bagged = any(h != 1 for h in self.bag_sizes)
        # The fused-row offset of each column of a batch's ids.
        self.register_buffer(
            "offsets", torch.as_tensor(np.repeat(table_offsets(vocab_sizes), self.bag_sizes),
                                       device=device),
            persistent=False,
        )
        self._bags: Dict[tuple, tuple] = {}

    @property
    def columns(self) -> int:
        """Ids a row of a batch: the slots' bag sizes summed."""
        return int(sum(self.bag_sizes))

    def fused_index(self, cat_x: torch.Tensor) -> torch.Tensor:
        """[B, H] per-slot ids (H = `columns`) -> [B, H] int32 fused-table rows."""
        return cat_x.to(torch.int32) + self.offsets[None, :]

    def _bag_maps(self, batch: int, device) -> tuple:
        """(bag starts [B*S], bag of each lookup [B*H] int64) of a batch of
        `batch` rows, lookups in (row, column) order and bags in (row, slot)
        order; made once a batch size and device."""
        key = (batch, str(device))
        maps = self._bags.get(key)
        if maps is None:
            h = torch.as_tensor(self.bag_sizes, device=device)
            col0 = torch.cumsum(h, 0) - h
            starts = (torch.arange(batch, device=device)[:, None] * self.columns
                      + col0[None, :]).reshape(-1).to(torch.int32)
            bag_of = torch.repeat_interleave(
                torch.arange(batch * len(self.bag_sizes), device=device), h.repeat(batch))
            maps = self._bags[key] = (starts, bag_of)
        return maps

    def bag_index(self, batch: int, device=None) -> torch.Tensor:
        """[B*H] int64: the bag (row b * S + s of the pooled stem's [B*S, E]
        view) that each lookup of a batch of `batch` rows is pooled into."""
        return self._bag_maps(batch, device or self.table.device)[1]

    def pool(self, table: torch.Tensor, idx: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
        """[B, H] fused rows -> the flat stem [B, S*E]: each bag's rows summed
        (`F.embedding_bag`, mode "sum").  `table` holds the fused rows
        [row_offset, row_offset + len(table)); a lookup outside them adds
        nothing, so row shares of the table each give their part of the sum."""
        b = idx.shape[0]
        starts, _ = self._bag_maps(b, idx.device)
        local, owned = idx.reshape(-1), None
        if row_offset or table.shape[0] != self.table.shape[0]:
            local = local - row_offset
            keep = (local >= 0) & (local < table.shape[0])
            owned = keep.to(table.dtype)
            local = torch.where(keep, local, torch.zeros_like(local))
        out = F.embedding_bag(local, table, starts, mode="sum", per_sample_weights=owned)
        return out.reshape(b, -1)

    def forward(self, cat_x: torch.Tensor) -> torch.Tensor:
        """Lookup -> flat slot-major [B, S*E]."""
        idx = self.fused_index(cat_x)
        if self.bagged:
            return self.pool(self.table, idx)
        looked = self.table.index_select(0, idx.reshape(-1))
        return looked.reshape(cat_x.shape[0], -1)


def load_embedding_from_checkpoint(model: nn.Module, ckpt_path: str) -> nn.Module:
    """Seed `model.embedding.table` from another checkpoint's table, in place
    (parity with seeding from a DLRM checkpoint, ref: nasrec/supernet/
    supernet.py:368-383).  Shapes must match exactly."""
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint

    src = load_any_checkpoint(ckpt_path)["params"]["embedding"]["table"]
    dst = model.embedding.table
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"embedding table shape mismatch: ckpt {tuple(src.shape)} "
                         f"vs model {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.as_tensor(np.asarray(src, dtype=np.float32)))
    return model
