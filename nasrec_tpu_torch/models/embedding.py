"""Fused multi-table embedding stem (port of `nasrec_tpu/models/embedding.py`).

All per-slot tables are concatenated row-wise into ONE [total_vocab, emb_dim]
f32 table with per-slot row offsets, so the stem is a single gather of the
[B*S] fused indices.  The gather is a plain `index_select`: the JAX package
leaves it to XLA too.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from nasrec_tpu_torch.ops.common import xavier_normal_


def table_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Starting row of each per-slot table inside the fused table."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes))[:-1]]).astype(np.int32)


class EmbeddingStem(nn.Module):
    """One fused table; each per-slot part is xavier-normal with its own fan-in
    (ref: nasrec/utils/train_utils.py:76-77).  The table is trained by the
    sparse step's touched-row update, never by autograd."""

    def __init__(self, vocab_sizes: Sequence[int], emb_dim: int,
                 generator: torch.Generator, device=None):
        super().__init__()
        total = int(np.sum(vocab_sizes))
        self.table = nn.Parameter(torch.empty(total, emb_dim, device=device),
                                  requires_grad=False)
        start = 0
        for v in vocab_sizes:
            xavier_normal_(self.table.data[start:start + int(v)], int(v), emb_dim, generator)
            start += int(v)
        self.register_buffer(
            "offsets", torch.as_tensor(table_offsets(vocab_sizes), device=device),
            persistent=False,
        )

    def fused_index(self, cat_x: torch.Tensor) -> torch.Tensor:
        """[B, S] per-slot indices -> [B, S] int32 fused-table rows."""
        return cat_x.to(torch.int32) + self.offsets[None, :]

    def forward(self, cat_x: torch.Tensor) -> torch.Tensor:
        """Lookup -> flat slot-major [B, S*E]."""
        idx = self.fused_index(cat_x)
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
