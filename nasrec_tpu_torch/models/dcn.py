"""DLRM-DCNv2 (Wang et al., "DCN V2", arXiv:2008.13535), the model of MLPerf
Training's recommendation benchmark (github.com/mlcommons/training,
recommendation_v2/torchrec_dlrm): multi-hot embedding bags, sum-pooled; a
dense arch; the low-rank cross network over the concatenation of the dense
arch's output and the pooled bags; an over arch and a logit.

    dense [B, 13] -> Linear+ReLU 512, 256, 128              -> d [B, 128]
    ids [B, H]    -> sum-pooled bags, one a slot (S of 128)   -> stem [B, S*128]
    x_0 = [d, stem]  (27 x 128 = 3456 wide)
    3 x  x_{l+1} = x_0 * (W_l (V_l x_l) + b_l) + x_l         (ops/cross.py, rank 512)
    -> Linear+ReLU 1024, 1024, 512, 256 -> Linear 1          -> logit [B, 1]

It has the interface the port's sparse step uses (`embedding.table`,
`embedding.fused_index`, `forward_embedded(dense, stem, impl,
compute_dtype)`), so it trains through `make_sparse_embedding_train_step`
with `bag_sizes`.  The dense parameters follow the port's compute-dtype rule
(ops/common.py); `impl` is taken for the interface and selects nothing: no
part of this model has a hand-written kernel.  Linear layers are drawn as
torch's nn.Linear draws them, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias; the table U(-1/sqrt(rows), 1/sqrt(rows)) a slot.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.models.embedding import EmbeddingStem
from nasrec_tpu_torch.ops.common import linear_cast
from nasrec_tpu_torch.ops.cross import LowRankCrossLayer


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    vocab_sizes: Tuple[int, ...]            # rows a slot held here
    bag_sizes: Tuple[int, ...]              # lookups a slot a row, sum-pooled
    num_dense: int = 13
    emb_dim: int = 128
    dense_arch: Tuple[int, ...] = (512, 256, 128)
    cross_layers: int = 3
    cross_rank: int = 512
    over_arch: Tuple[int, ...] = (1024, 1024, 512, 256)
    # The rows of each slot's whole table, where `vocab_sizes` is a share of
    # it (the table's init bound is of the whole table); None: vocab_sizes.
    init_rows: Optional[Tuple[int, ...]] = None

    @property
    def interaction_width(self) -> int:
        return self.emb_dim * (1 + len(self.vocab_sizes))


class _Linear(nn.Linear):
    """nn.Linear drawn from a generator as torch draws it; applied through
    `linear_cast` (the compute-dtype rule)."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator, device=None):
        super().__init__(in_dim, out_dim, device=device)
        if self.weight.device.type != "meta":
            bound = 1.0 / math.sqrt(in_dim)
            with torch.no_grad():
                self.weight.uniform_(-bound, bound, generator=generator)
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_cast(x, self.weight, self.bias)


def _mlp(dims, generator, device) -> nn.ModuleList:
    return nn.ModuleList(_Linear(a, b, generator, device) for a, b in zip(dims, dims[1:]))


class DCNv2Model(nn.Module):
    def __init__(self, cfg: DCNv2Config, generator: torch.Generator, device=None):
        super().__init__()
        if cfg.dense_arch[-1] != cfg.emb_dim:
            raise ValueError(f"the dense arch ends at {cfg.dense_arch[-1]}, not at the "
                             f"embedding width {cfg.emb_dim}")
        self.cfg = cfg
        self.embedding = EmbeddingStem(cfg.vocab_sizes, cfg.emb_dim, generator, device,
                                       bag_sizes=cfg.bag_sizes, init="uniform",
                                       init_rows=cfg.init_rows)
        width = cfg.interaction_width
        self.dense_arch = _mlp((cfg.num_dense,) + tuple(cfg.dense_arch), generator, device)
        self.cross = nn.ModuleList(LowRankCrossLayer(width, cfg.cross_rank, generator, device)
                                   for _ in range(cfg.cross_layers))
        self.over_arch = _mlp((width,) + tuple(cfg.over_arch), generator, device)
        self.final = _Linear(cfg.over_arch[-1], 1, generator, device)

    def forward_embedded(self, dense_x: torch.Tensor, stem: torch.Tensor, impl: str = "auto",
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Forward from the pooled flat stem [B, S*E] -> float32 logits [B, 1]."""
        x = dense_x.to(compute_dtype)
        for layer in self.dense_arch:
            x = torch.relu(layer(x))
        x0 = torch.cat([x, stem.to(compute_dtype)], dim=1)
        with tracing.span("model.cross", device=True):
            x = x0
            for layer in self.cross:
                x = layer(x0, x)
        for layer in self.over_arch:
            x = torch.relu(layer(x))
        return self.final(x).float()

    def forward(self, dense_x: torch.Tensor, cat_x: torch.Tensor, impl: str = "auto",
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, 13] dense and [B, H] per-slot ids -> float32 logits [B, 1]."""
        return self.forward_embedded(dense_x, self.embedding(cat_x), impl, compute_dtype)


def dcnv2_init(cfg: DCNv2Config, seed: int = 0, device="cpu") -> DCNv2Model:
    """A freshly drawn model on `device`, from a torch.Generator seeded with
    `seed`; on the `meta` device (shapes only) nothing is drawn."""
    gen_device = "cpu" if torch.device(device).type == "meta" else device
    return DCNv2Model(cfg, torch.Generator(device=gen_device).manual_seed(seed), device)
