"""The low-rank cross layer of DCN V2 (Wang et al., arXiv:2008.13535, eq. 2
with the low-rank form of section 5.2), as DLRM-DCNv2 uses it:

    x_{l+1} = x_0 * (W_l (V_l x_l) + b_l) + x_l

with V_l [rank, width] (no bias) and W_l [width, rank] with bias b_l.  No
NASRec node computes it and no TPU kernel of the JAX package does: it is two
f32 matrix products and elementwise work, left to cuBLAS through `F.linear`
(at DLRM-DCNv2's width 3456 and rank 512 the products are large enough for
cuBLAS's f32 rate).  Weights in PyTorch's [out, in] layout; V and W
xavier-normal and the bias zero, as torchrec's LowRankCrossNet draws them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from nasrec_tpu_torch.ops.common import linear_cast, xavier_normal_


class LowRankCrossLayer(nn.Module):
    """One cross layer: forward(x0, x) -> x0 * (W (V x) + b) + x."""

    def __init__(self, width: int, rank: int, generator: torch.Generator, device=None):
        super().__init__()
        self.v = nn.Parameter(torch.empty(rank, width, device=device))
        self.w = nn.Parameter(torch.empty(width, rank, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))
        if self.v.device.type != "meta":
            xavier_normal_(self.v, width, rank, generator)
            xavier_normal_(self.w, rank, width, generator)

    def forward(self, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x0 * linear_cast(linear_cast(x, self.v, None), self.w, self.bias) + x
