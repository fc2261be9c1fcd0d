"""Weight-sharing supernet: every node at its maximum width, the choice as
mask inputs (port of `nasrec_tpu/models/supernet.py`).

Reference model: nasrec/supernet/supernet.py (SuperNet :210, SuperNetBlock
:884).  The reference keeps shapes static in supernet mode by substituting
zero tensors for inputs it does not select and multiplying node outputs by
width masks (ref :536-568, modules.py:57-127).  The JAX package lowers the
whole choice to `ChoiceMasks` and passes them as inputs to one compiled
function; this port does the same eagerly: every node of every block is
computed and multiplied by its gate, and no mask value is read on the host,
so one step launches the same kernels whatever the subnet and never waits
for the card.  Training and the search's whole-net modes need that: the
gradients reach every weight, and one launch sequence serves every subnet.
The search's final-only group, whose body is frozen and whose choices are
host values, runs a forward of its own instead, each candidate's GEMMs cut
to what its choice leaves non-zero (`search/pruned_body.py`).

Module and parameter names mirror the JAX pytree: `embedding.table`,
`blocks.<i>.nodes.<k>` (a ModuleList indexed like JAX's `nodes` list, with a
parameterless module where JAX holds `{}` for a zeros node),
`blocks.<i>.{ds_proj, ds_ln, deep_fm}` and `final`, so `models/transplant.py`
maps one to the other by name.

`compute_dtype` is the activations' dtype, as in the JAX package's
`supernet_apply`: the dense input and the stem are cast to it once, masks and
gates are cast to it where they multiply, and the logits come back float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from nasrec_tpu_torch.choices import ChoiceMasks
from nasrec_tpu_torch.config import DEFAULT_EMBEDDING_DIM, DS_INTERACT_NUM_SPLITS, OpsConfig
from nasrec_tpu_torch.models.embedding import EmbeddingStem
from nasrec_tpu_torch.ops.attention import Transformer
from nasrec_tpu_torch.ops.common import LayerNorm, Linear
from nasrec_tpu_torch.ops.interactions import FM3D, DotProduct, SigmoidGating, Sum
from nasrec_tpu_torch.ops.linear import ElasticLinear, ElasticLinear3D


@dataclasses.dataclass(frozen=True)
class SuperNetConfig:
    """Static supernet description."""

    space: OpsConfig
    num_blocks: int
    num_dense: int
    num_sparse: int
    vocab_sizes: Tuple[int, ...]
    emb_dim: int = DEFAULT_EMBEDDING_DIM
    use_layernorm: bool = True
    activation: str = "relu"
    last_n_blocks_out: int = 1
    use_final_sigmoid: bool = False

    # Derived widths (every node at its maximum width).

    def dense_width(self, j: int) -> int:
        """Width of virtual block j's dense output (j = 0 is the input)."""
        return self.num_dense if j == 0 else self.space.max_dense_dim

    def sparse_slots(self, j: int) -> int:
        """Slot count of virtual block j's sparse output.  Every choice block
        appends DS_INTERACT_NUM_SPLITS pseudo-slots (ref: supernet.py:1161)."""
        if j == 0:
            return self.num_sparse
        return self.space.max_sparse_dim + DS_INTERACT_NUM_SPLITS

    def block_dense_in(self, i: int) -> int:
        return sum(self.dense_width(j) for j in range(i + 1))

    def block_sparse_in(self, i: int) -> int:
        return sum(self.sparse_slots(j) for j in range(i + 1))

    def head_width(self) -> int:
        n = self.last_n_blocks_out
        nb = self.num_blocks
        dense = sum(self.dense_width(j) for j in range(nb, nb - n, -1))
        return dense + self.sparse_slots(nb) * self.emb_dim * n


def _make_node(cfg: SuperNetConfig, i: int, name: str, gen, device) -> nn.Module:
    """Node `name` of block i at maximum widths."""
    s, uln = cfg.space, cfg.use_layernorm
    d_in, s_in = cfg.block_dense_in(i), cfg.block_sparse_in(i)
    if name == "linear-2d":
        return ElasticLinear(d_in, s.max_dense_dim, uln, gen, device)
    if name in ("zeros-2d", "zeros-3d"):
        return nn.Identity()             # no parameters: JAX holds {} here
    if name == "sum":
        return Sum(d_in, d_in, s.max_dense_dim, uln, gen, device)
    if name == "sigmoid-gating":
        return SigmoidGating(d_in, d_in, s.max_dense_dim, uln, gen, device)
    if name == "dot-product":
        return DotProduct(d_in, s_in, s.max_dense_dim, cfg.emb_dim, uln, gen, device)
    if name == "transformer":
        return Transformer(s_in, s.max_sparse_dim, cfg.emb_dim, uln, gen, device)
    if name == "linear-3d":
        return ElasticLinear3D(s_in, s.max_sparse_dim, uln, gen, device)
    raise NotImplementedError(name)


def _masked_concat(tensors: Sequence[torch.Tensor], sel: torch.Tensor) -> torch.Tensor:
    """Concat prior outputs, each scaled by its 0/1 selector (the reference's
    zero-tensor substitution, ref: supernet.py:536-568)."""
    parts = [t * sel[j].to(t.dtype) for j, t in enumerate(tensors)]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


class SuperNetBlock(nn.Module):
    def __init__(self, cfg: SuperNetConfig, i: int, gen, device):
        super().__init__()
        s = cfg.space
        self.i = i
        self.cfg = cfg
        self.nodes = nn.ModuleList(_make_node(cfg, i, name, gen, device)
                                   for name in s.node_names)
        # Dense -> sparse merge projection (ref: supernet.py:985-995).
        expanded = DS_INTERACT_NUM_SPLITS * cfg.emb_dim
        self.ds_proj = self.ds_ln = None
        if s.max_dense_dim != expanded:
            self.ds_proj = Linear(s.max_dense_dim, expanded, not cfg.use_layernorm, gen, device)
            if cfg.use_layernorm:
                self.ds_ln = LayerNorm(expanded, device=device)
        # DeepFM branch (ref: supernet.py:997-1003).
        self.deep_fm = FM3D(cfg.emb_dim, s.max_dense_dim, cfg.use_layernorm, gen, device)

    def forward(self, dense_in, sparse_in, left_in, right_in, masks: ChoiceMasks,
                impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, i, e = self.cfg, self.i, self.cfg.emb_dim
        act, ddim, sdim = masks.node_act[i], masks.dense_dim[i], masks.sparse_dim[i]
        act = act.to(dense_in.dtype)
        s_in = cfg.block_sparse_in(i)
        dense_outs: List[torch.Tensor] = []
        sparse_outs: List[torch.Tensor] = []
        for k, name in enumerate(cfg.space.node_names):
            node = self.nodes[k]
            if name in ("zeros-2d", "zeros-3d"):
                continue   # exact zeros in the sum (ref: supernet.py:1083-1111)
            if name == "linear-2d":
                dense_outs.append(node(dense_in, cfg.activation, ddim) * act[k])
            elif name in ("sum", "sigmoid-gating"):
                dense_outs.append(node(left_in, right_in, ddim) * act[k])
            elif name == "dot-product":
                dense_outs.append(node(dense_in, sparse_in, s_in, e, impl, ddim) * act[k])
            elif name == "transformer":
                sparse_outs.append(node(sparse_in, e, impl=impl, slot_mask=sdim) * act[k])
            elif name == "linear-3d":
                sparse_outs.append(node(sparse_in, e, cfg.activation, sdim) * act[k])
            else:
                raise NotImplementedError(name)
        dense_out = sum(dense_outs)      # node outputs are summed (ref: supernet.py:1133-1134)
        sparse_out = sum(sparse_outs)

        # Dense -> sparse merge from the PRE-deep-fm dense output (ref ordering:
        # supernet.py:1137-1161); proj [B, 8*E] is the slot-major flat of the
        # 8 pseudo-slots.
        proj = dense_out
        if self.ds_proj is not None:
            proj = self.ds_proj(dense_out)
            if self.ds_ln is not None:
                proj = self.ds_ln(proj)
        proj = proj * masks.interact[i].to(proj.dtype)
        # DeepFM: sparse -> dense residual (ref: supernet.py:1154-1157).
        fm = self.deep_fm(sparse_out, cfg.space.max_sparse_dim, e, ddim)
        dense_out = dense_out + fm * masks.deep_fm[i].to(fm.dtype)
        return dense_out, torch.cat([sparse_out, proj], dim=-1)


class SuperNet(nn.Module):
    """Parameters: embedding.table, blocks.<i>.{nodes.<k>, ds_proj, ds_ln,
    deep_fm}, final — the JAX pytree's structure and names."""

    def __init__(self, cfg: SuperNetConfig, generator: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = EmbeddingStem(cfg.vocab_sizes, cfg.emb_dim, generator, device)
        self.blocks = nn.ModuleList(SuperNetBlock(cfg, i, generator, device)
                                    for i in range(cfg.num_blocks))
        self.final = Linear(cfg.head_width(), 1, True, generator, device)

    def head_features_embedded(self, dense_x: torch.Tensor, stem: torch.Tensor,
                               masks: ChoiceMasks, impl: str = "auto",
                               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The features the final linear reads, [B, head_width] in
        `compute_dtype`, from a looked-up flat stem [B, S*E].  `masks` may be
        host (numpy) or device masks."""
        cfg = self.cfg
        masks = masks.to(dense_x.device)
        dense_list = [dense_x.to(compute_dtype)]
        sparse_list = [stem.to(compute_dtype)]
        for i, block in enumerate(self.blocks):
            d_out, s_out = block(
                _masked_concat(dense_list, masks.dense_sel[i]),
                _masked_concat(sparse_list, masks.sparse_sel[i]),
                _masked_concat(dense_list, masks.left_sel[i]),
                _masked_concat(dense_list, masks.right_sel[i]),
                masks, impl)
            dense_list.append(d_out)
            sparse_list.append(s_out)
        n = cfg.last_n_blocks_out
        flat_dense = torch.cat(dense_list[-n:], dim=-1) if n > 1 else dense_list[-1]
        if n > 1:
            # The reference concats the tail sparse outputs on the EMB axis
            # before flattening (ref: supernet.py:657-660).
            e = cfg.emb_dim
            tail = [s.reshape(s.shape[0], s.shape[-1] // e, e) for s in sparse_list[-n:]]
            flat_sparse = torch.cat(tail, dim=-1).reshape(dense_x.shape[0], -1)
        else:
            flat_sparse = sparse_list[-1]   # the flat layout is the reference flatten
        return torch.cat([flat_dense, flat_sparse], dim=-1)

    def head(self, features: torch.Tensor) -> torch.Tensor:
        """The final linear (and sigmoid, where configured) on head features,
        in their dtype; the logits come back float32."""
        out = self.final(features).float()
        if self.cfg.use_final_sigmoid:
            out = torch.sigmoid(out)
        return out

    def forward_embedded(self, dense_x: torch.Tensor, stem: torch.Tensor,
                         masks: ChoiceMasks, impl: str = "auto",
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Forward from a looked-up flat stem [B, S*E] -> float32 logits [B, 1]."""
        return self.head(self.head_features_embedded(dense_x, stem, masks, impl,
                                                     compute_dtype))

    def forward(self, dense_x: torch.Tensor, cat_x: torch.Tensor, masks: ChoiceMasks,
                impl: str = "auto", compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.forward_embedded(dense_x, self.embedding(cat_x), masks, impl,
                                     compute_dtype)


def supernet_init(cfg: SuperNetConfig, seed: int = 0, device="cpu") -> SuperNet:
    """A freshly initialised supernet on `device`, drawn from a
    torch.Generator seeded with `seed` (parity with JAX goes through
    transplant, not through the random draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return SuperNet(cfg, gen, device)


def supernet_apply(model: SuperNet, dense_x, cat_x, masks: ChoiceMasks,
                   impl: str = "auto",
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Forward pass -> float32 logits [B, 1].  The same launches for every subnet."""
    return model(dense_x, cat_x, masks, impl, compute_dtype)


def supernet_apply_embedded(model: SuperNet, dense_x, stem, masks: ChoiceMasks,
                            impl: str = "auto",
                            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Forward with a precomputed stem, [B, S, E] or flat [B, S*E]."""
    if stem.dim() == 3:
        stem = stem.reshape(stem.shape[0], -1)
    return model.forward_embedded(dense_x, stem, masks, impl, compute_dtype)
