"""Standalone fixed-subnet model built from a choice (port of
`nasrec_tpu/models/fixed.py`).

Reference: SuperNet(fixed=True, fixed_choice=...) (ref: nasrec/supernet/
supernet.py:945-982 node construction, :604-668 fixed_forward, :1185-1242
block fixed_forward).  Non-selected inputs are dropped, only the chosen nodes
exist with exact dims, and projections are elided where the incoming width
already matches; `build_fixed_plan` makes those decisions statically.

Sparse activations flow in the flat slot-major [B, S*E] layout between blocks
(see ops/common.py), as in the JAX package, so the module tree and its
parameter names mirror the JAX pytree and `models/transplant.py` maps one to
the other by name.

`compute_dtype` (float32 or bfloat16) is the activations' dtype, as in
`nasrec_tpu/models/fixed.py :: fixed_apply`: the dense input and the
looked-up stem are cast to it once, every op keeps it (ops/common.py), and
the logits come back float32.  The parameters stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn

from nasrec_tpu_torch.choices import Choice, validate_choice
from nasrec_tpu_torch.config import (
    DEFAULT_EMBEDDING_DIM,
    DS_INTERACT_NUM_SPLITS,
    OpsConfig,
)
from nasrec_tpu_torch.models.embedding import EmbeddingStem
from nasrec_tpu_torch.ops.attention import Transformer
from nasrec_tpu_torch.ops.common import LayerNorm, Linear
from nasrec_tpu_torch.ops.interactions import FM3D, DotProduct, SigmoidGating, Sum
from nasrec_tpu_torch.ops.linear import ElasticLinear, ElasticLinear3D


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static structure of one fixed choice block."""

    active_nodes: Tuple[int, ...]        # node indices into space.node_names
    dense_dim: int
    sparse_dim: int
    interact: bool
    deep_fm: bool
    dense_idx: Tuple[int, ...]           # ascending virtual-block selections
    sparse_idx: Tuple[int, ...]
    left_idx: Tuple[int, ...]
    right_idx: Tuple[int, ...]
    dense_in: int                        # concat widths
    sparse_in: int
    left_in: int
    right_in: int
    out_slots: int                       # sparse_dim (+8 if interact)


@dataclasses.dataclass(frozen=True)
class FixedPlan:
    space: OpsConfig
    num_blocks: int
    num_dense: int
    num_sparse: int
    vocab_sizes: Tuple[int, ...]
    emb_dim: int
    use_layernorm: bool
    activation: str
    blocks: Tuple[BlockPlan, ...]
    head_width: int
    use_final_sigmoid: bool = False
    # Head fan-in: outputs of the last n blocks (ref: supernet.py:226,657-660).
    last_n_blocks_out: int = 1


def build_fixed_plan(
    choice: Choice,
    space: OpsConfig,
    num_blocks: int,
    num_dense: int,
    num_sparse: int,
    vocab_sizes: Tuple[int, ...],
    emb_dim: int = DEFAULT_EMBEDDING_DIM,
    use_layernorm: bool = False,
    activation: str = "relu",
    use_final_sigmoid: bool = False,
    last_n_blocks_out: int = 1,
) -> FixedPlan:
    validate_choice(choice, space, num_blocks)
    dense_w: List[int] = [num_dense]      # virtual-block dense widths
    sparse_s: List[int] = [num_sparse]    # virtual-block sparse slot counts
    blocks: List[BlockPlan] = []
    for i in range(num_blocks):
        m, mi = choice["macro"][i], choice["micro"][i]
        dense_idx = tuple(sorted(set(int(j) for j in m["dense_idx"])))
        sparse_idx = tuple(sorted(set(int(j) for j in m["sparse_idx"])))
        left_idx = tuple(sorted(set(int(j) for j in m["dense_left_idx"])))
        right_idx = tuple(sorted(set(int(j) for j in m["dense_right_idx"])))
        interact = bool(int(mi["dense_sparse_interact"]))
        bp = BlockPlan(
            active_nodes=tuple(sorted(int(a) for a in mi["active_nodes"])),
            dense_dim=int(mi["dense_in_dims"]),
            sparse_dim=int(mi["sparse_in_dims"]),
            interact=interact,
            deep_fm=bool(int(mi["deep_fm"])),
            dense_idx=dense_idx,
            sparse_idx=sparse_idx,
            left_idx=left_idx,
            right_idx=right_idx,
            dense_in=sum(dense_w[j] for j in dense_idx),
            sparse_in=sum(sparse_s[j] for j in sparse_idx),
            left_in=sum(dense_w[j] for j in left_idx),
            right_in=sum(dense_w[j] for j in right_idx),
            out_slots=int(mi["sparse_in_dims"])
            + (DS_INTERACT_NUM_SPLITS if interact else 0),
        )
        blocks.append(bp)
        dense_w.append(bp.dense_dim)
        sparse_s.append(bp.out_slots)
    # The head concats the last n dense outputs on the feature axis and the
    # last n sparse outputs on the EMB axis (ref: supernet.py:657-660), which
    # needs equal slot counts across those blocks.
    n = last_n_blocks_out
    if n > 1 and len(set(sparse_s[-n:])) != 1:
        raise ValueError(
            f"last_n_blocks_out={n} needs equal sparse slot counts in the "
            f"final {n} blocks (got {sparse_s[-n:]}); the reference's "
            f"torch.cat(dim=-1) has the same constraint"
        )
    head_width = sum(dense_w[-n:]) + sparse_s[-1] * emb_dim * n
    return FixedPlan(
        space=space, num_blocks=num_blocks, num_dense=num_dense,
        num_sparse=num_sparse, vocab_sizes=tuple(int(v) for v in vocab_sizes),
        emb_dim=emb_dim, use_layernorm=use_layernorm, activation=activation,
        blocks=tuple(blocks), head_width=head_width,
        use_final_sigmoid=use_final_sigmoid, last_n_blocks_out=last_n_blocks_out,
    )


# Which of a block's inputs each node type reads.
_READS_DENSE = ("linear-2d", "zeros-2d", "dot-product")
_READS_SPARSE = ("dot-product", "transformer", "linear-3d", "zeros-3d")
_READS_SIDES = ("sum", "sigmoid-gating")


def _block_reads(plan: FixedPlan, bp: BlockPlan) -> Tuple[bool, bool, bool]:
    """(dense, sparse, left/right): which inputs the block's nodes read."""
    names = [plan.space.node_names[k] for k in bp.active_nodes]
    return tuple(any(n in kind for n in names)
                 for kind in (_READS_DENSE, _READS_SPARSE, _READS_SIDES))


def live_blocks(plan: FixedPlan) -> Tuple[bool, ...]:
    """Which blocks the logits depend on.  A searched arch may hold blocks
    whose outputs neither a later live block nor the head reads (blocks 3-5 of
    criteo-kaggle/xlarge).  The JAX package traces them and XLA removes them
    from the compiled step; this eager port skips them itself, forward and
    backward.  Their parameters stay in the model with zero gradients."""
    n = plan.num_blocks
    live = [False] * (n + 1)            # virtual index 0: the model's inputs
    for v in range(n, n - plan.last_n_blocks_out, -1):
        live[v] = True
    for v in range(n, 0, -1):
        if not live[v]:
            continue
        bp = plan.blocks[v - 1]
        dense, sparse, sides = _block_reads(plan, bp)
        for j in ((bp.dense_idx if dense else ()) + (bp.sparse_idx if sparse else ())
                  + (bp.left_idx + bp.right_idx if sides else ())):
            live[j] = True
    return tuple(live[1:])


def _make_node(plan: FixedPlan, bp: BlockPlan, name: str, gen, device) -> nn.Module:
    uln = plan.use_layernorm
    if name == "linear-2d":
        return ElasticLinear(bp.dense_in, bp.dense_dim, uln, gen, device)
    if name in ("zeros-2d", "zeros-3d"):
        return nn.Identity()
    if name == "sum":
        return Sum(bp.left_in, bp.right_in, bp.dense_dim, uln, gen, device)
    if name == "sigmoid-gating":
        return SigmoidGating(bp.left_in, bp.right_in, bp.dense_dim, uln, gen, device)
    if name == "dot-product":
        return DotProduct(bp.dense_in, bp.sparse_in, bp.dense_dim, plan.emb_dim, uln,
                          gen, device)
    if name == "transformer":
        return Transformer(bp.sparse_in, bp.sparse_dim, plan.emb_dim, uln, gen, device)
    if name == "linear-3d":
        return ElasticLinear3D(bp.sparse_in, bp.sparse_dim, uln, gen, device)
    raise NotImplementedError(name)


def _concat(tensors: List[torch.Tensor], idx: Tuple[int, ...]) -> torch.Tensor:
    parts = [tensors[j] for j in idx]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


class FixedBlock(nn.Module):
    def __init__(self, plan: FixedPlan, bp: BlockPlan, gen, device):
        super().__init__()
        self.bp = bp
        self.node_names = {k: plan.space.node_names[k] for k in bp.active_nodes}
        self.emb_dim = plan.emb_dim
        self.activation = plan.activation
        self.nodes = nn.ModuleDict({
            str(k): _make_node(plan, bp, name, gen, device)
            for k, name in self.node_names.items()
        })
        expanded = DS_INTERACT_NUM_SPLITS * plan.emb_dim
        self.ds_proj = self.ds_ln = self.deep_fm = None
        if bp.interact and bp.dense_dim != expanded:   # ref: supernet.py:1219-1226
            self.ds_proj = Linear(bp.dense_dim, expanded, not plan.use_layernorm, gen, device)
            if plan.use_layernorm:
                self.ds_ln = LayerNorm(expanded, device=device)
        if bp.deep_fm:                                  # ref: supernet.py:998-1003
            self.deep_fm = FM3D(plan.emb_dim, bp.dense_dim, plan.use_layernorm, gen, device)

    def forward(self, dense_in, sparse_in, left_in, right_in, impl: str):
        bp, e = self.bp, self.emb_dim
        dense_outs, sparse_outs = [], []
        for k, name in self.node_names.items():
            node = self.nodes[str(k)]
            if name == "linear-2d":
                dense_outs.append(node(dense_in, self.activation))
            elif name == "zeros-2d":
                dense_outs.append(dense_in.new_zeros((dense_in.shape[0], bp.dense_dim)))
            elif name in ("sum", "sigmoid-gating"):
                dense_outs.append(node(left_in, right_in))
            elif name == "dot-product":
                dense_outs.append(node(dense_in, sparse_in, bp.sparse_in, e, impl))
            elif name == "transformer":
                sparse_outs.append(node(sparse_in, e, impl=impl))
            elif name == "linear-3d":
                sparse_outs.append(node(sparse_in, e, self.activation))
            elif name == "zeros-3d":
                sparse_outs.append(sparse_in.new_zeros((sparse_in.shape[0], bp.sparse_dim * e)))
            else:
                raise NotImplementedError(name)
        dense_out = sum(dense_outs)
        sparse_out = sum(sparse_outs)

        # ds-interact projection from the PRE-deep-fm dense output (ref ordering).
        if bp.interact:
            proj = dense_out
            if self.ds_proj is not None:
                proj = self.ds_proj(dense_out)
                if self.ds_ln is not None:
                    proj = self.ds_ln(proj)
        if self.deep_fm is not None:
            dense_out = dense_out + self.deep_fm(sparse_out, bp.sparse_dim, e)
        if bp.interact:
            # proj [B, 8*E] IS the slot-major flat of the 8 pseudo-slots the
            # reference reshapes to [B, 8, E] (ref: supernet.py:1137-1161).
            sparse_out = torch.cat([sparse_out, proj], dim=-1)
        return dense_out, sparse_out


class FixedModel(nn.Module):
    """Parameters: embedding.table, blocks.<i>.{nodes.<k>, ds_proj, ds_ln,
    deep_fm}, final — the JAX pytree's structure and names."""

    def __init__(self, plan: FixedPlan, generator: torch.Generator, device=None):
        super().__init__()
        self.plan = plan
        self.embedding = EmbeddingStem(plan.vocab_sizes, plan.emb_dim, generator, device)
        self.blocks = nn.ModuleList(
            FixedBlock(plan, bp, generator, device) for bp in plan.blocks
        )
        self.final = Linear(plan.head_width, 1, True, generator, device)
        self.live = live_blocks(plan)
        self.reads = tuple(_block_reads(plan, bp) for bp in plan.blocks)

    def forward_embedded(self, dense_x: torch.Tensor, stem: torch.Tensor,
                         impl: str = "auto",
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Forward from a looked-up flat stem [B, S*E] -> float32 logits [B, 1]."""
        plan = self.plan
        dense_list = [dense_x.to(compute_dtype)]
        sparse_list = [stem.to(compute_dtype)]
        for bp, block, live, (dense, sparse, sides) in zip(
                plan.blocks, self.blocks, self.live, self.reads):
            if not live:                 # nothing downstream reads this block
                dense_list.append(None)
                sparse_list.append(None)
                continue
            dense_out, sparse_out = block(
                _concat(dense_list, bp.dense_idx) if dense else None,
                _concat(sparse_list, bp.sparse_idx) if sparse else None,
                _concat(dense_list, bp.left_idx) if sides else None,
                _concat(dense_list, bp.right_idx) if sides else None,
                impl,
            )
            dense_list.append(dense_out)
            sparse_list.append(sparse_out)
        n = plan.last_n_blocks_out
        flat_dense = torch.cat(dense_list[-n:], dim=-1) if n > 1 else dense_list[-1]
        if n > 1:
            # The reference concats the tail sparse outputs on the EMB axis
            # before flattening (ref: supernet.py:657-660).
            e = plan.emb_dim
            tail = [s.reshape(s.shape[0], s.shape[-1] // e, e) for s in sparse_list[-n:]]
            flat_sparse = torch.cat(tail, dim=-1).reshape(dense_x.shape[0], -1)
        else:
            flat_sparse = sparse_list[-1]  # flat layout == the reference flatten
        out = self.final(torch.cat([flat_dense, flat_sparse], dim=-1)).float()
        if plan.use_final_sigmoid:
            out = torch.sigmoid(out)
        return out

    def forward(self, dense_x: torch.Tensor, cat_x: torch.Tensor, impl: str = "auto",
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.forward_embedded(dense_x, self.embedding(cat_x), impl, compute_dtype)


def fixed_init(plan: FixedPlan, seed: int = 0, device="cpu") -> FixedModel:
    """A freshly initialised model on `device`, drawn from a torch.Generator
    seeded with `seed` (not JAX's PRNG: parity goes through transplant).  On
    the `meta` device (shapes only, for counting) nothing is drawn."""
    gen_device = "cpu" if torch.device(device).type == "meta" else device
    gen = torch.Generator(device=gen_device).manual_seed(seed)
    return FixedModel(plan, gen, device)


def fixed_apply(model: FixedModel, dense_x, cat_x, impl: str = "auto",
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Forward pass of the fixed subnet -> float32 logits [B, 1]."""
    return model(dense_x, cat_x, impl, compute_dtype)


def fixed_apply_embedded(model: FixedModel, dense_x, stem, impl: str = "auto",
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Forward with a precomputed stem, [B, S, E] or flat [B, S*E]."""
    if stem.dim() == 3:
        stem = stem.reshape(stem.shape[0], -1)
    return model.forward_embedded(dense_x, stem, impl, compute_dtype)
