"""The final-only group's own forward of the frozen supernet body: each
candidate's GEMMs cut to the rows and columns its choice leaves non-zero.

The supernet's masked forward (`models/supernet.py ::
SuperNet.head_features_embedded`) computes every node of every block at its
widest for every candidate and multiplies the outputs by 0/1 gates, so that
training and the whole-net modes run one launch sequence for every subnet,
with gradients to every weight and no mask read on the host.  The
final-only group (`search/worker.py :: FinalOnlyGroup`) needs neither: its
body is frozen for the group's life and its K choices are host values.
`PrunedBody` reads them once, when the group is made, and cuts each
candidate's copy of every GEMM weight of the body to what its choice
reaches; the group's fine-tune steps and eval chunks all reuse the cut
weights.  Nothing is kept from one batch to the next.

Cut (exact up to the order of a GEMM's sums: the masked forward adds the same
products, and products with zeros):
  - the reduction columns of a GEMM's input that a selector (`dense_sel`,
    `left_sel`, `right_sel`, `sparse_sel`), an earlier block's width mask or
    its `interact` gate leaves zero: ElasticLinear, Sum.proj,
    SigmoidGating.self_linear and .proj, ElasticLinear3D, ds_proj;
  - SigmoidGating.self_linear's output columns where `right` is zero
    (sigmoid(.) * 0 is 0), so that .proj reduces over `right`'s columns only;
  - the whole GEMM of a node whose gate is 0, ds_proj where `interact` is 0,
    FM3D's projection where `deep_fm` is 0, and every GEMM of a block that
    neither the head nor a live block reads.  Such a candidate's share of the
    node's output is the exact zero the gate would make of it.
Kept:
  - LayerNorm over the full width before the width mask: every node's output
    is as wide as in the masked forward;
  - the transformer and dot-product nodes, run on the masked forward's
    full-width inputs for all K candidates folded into one batch of K B
    rows, so that their kernels launch once a block for the group at the
    shapes the masked forward's vmap rule folds to;
  - the zero slots in a transformer's softmax (dropping them is not exact).

A node's cut GEMM runs once for each candidate that needs it, at that
candidate's own widths: its input is a slice of the block outputs' columns
where they are one range (a gating node's two sides always are), else an
index_select of them.  The node's LayerNorm, activation and width mask then
run once on those Ka candidates' outputs, [Ka, B, N], and the result is
added into the block's output in the masked forward's node order.  ds_proj
and FM3D's projection run with the shared weight over the candidates that
need them, up to the widest one's input (a narrower one's is zero past its
width).  The blocks' outputs lie side by side in one [K, B, *] buffer a
forward (dense, and the flat sparse slots) in the masked forward's
concatenation order, so that a slice, a gather or a hand-written node's
masked input reads them in place.

Two host counters go to the open span (`search.finetune`, `search.eval`),
from shapes alone: `search.gemm_macs_run`, the multiply-adds of the cut
GEMMs (their padding included) over the forward's rows, and
`search.gemm_macs_masked`, those of the same GEMMs in the masked forward.
The transformer's and the dot product's own projections run alike on both
and are in neither.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.choices import ChoiceMasks
from nasrec_tpu_torch.config import DS_INTERACT_NUM_SPLITS
from nasrec_tpu_torch.models.supernet import SuperNet, SuperNetConfig
from nasrec_tpu_torch.ops.common import ACTIVATIONS, layer_norm_cast

DENSE_NODES = ("linear-2d", "sum", "sigmoid-gating", "dot-product")
SPARSE_NODES = ("transformer", "linear-3d")
HAND_WRITTEN = ("dot-product", "transformer")
SELECTORS = ("dense_sel", "sparse_sel", "left_sel", "right_sel")


class _Reach:
    """What one candidate's choice leaves non-zero, from its host masks:
    the columns of each virtual block's dense output (a prefix) and its
    flat sparse slots, and which blocks are live."""

    def __init__(self, cfg: SuperNetConfig, m: ChoiceMasks):
        nb, names = cfg.num_blocks, cfg.space.node_names
        self.act = np.asarray(m.node_act) > 0
        self.sel = {s: np.asarray(getattr(m, s)) > 0 for s in SELECTORS}
        self.interact = np.asarray(m.interact) > 0
        self.deep_fm = np.asarray(m.deep_fm) > 0
        ddim = np.asarray(m.dense_dim).sum(axis=1).astype(int)
        sdim = np.asarray(m.sparse_dim).sum(axis=1).astype(int)
        on = {kind: [any(self.act[b, n] for n, x in enumerate(names) if x in nodes)
                     for b in range(nb)] for kind, nodes in (("dense", DENSE_NODES),
                                                             ("sparse", SPARSE_NODES))}
        # Block b's dense output before its deep-fm term (ds_proj's input).
        self.pre_fm = [int(ddim[b]) if on["dense"][b] else 0 for b in range(nb)]
        dense_nz = [cfg.num_dense] + [int(ddim[b]) if on["dense"][b] or self.deep_fm[b] else 0
                                      for b in range(nb)]
        ms = cfg.space.max_sparse_dim
        slots = [[(0, cfg.num_sparse)]] + [
            ([(0, int(sdim[b]))] if on["sparse"][b] else [])
            + ([(ms, ms + DS_INTERACT_NUM_SPLITS)] if self.interact[b] else [])
            for b in range(nb)]
        # Each virtual block's non-zero columns in the concatenations.
        self.dense_cols, self.slots = [], []
        for j in range(nb + 1):
            off = sum(cfg.dense_width(x) for x in range(j))
            soff = sum(cfg.sparse_slots(x) for x in range(j))
            self.dense_cols.append(np.arange(off, off + dense_nz[j]))
            self.slots.append(_cat([np.arange(soff + a, soff + b) for a, b in slots[j]]))
        self.live = [b >= nb - cfg.last_n_blocks_out for b in range(nb)]
        for b in reversed(range(nb)):
            if self.live[b]:
                for s in SELECTORS:
                    for j in range(1, b + 1):
                        self.live[j - 1] |= bool(self.sel[s][b, j])

    def chosen(self, sel: str, i: int) -> List[int]:
        return [int(j) for j in np.flatnonzero(self.sel[sel][i])]

    def cols(self, sel: str, i: int) -> np.ndarray:
        return _cat([self.dense_cols[j] for j in self.chosen(sel, i)])


def _ln(ln: Optional[torch.nn.LayerNorm], x: torch.Tensor) -> torch.Tensor:
    """The LayerNorm `ln` on x (x where there is none), through the
    function the module calls."""
    if ln is None:
        return x
    return layer_norm_cast(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def _proj(linear: Optional[torch.nn.Linear], what: str) -> torch.nn.Linear:
    """A projection the cut needs; a node without one (its input as wide
    as its output, which no space of the port has) is refused."""
    if linear is None:
        raise ValueError(f"{what} has no projection (its input as wide as its output): "
                         "the pruned body does not cut it")
    return linear


def _cat(parts: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


@dataclasses.dataclass
class _Cut:
    """One candidate's cut GEMM: its input, columns `cols` of its rows of the
    source (a (start, stop) slice where they are one range, else an index
    tensor), times `weight`^T [N, D], plus `bias` [N]."""

    cols: object
    weight: torch.Tensor
    bias: Optional[torch.Tensor]

    def input(self, src: torch.Tensor) -> torch.Tensor:
        if isinstance(self.cols, tuple):
            return src[:, self.cols[0]:self.cols[1]]
        return src.index_select(1, self.cols)

    def into(self, x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.bias is None:
            return torch.mm(x, self.weight.t(), out=out)
        return torch.addmm(self.bias, x, self.weight.t(), out=out)


@dataclasses.dataclass
class _Stage:
    """A GEMM of one block for the candidates `ks` it runs for: each
    candidate's `cuts` (sigmoid-gating: its gate's, its right side's columns
    and its projection's), `width`, the output's (ds_proj's: the input
    columns it reads), and `gate`, [Ka, 1, N] (or [Ka, 1, 1, S]), which
    multiplies the output."""

    ks: List[int]
    kidx: torch.Tensor
    cuts: List[Tuple[_Cut, ...]]
    width: int
    gate: torch.Tensor


def _columns(cols: np.ndarray, device):
    """A (start, stop) slice where cols are one ascending range, else an
    index tensor."""
    if len(cols) and np.array_equal(cols, np.arange(cols[0], cols[0] + len(cols))):
        return int(cols[0]), int(cols[0]) + len(cols)
    if not len(cols):
        return 0, 0
    return torch.as_tensor(cols, device=device)


def _cut(linear: torch.nn.Linear, cols: np.ndarray, rows: Optional[np.ndarray] = None,
         src_cols: Optional[np.ndarray] = None, twice: Optional[np.ndarray] = None) -> _Cut:
    """linear cut to its input columns `cols` (and output rows `rows`),
    reading the source's columns src_cols (cols where None); the input
    columns `twice` read twice (their weight doubled)."""
    w = linear.weight.detach()
    b = None if linear.bias is None else linear.bias.detach()
    if rows is not None:
        r = torch.as_tensor(rows, device=w.device)
        w, b = w.index_select(0, r), None if b is None else b.index_select(0, r)
    w = w.index_select(1, torch.as_tensor(cols, device=w.device))
    if twice is not None and twice.any():
        w[:, torch.as_tensor(np.flatnonzero(twice), device=w.device)] *= 2
    return _Cut(_columns(cols if src_cols is None else src_cols, w.device), w, b)


class PrunedBody:
    """The frozen body of `supernet` under K choices (their host masks
    `host`, stacked; `masks` the same on the device): `features(dense, stem)
    -> [K, B, head_width]` float32, as vmap(head_features_embedded) over the
    choices computes them.  `macs_run` / `macs_masked`: the cut GEMMs'
    multiply-adds a row for the K candidates, and the masked forward's."""

    def __init__(self, supernet: SuperNet, host: ChoiceMasks, masks: ChoiceMasks, impl: str):
        cfg = self.cfg = supernet.cfg
        self.supernet, self.impl = supernet, impl
        self.k = host.node_act.shape[0]
        self.device = dev = supernet.final.weight.device
        reach = [_Reach(cfg, host.select(k)) for k in range(self.k)]
        e, nb = cfg.emb_dim, cfg.num_blocks
        self.dense_off = [sum(cfg.dense_width(x) for x in range(j)) for j in range(nb + 2)]
        self.slot_off = [sum(cfg.sparse_slots(x) for x in range(j)) for j in range(nb + 2)]
        self.macs_run = self.macs_masked = 0
        self.stages: List[Dict[object, Optional[_Stage]]] = []
        for i, block in enumerate(supernet.blocks):
            stages = {}
            for n, name in enumerate(cfg.space.node_names):
                if name in ("linear-2d", "sum", "sigmoid-gating", "linear-3d"):
                    ks = [k for k, r in enumerate(reach) if r.live[i] and r.act[i, n]]
                    stages[n] = self._node_stage(reach, ks, i, name, block.nodes[n], host)
            # ds_proj and FM3D's projection run with the shared weight: a
            # candidate's input is zero past its width, where the width
            # differs.
            for key, linear, on in (("ds", block.ds_proj, "interact"),
                                    ("fm", block.deep_fm.proj, "deep_fm")):
                linear = _proj(linear, f"block {i}'s {key}")
                ks = [k for k, r in enumerate(reach) if r.live[i] and getattr(r, on)[i]]
                width = (max([reach[k].pre_fm[i] for k in ks], default=0) if key == "ds"
                         else linear.in_features)
                self.macs_masked += self.k * linear.weight.numel()
                self.macs_run += len(ks) * width * linear.out_features
                stages[key] = (_Stage(ks, torch.as_tensor(ks, device=dev), [], width,
                                      torch.as_tensor(host.dense_dim[ks, i][:, None, :],
                                                      device=dev))
                               if ks else None)
            self.stages.append(stages)
        # Per block, the hand-written nodes' gates and masks, [K, 1, 1] and
        # [K, W], and their masked full-width inputs' masks: each virtual
        # block's columns times its selector, [K, 1, width of the concat].
        self.hand_gate = masks.node_act[:, :, :, None, None]
        self.dense_mask, self.slot_mask = masks.dense_dim, masks.sparse_dim
        self.dense_in_mask, self.sparse_in_mask = [], []
        for i in range(nb):
            dm = np.zeros((self.k, 1, self.dense_off[i + 1]), np.float32)
            sm = np.zeros((self.k, 1, self.slot_off[i + 1] * e), np.float32)
            for j in range(i + 1):
                dm[:, 0, self.dense_off[j]:self.dense_off[j + 1]] = host.dense_sel[:, i, j, None]
                sm[:, 0, self.slot_off[j] * e:self.slot_off[j + 1] * e] = \
                    host.sparse_sel[:, i, j, None]
            self.dense_in_mask.append(torch.as_tensor(dm, device=dev))
            self.sparse_in_mask.append(torch.as_tensor(sm, device=dev))

    def _node_stage(self, reach: List[_Reach], ks: List[int], i: int, name: str, node,
                    host: ChoiceMasks) -> Optional[_Stage]:
        """Node `name` of block i cut for each candidate of ks; its
        multiply-adds counted on both forwards."""
        e, dev = self.cfg.emb_dim, self.device
        cuts = []
        if name == "linear-3d":
            self.macs_masked += self.k * e * node.linear.weight.numel()
            for k in ks:
                slots = _cat([reach[k].slots[j] for j in reach[k].chosen("sparse_sel", i)])
                # The slots' flat columns e-major: the rows [B, E, slots].
                flat = (slots[None, :] * e + np.arange(e)[:, None]).reshape(-1)
                cuts.append((_cut(node.linear, slots, src_cols=flat),))
                self.macs_run += e * cuts[-1][0].weight.numel()
            gate = host.sparse_dim[ks, i][:, None, None, :]
            width = node.linear.out_features
        else:
            linear = node.linear if name == "linear-2d" else _proj(node.proj, f"block {i}'s {name}")
            self.macs_masked += self.k * linear.weight.numel()
            if name == "sigmoid-gating":
                self.macs_masked += self.k * node.self_linear.weight.numel()
            for k in ks:
                r = reach[k]
                if name == "linear-2d":
                    cuts.append((_cut(linear, r.cols("dense_sel", i)),))
                elif name == "sum":
                    # left + right: a column both read is doubled, which a
                    # doubled weight column gives exactly.
                    left, right = r.cols("left_sel", i), r.cols("right_sel", i)
                    cols = np.union1d(left, right)
                    cuts.append((_cut(linear, cols, twice=np.isin(cols, np.intersect1d(
                        left, right))),))
                else:
                    left, right = r.cols("left_sel", i), r.cols("right_sel", i)
                    cuts.append((_cut(node.self_linear, left, rows=right),
                                 _Cut(_columns(right, dev), None, None), _cut(linear, right)))
                self.macs_run += sum(c.weight.numel() for c in cuts[-1] if c.weight is not None)
            gate = host.dense_dim[ks, i][:, None, :]
            width = linear.out_features
        if not ks:
            return None
        return _Stage(ks, torch.as_tensor(ks, device=dev), cuts, width,
                      torch.as_tensor(gate, device=dev))

    def _run(self, stage: _Stage, src: torch.Tensor, emb: int = 0) -> torch.Tensor:
        """[Ka, B, N] (emb: [Ka, B, emb, N]): each of the stage's
        candidates' cut GEMM over its columns of src [K, B, *]."""
        rows = src.shape[1]
        out = src.new_empty((len(stage.ks), rows * max(emb, 1), stage.width))
        for a, (k, cut) in enumerate(zip(stage.ks, stage.cuts)):
            x = cut[0].input(src[k])
            if emb:
                x = x.view(rows * emb, x.shape[1] // emb)
            if len(cut) == 3:       # sigmoid-gating
                x = torch.sigmoid_(cut[0].into(x)).mul_(cut[1].input(src[k]))
            cut[-1].into(x, out=out[a])
        return out.view(len(stage.ks), rows, emb, -1) if emb else out

    def _add(self, acc: torch.Tensor, y: torch.Tensor, stage: Optional[_Stage],
             first: bool) -> None:
        """acc [K, B, N] += y, the output of `stage`'s candidates (all K
        where stage is None); `first`: acc holds nothing yet."""
        if stage is not None and len(stage.ks) < self.k:
            if first:
                acc.zero_()
            acc.index_add_(0, stage.kidx, y)
        elif first:
            acc.copy_(y)
        else:
            acc.add_(y)

    def _rows_of(self, t: torch.Tensor, stage: _Stage) -> torch.Tensor:
        """The stage's candidates' rows of t [K, ...]."""
        return t if len(stage.ks) == self.k else t.index_select(0, stage.kidx)

    @torch.no_grad()
    def features(self, dense: torch.Tensor, stem: torch.Tensor) -> torch.Tensor:
        """[K, B, head_width] float32 from dense [B, num_dense] and the
        looked-up flat stem [B, S*E]."""
        cfg, k, rows, e = self.cfg, self.k, dense.shape[0], self.cfg.emb_dim
        tracing.count("search.gemm_macs_run", rows * self.macs_run)
        tracing.count("search.gemm_macs_masked", rows * self.macs_masked)
        nb = cfg.num_blocks
        dense_buf = dense.new_empty((k, rows, self.dense_off[nb + 1]), dtype=torch.float32)
        sparse_buf = dense.new_empty((k, rows, self.slot_off[nb + 1] * e), dtype=torch.float32)
        dense_buf[:, :, :cfg.num_dense] = dense
        sparse_buf[:, :, :cfg.num_sparse * e] = stem
        for i in range(nb):
            self._block(i, dense_buf, sparse_buf)
        n = cfg.last_n_blocks_out
        flat_dense = dense_buf[:, :, self.dense_off[nb + 1 - n]:]
        flat_sparse = sparse_buf[:, :, self.slot_off[nb + 1 - n] * e:]
        if n > 1:
            # The tail sparse outputs concatenated on the emb axis, then flat
            # (ref: supernet.py:657-660).
            tail = [sparse_buf[:, :, self.slot_off[j] * e:self.slot_off[j + 1] * e]
                    .reshape(k, rows, -1, e) for j in range(nb + 1 - n, nb + 1)]
            flat_sparse = torch.cat(tail, dim=-1).reshape(k, rows, -1)
        return torch.cat([flat_dense, flat_sparse], dim=-1)

    def _block(self, i: int, dense_buf: torch.Tensor, sparse_buf: torch.Tensor) -> None:
        """Block i's outputs into its columns of the two buffers."""
        cfg, e, k = self.cfg, self.cfg.emb_dim, self.k
        rows = dense_buf.shape[1]
        block, stages = self.supernet.blocks[i], self.stages[i]
        activation = ACTIVATIONS[cfg.activation]
        acc_d = dense_buf[:, :, self.dense_off[i + 1]:self.dense_off[i + 2]]
        s0, s1 = self.slot_off[i + 1] * e, self.slot_off[i + 2] * e
        nodes_w = cfg.space.max_sparse_dim * e          # the nodes' slots; then the merge's
        acc_s, merge = sparse_buf[:, :, s0:s0 + nodes_w], sparse_buf[:, :, s0 + nodes_w:s1]
        first_d = first_s = True
        hand = None
        for n, name in enumerate(cfg.space.node_names):
            node = block.nodes[n]
            if name in HAND_WRITTEN:
                if hand is None:
                    d_in = dense_buf[:, :, :self.dense_off[i + 1]] * self.dense_in_mask[i]
                    s_in = sparse_buf[:, :, :s0] * self.sparse_in_mask[i]
                    hand = (d_in.view(k * rows, -1), s_in.view(k * rows, -1))
                if name == "dot-product":
                    out = node(*hand, cfg.block_sparse_in(i), e, self.impl, self.dense_mask[:, i])
                    acc, first_d, first = acc_d, False, first_d
                else:
                    out = node(hand[1], e, impl=self.impl, slot_mask=self.slot_mask[:, i])
                    acc, first_s, first = acc_s, False, first_s
                # acc (+)= out times its 0/1 gate, in one op.
                out, gate = out.view(k, rows, -1), self.hand_gate[:, i, n]
                if first:
                    torch.mul(out, gate, out=acc)
                else:
                    acc.addcmul_(out, gate)
                continue
            stage = stages.get(n)
            if stage is None:
                continue        # a zeros node, or every candidate's gate is 0 here
            if name == "linear-3d":
                y = self._run(stage, sparse_buf, emb=e)                 # [Ka, B, E, S]
                y = activation(_ln(node.ln, y)).mul_(stage.gate)
                self._add(acc_s.view(k, rows, -1, e), y.transpose(2, 3), stage, first_s)
                first_s = False
                continue
            y = self._run(stage, dense_buf)
            y = _ln(node.ln, y)
            if name == "linear-2d":
                y = activation(y)
            self._add(acc_d, y.mul_(stage.gate), stage, first_d)
            first_d = False
        if first_d:
            acc_d.zero_()
        if first_s:
            acc_s.zero_()

        # Dense -> sparse merge from the dense output before its deep-fm
        # term; `interact` is 1 for the stage's candidates.
        ds = stages["ds"]
        if ds is None:
            merge.zero_()
        else:
            w = block.ds_proj.weight[:, :ds.width]
            y = torch.nn.functional.linear(self._rows_of(acc_d[:, :, :ds.width], ds), w,
                                           block.ds_proj.bias)
            self._add(merge, _ln(block.ds_ln, y), ds, True)
        # DeepFM: sparse -> dense residual.
        fm = stages["fm"]
        if fm is not None:
            x = acc_s.reshape(k, rows, cfg.space.max_sparse_dim, e)
            ix = torch.square(x.sum(dim=2)) - torch.square(x).sum(dim=2)
            y = block.deep_fm.proj(self._rows_of(ix, fm))
            self._add(acc_d, _ln(block.deep_fm.ln, y).mul_(fm.gate), fm, False)
