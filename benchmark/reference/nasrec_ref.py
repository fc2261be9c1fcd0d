"""Plain PyTorch reference of the NASRec models and of their training step.

Written from the NASRec paper (arXiv:2207.07187) and its reference code
(github.com/facebookresearch/NasRec, `nasrec/supernet/{supernet,modules}.py`),
after the plain forms of the port, and importing nothing of the port.  A
model is built from a configuration file of `benchmark/configs/` alone; its
parameters carry the port's names, so that one set of weights, made by the
benchmark, loads into both.  Everything here is float32 op by op (no fused
kernel, no cache, no batching trick):

  - the fused embedding table is looked up by index, and its gradient is the
    dense [rows, 16] scatter-sum of the looked-up rows' gradients;
  - the step is BCE on the logits, the global-norm clip at `grad_clip` over
    every gradient (the table's dense gradient included), then torch's dense
    Adagrad (zero initial accumulator, eps after the sqrt) on every parameter,
    the table included: untouched rows get a zero gradient, and so neither
    their value nor their accumulator moves.

`FixedRef` is a published best subnet (blocks whose outputs nothing reads are
skipped, forward and backward); `SuperNetRef` is the weight-sharing supernet,
every node at its widest, the sampled subnet applied as 0/1 masks
(`choice_masks`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-5

_READS_DENSE = ("linear-2d", "zeros-2d", "dot-product")
_READS_SPARSE = ("dot-product", "transformer", "linear-3d", "zeros-3d")
_READS_SIDES = ("sum", "sigmoid-gating")


def act_fn(name: str):
    return {"relu": F.relu, "silu": F.silu, "identity": lambda x: x}[name]


def masked(x, mask, axis: int = -1):
    if mask is None:
        return x
    shape = [1] * x.ndim
    shape[axis] = mask.shape[0]
    return x * mask.reshape(shape)


def lin(x, layer: Optional[nn.Linear]):
    return x if layer is None else F.linear(x, layer.weight, layer.bias)


def norm(x, layer: Optional[nn.LayerNorm]):
    return x if layer is None else F.layer_norm(x, layer.normalized_shape, layer.weight,
                                                layer.bias, LN_EPS)


def Lin(i: int, o: int, bias: bool = True) -> nn.Linear:
    return nn.Linear(i, o, bias=bias)


def LN(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class ElasticLinear(nn.Module):
    """out = act(LN(x W^T + b)) over the features (bias only without LN)."""

    def __init__(self, d_in, d_out, uln):
        super().__init__()
        self.linear = Lin(d_in, d_out, not uln)
        self.ln = LN(d_out) if uln else None

    def forward(self, x, act, mask=None):
        return masked(act_fn(act)(norm(lin(x, self.linear), self.ln)), mask)


class ElasticLinear3D(nn.Module):
    """The same over the slot axis of [B, S, E]: [B, S_in*E] -> [B, S_out*E]."""

    def __init__(self, s_in, s_out, uln):
        super().__init__()
        self.s_in = s_in
        self.linear = Lin(s_in, s_out, not uln)
        self.ln = LN(s_out) if uln else None

    def forward(self, x, e, act, mask=None):
        xt = x.reshape(x.shape[0], self.s_in, e).transpose(1, 2)        # [B, E, S_in]
        y = masked(act_fn(act)(norm(lin(xt, self.linear), self.ln)), mask)
        return y.transpose(1, 2).reshape(x.shape[0], -1)


def dot_scores(x, yt):
    """x [B, E], yt [B, E, m] -> the lower triangle (below the diagonal,
    row by row) of the [n, n] Gram matrix of the n = m + 1 vectors."""
    t = torch.cat([x[:, None, :], yt.transpose(1, 2)], dim=1)          # [B, n, E]
    n = t.shape[1]
    z = torch.bmm(t, t.transpose(1, 2)).reshape(t.shape[0], n * n)
    r, c = torch.tril_indices(n, n, -1, device=t.device)
    return z[:, r * n + c]


class DotProduct(nn.Module):
    """Pairwise dot products of the projected dense row and the slots
    (paper, section 3.1; NasRec modules.py DotProduct)."""

    def __init__(self, d_in, s_in, d_out, e, uln):
        super().__init__()
        bias = not uln
        ln = (lambda d: LN(d)) if uln else (lambda d: None)
        self.dense_proj = Lin(d_in, e, bias) if d_in != e else None
        self.dense_ln = ln(e) if d_in != e else None
        slot = round((2 * d_out) ** 0.5)
        self.slot_proj = Lin(s_in, slot, bias) if s_in != slot else None
        self.slot_ln = ln(slot) if s_in != slot else None
        pairs = (slot + 1) * slot // 2
        self.out_proj = Lin(pairs, d_out, bias) if pairs != d_out else None
        self.out_ln = ln(d_out)
        self.s_in = s_in

    def forward(self, dense, sparse, e, mask=None):
        x = norm(lin(dense, self.dense_proj), self.dense_ln)
        yt = sparse.reshape(sparse.shape[0], self.s_in, e).transpose(1, 2)   # [B, E, S]
        yt = norm(lin(yt, self.slot_proj), self.slot_ln)
        out = norm(lin(dot_scores(x, yt), self.out_proj), self.out_ln)
        return masked(out, mask)


def pad_align(left, right):
    dl, dr = left.shape[-1], right.shape[-1]
    if dl < dr:
        left = F.pad(left, (0, dr - dl))
    elif dr < dl:
        right = F.pad(right, (0, dl - dr))
    return left, right


class Sum(nn.Module):
    def __init__(self, l_in, r_in, d_out, uln):
        super().__init__()
        w = max(l_in, r_in)
        self.proj = Lin(w, d_out, not uln) if w != d_out else None
        self.ln = LN(d_out) if uln else None

    def forward(self, left, right, mask=None):
        left, right = pad_align(left, right)
        return masked(norm(lin(left + right, self.proj), self.ln), mask)


class SigmoidGating(nn.Module):
    def __init__(self, l_in, r_in, d_out, uln):
        super().__init__()
        w = max(l_in, r_in)
        self.self_linear = Lin(w, w, True)
        self.proj = Lin(w, d_out, True) if w != d_out else None
        self.ln = LN(d_out) if uln else None

    def forward(self, left, right, mask=None):
        left, right = pad_align(left, right)
        out = torch.sigmoid(lin(left, self.self_linear)) * right
        return masked(norm(lin(out, self.proj), self.ln), mask)


class FM3D(nn.Module):
    """(sum over slots)^2 - sum over slots of squares, then a projection."""

    def __init__(self, e, d_out, uln):
        super().__init__()
        self.proj = Lin(e, d_out, not uln) if e != d_out else None
        self.ln = LN(d_out) if (uln and e != d_out) else None

    def forward(self, sparse, slots, e, mask=None):
        x = sparse.reshape(sparse.shape[0], slots, e)
        ix = torch.square(x.sum(dim=1)) - torch.square(x).sum(dim=1)
        return masked(norm(lin(ix, self.proj), self.ln), mask)


class MHA(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.w_in = nn.Parameter(torch.empty(3 * e, e))
        self.b_in = nn.Parameter(torch.empty(3 * e))
        self.w_out = nn.Parameter(torch.empty(e, e))
        self.b_out = nn.Parameter(torch.empty(e))


def attention(qkv, heads: int):
    """softmax(q k^T / sqrt(hd)) v over the slots, for each of `heads` heads."""
    b, s, e3 = qkv.shape
    e = e3 // 3
    hd = e // heads
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in qkv.split(e, dim=-1))
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, s, e)


class Transformer(nn.Module):
    """Slot projection, then one post-LN encoder layer over the slots with an
    ReLU feed-forward E -> E -> E (NasRec modules.py Transformer)."""

    def __init__(self, s_in, s_out, e, uln, heads):
        super().__init__()
        self.s_in, self.heads = s_in, heads
        self.proj = Lin(s_in, s_out, not uln)
        self.mha = MHA(e)
        self.attn_ln = LN(e)
        self.fc1 = Lin(e, e)
        self.fc2 = Lin(e, e)
        self.fc_ln = LN(e)
        self.proj_ln = LN(s_out) if uln else None

    def forward(self, sparse, e, mask=None):
        b = sparse.shape[0]
        xt = sparse.reshape(b, self.s_in, e).transpose(1, 2)             # [B, E, S_in]
        xt = masked(norm(lin(xt, self.proj), self.proj_ln), mask)
        x = xt.transpose(1, 2)                                           # [B, S, E]
        m = self.mha
        o = attention(F.linear(x, m.w_in, m.b_in), self.heads)
        x = F.layer_norm(F.linear(o, m.w_out, m.b_out) + x, (e,), self.attn_ln.weight,
                         self.attn_ln.bias, LN_EPS)
        f = F.linear(F.relu(F.linear(x, self.fc1.weight, self.fc1.bias)),
                     self.fc2.weight, self.fc2.bias)
        x = F.layer_norm(x + f, (e,), self.fc_ln.weight, self.fc_ln.bias, LN_EPS)
        return masked(x, mask, axis=1).reshape(b, -1)


class Embedding(nn.Module):
    """One fused table of every slot's rows."""

    def __init__(self, vocab: Sequence[int], e: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(int(sum(vocab)), e), requires_grad=False)
        self.offsets = [int(x) for x in np.concatenate([[0], np.cumsum(vocab)[:-1]])]

    def rows(self, cat):
        """[B, S] per-slot indices -> [B, S] fused-table rows (int64)."""
        return cat.long() + torch.as_tensor(self.offsets, device=cat.device)[None, :]


def _node(cfg: dict, name: str, d_in: int, s_in: int, l_in: int, r_in: int,
          d_out: int, s_out: int, uln: bool) -> nn.Module:
    e = cfg["emb_dim"]
    if name == "linear-2d":
        return ElasticLinear(d_in, d_out, uln)
    if name in ("zeros-2d", "zeros-3d"):
        return nn.Identity()
    if name == "sum":
        return Sum(l_in, r_in, d_out, uln)
    if name == "sigmoid-gating":
        return SigmoidGating(l_in, r_in, d_out, uln)
    if name == "dot-product":
        return DotProduct(d_in, s_in, d_out, e, uln)
    if name == "transformer":
        return Transformer(s_in, s_out, e, uln, cfg["num_mha_heads"])
    if name == "linear-3d":
        return ElasticLinear3D(s_in, s_out, uln)
    raise NotImplementedError(name)


def _ln_init_names(model: nn.Module) -> Dict[str, float]:
    """{parameter name: value} for every LayerNorm scale: 0.17 for the
    transformer's two (NasRec modules.py, `ln_init`), 1 elsewhere."""
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, nn.LayerNorm):
            leaf = mname.rsplit(".", 1)[-1]
            out[f"{mname}.weight"] = 0.17 if leaf in ("attn_ln", "fc_ln") else 1.0
    return out


def init_specs(model: nn.Module, vocab: Sequence[int]) -> List[tuple]:
    """(name, shape, kind, a) of every parameter, the benchmark's recipe for
    making weights (NasRec train_utils.py init): 'normal' (std a: each slot's
    rows of the table, xavier-normal), 'uniform' (-a..a: xavier-uniform
    weights), 'const' (a: biases 0, LayerNorm scales)."""
    ln_scale = _ln_init_names(model)
    specs = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name == "embedding.table":
            specs.append((name, shape, "table", [(int(v), math.sqrt(2.0 / (int(v) + shape[1])))
                                                for v in vocab]))
        elif name in ln_scale:
            specs.append((name, shape, "const", ln_scale[name]))
        elif p.dim() == 1:
            specs.append((name, shape, "const", 0.0))
        else:
            fan_out, fan_in = shape
            specs.append((name, shape, "uniform", math.sqrt(6.0 / (fan_in + fan_out))))
    return specs


# ---------------------------------------------------------------- fixed subnet


def live_blocks(cfg: dict, choice: dict) -> List[bool]:
    """Which blocks the logits depend on (the head reads the last block)."""
    names = cfg["space"]["node_names"]
    n = cfg["num_blocks"]
    live = [False] * (n + 1)
    live[n] = True
    for v in range(n, 0, -1):
        if not live[v]:
            continue
        mac, mic = choice["macro"][v - 1], choice["micro"][v - 1]
        kinds = [names[k] for k in mic["active_nodes"]]
        reads = []
        if any(k in _READS_DENSE for k in kinds):
            reads += mac["dense_idx"]
        if any(k in _READS_SPARSE for k in kinds):
            reads += mac["sparse_idx"]
        if any(k in _READS_SIDES for k in kinds):
            reads += mac["dense_left_idx"] + mac["dense_right_idx"]
        for j in reads:
            live[int(j)] = True
    return live[1:]


class FixedBlock(nn.Module):
    def __init__(self, cfg, mac, mic, dense_w, sparse_s):
        super().__init__()
        e, uln, names = cfg["emb_dim"], cfg["use_layernorm"], cfg["space"]["node_names"]
        self.sel = {k: sorted(set(int(j) for j in mac[k]))
                    for k in ("dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx")}
        self.d_out, self.s_out = int(mic["dense_in_dims"]), int(mic["sparse_in_dims"])
        self.interact, self.use_fm = bool(mic["dense_sparse_interact"]), bool(mic["deep_fm"])
        self.kinds = {int(k): names[int(k)] for k in sorted(mic["active_nodes"])}
        d_in = sum(dense_w[j] for j in self.sel["dense_idx"])
        self.s_in = sum(sparse_s[j] for j in self.sel["sparse_idx"])
        l_in = sum(dense_w[j] for j in self.sel["dense_left_idx"])
        r_in = sum(dense_w[j] for j in self.sel["dense_right_idx"])
        self.nodes = nn.ModuleDict({
            str(k): _node(cfg, n, d_in, self.s_in, l_in, r_in, self.d_out, self.s_out, uln)
            for k, n in self.kinds.items()})
        wide = cfg["ds_interact_num_splits"] * e
        self.ds_proj = self.ds_ln = self.deep_fm = None
        if self.interact and self.d_out != wide:
            self.ds_proj = Lin(self.d_out, wide, not uln)
            self.ds_ln = LN(wide) if uln else None
        if self.use_fm:
            self.deep_fm = FM3D(e, self.d_out, uln)
        self.out_slots = self.s_out + (cfg["ds_interact_num_splits"] if self.interact else 0)
        self.e, self.act = e, cfg["activation"]

    def forward(self, dense_list, sparse_list):
        def cat(lst, key):
            parts = [lst[j] for j in self.sel[key]]
            return torch.cat(parts, -1) if len(parts) > 1 else parts[0]

        dense_outs, sparse_outs = [], []
        for k, kind in self.kinds.items():
            node = self.nodes[str(k)]
            if kind == "linear-2d":
                dense_outs.append(node(cat(dense_list, "dense_idx"), self.act))
            elif kind == "zeros-2d":
                dense_outs.append(dense_list[0].new_zeros(dense_list[0].shape[0], self.d_out))
            elif kind in ("sum", "sigmoid-gating"):
                dense_outs.append(node(cat(dense_list, "dense_left_idx"),
                                       cat(dense_list, "dense_right_idx")))
            elif kind == "dot-product":
                dense_outs.append(node(cat(dense_list, "dense_idx"),
                                       cat(sparse_list, "sparse_idx"), self.e))
            elif kind == "transformer":
                sparse_outs.append(node(cat(sparse_list, "sparse_idx"), self.e))
            elif kind == "linear-3d":
                sparse_outs.append(node(cat(sparse_list, "sparse_idx"), self.e, self.act))
            else:
                sparse_outs.append(sparse_list[0].new_zeros(sparse_list[0].shape[0],
                                                            self.s_out * self.e))
        dense, sparse = sum(dense_outs), sum(sparse_outs)
        proj = norm(lin(dense, self.ds_proj), self.ds_ln) if self.interact else None
        if self.deep_fm is not None:
            dense = dense + self.deep_fm(sparse, self.s_out, self.e)
        if proj is not None:
            sparse = torch.cat([sparse, proj], -1)
        return dense, sparse


class FixedRef(nn.Module):
    """A fixed subnet of `cfg` ('choice'), with the port's parameter names."""

    def __init__(self, cfg: dict, vocab: Sequence[int], choice: Optional[dict] = None):
        super().__init__()
        choice = choice or cfg["choice"]
        e = cfg["emb_dim"]
        self.embedding = Embedding(vocab, e)
        dense_w, sparse_s = [cfg["num_dense"]], [cfg["num_sparse"]]
        blocks = []
        for mac, mic in zip(choice["macro"], choice["micro"]):
            blk = FixedBlock(cfg, mac, mic, dense_w, sparse_s)
            blocks.append(blk)
            dense_w.append(blk.d_out)
            sparse_s.append(blk.out_slots)
        self.blocks = nn.ModuleList(blocks)
        self.final = Lin(dense_w[-1] + sparse_s[-1] * e, 1)
        self.live = live_blocks(cfg, choice)

    def forward_stem(self, dense, stem):
        dense_list, sparse_list = [dense], [stem]
        for blk, live in zip(self.blocks, self.live):
            if not live:
                dense_list.append(None)
                sparse_list.append(None)
                continue
            d, s = blk(dense_list, sparse_list)
            dense_list.append(d)
            sparse_list.append(s)
        return F.linear(torch.cat([dense_list[-1], sparse_list[-1]], -1),
                        self.final.weight, self.final.bias)


# ------------------------------------------------------------------- supernet


def choice_masks(cfg: dict, choice: dict, device) -> Dict[str, torch.Tensor]:
    """A subnet as the supernet's 0/1 masks: input selectors [B, B], active
    nodes [B, N], width prefixes, interact and deep-fm flags."""
    sp, nb = cfg["space"], cfg["num_blocks"]
    nn_, dmax, smax = len(sp["node_names"]), max(sp["dense_node_dims"]), max(sp["sparse_node_dims"])
    m = {k: np.zeros((nb, nb), np.float32)
         for k in ("dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx")}
    act = np.zeros((nb, nn_), np.float32)
    ddim = np.zeros((nb, dmax), np.float32)
    sdim = np.zeros((nb, smax), np.float32)
    inter = np.zeros(nb, np.float32)
    fm = np.zeros(nb, np.float32)
    for i, (mac, mic) in enumerate(zip(choice["macro"], choice["micro"])):
        for k in m:
            for j in mac[k]:
                m[k][i, int(j)] = 1.0
        for a in mic["active_nodes"]:
            act[i, int(a)] = 1.0
        ddim[i, :int(mic["dense_in_dims"])] = 1.0
        sdim[i, :int(mic["sparse_in_dims"])] = 1.0
        inter[i] = float(mic["dense_sparse_interact"])
        fm[i] = float(mic["deep_fm"])
    out = dict(m, act=act, ddim=ddim, sdim=sdim, inter=inter, fm=fm)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def check_choice(cfg: dict, choice: dict) -> None:
    """Raise ValueError unless `choice` is a subnet of the space."""
    sp, nb = cfg["space"], cfg["num_blocks"]
    if len(choice["macro"]) != nb or len(choice["micro"]) != nb:
        raise ValueError("a choice has one macro and one micro entry a block")
    for i, (mac, mic) in enumerate(zip(choice["macro"], choice["micro"])):
        for k in ("dense_idx", "sparse_idx", "dense_left_idx", "dense_right_idx"):
            if not mac[k] or any(not 0 <= int(j) <= i for j in mac[k]):
                raise ValueError(f"block {i}: {k} {mac[k]}")
        act = [int(a) for a in mic["active_nodes"]]
        if not any(a in sp["dense_nodes"] for a in act) or \
                not any(a in sp["sparse_nodes"] for a in act):
            raise ValueError(f"block {i}: active nodes {act}")
        if int(mic["dense_in_dims"]) not in sp["dense_node_dims"] or \
                int(mic["sparse_in_dims"]) not in sp["sparse_node_dims"]:
            raise ValueError(f"block {i}: widths")


class SuperBlock(nn.Module):
    def __init__(self, cfg, i):
        super().__init__()
        sp, e, uln = cfg["space"], cfg["emb_dim"], cfg["use_layernorm"]
        dmax, smax = max(sp["dense_node_dims"]), max(sp["sparse_node_dims"])
        nsplit = cfg["ds_interact_num_splits"]
        d_in = cfg["num_dense"] + i * dmax
        self.s_in = cfg["num_sparse"] + i * (smax + nsplit)
        self.kinds = list(sp["node_names"])
        self.nodes = nn.ModuleList(_node(cfg, n, d_in, self.s_in, d_in, d_in, dmax, smax, uln)
                                   for n in self.kinds)
        self.ds_proj = Lin(dmax, nsplit * e, not uln) if dmax != nsplit * e else None
        self.ds_ln = LN(nsplit * e) if (uln and self.ds_proj is not None) else None
        self.deep_fm = FM3D(e, dmax, uln)
        self.i, self.e, self.smax, self.act = i, e, smax, cfg["activation"]

    def forward(self, dense_in, sparse_in, left, right, mk):
        i, e = self.i, self.e
        gate, dmask, smask = mk["act"][i], mk["ddim"][i], mk["sdim"][i]
        dense_outs, sparse_outs = [], []
        for k, kind in enumerate(self.kinds):
            node = self.nodes[k]
            if kind in ("zeros-2d", "zeros-3d"):
                continue
            if kind == "linear-2d":
                dense_outs.append(node(dense_in, self.act, dmask) * gate[k])
            elif kind in ("sum", "sigmoid-gating"):
                dense_outs.append(node(left, right, dmask) * gate[k])
            elif kind == "dot-product":
                dense_outs.append(node(dense_in, sparse_in, e, dmask) * gate[k])
            elif kind == "transformer":
                sparse_outs.append(node(sparse_in, e, smask) * gate[k])
            else:
                sparse_outs.append(node(sparse_in, e, self.act, smask) * gate[k])
        dense, sparse = sum(dense_outs), sum(sparse_outs)
        proj = norm(lin(dense, self.ds_proj), self.ds_ln) * mk["inter"][i]
        dense = dense + self.deep_fm(sparse, self.smax, e, dmask) * mk["fm"][i]
        return dense, torch.cat([sparse, proj], -1)


class SuperNetRef(nn.Module):
    def __init__(self, cfg: dict, vocab: Sequence[int]):
        super().__init__()
        sp, e = cfg["space"], cfg["emb_dim"]
        self.embedding = Embedding(vocab, e)
        self.blocks = nn.ModuleList(SuperBlock(cfg, i) for i in range(cfg["num_blocks"]))
        width = max(sp["dense_node_dims"]) + (max(sp["sparse_node_dims"])
                                              + cfg["ds_interact_num_splits"]) * e
        self.final = Lin(width, 1)

    def forward_stem(self, dense, stem, mk):
        return F.linear(self.features(dense, stem, mk), self.final.weight, self.final.bias)

    def features(self, dense, stem, mk):
        """The head's input: the last block's dense and flat sparse outputs."""
        dl, sl = [dense], [stem]

        def sel(lst, row):
            parts = [t * row[j] for j, t in enumerate(lst)]
            return torch.cat(parts, -1) if len(parts) > 1 else parts[0]

        for i, blk in enumerate(self.blocks):
            d, s = blk(sel(dl, mk["dense_idx"][i]), sel(sl, mk["sparse_idx"][i]),
                       sel(dl, mk["dense_left_idx"][i]), sel(dl, mk["dense_right_idx"][i]), mk)
            dl.append(d)
            sl.append(s)
        return torch.cat([dl[-1], sl[-1]], -1)


# ----------------------------------------------------------------- the step


def cosine_lr(step: int, total: int, warmup: int, max_lr: float, min_lr: float = 1e-8) -> float:
    """Cosine annealing with linear warm-up, stepped per batch (NasRec
    lr_schedule.py CosineAnnealingWarmupRestarts, one cycle)."""
    t = step % total
    if t < warmup:
        return min_lr + (max_lr - min_lr) * t / max(warmup, 1)
    return min_lr + (max_lr - min_lr) * (
        1.0 + math.cos(math.pi * (t - warmup) / max(total - warmup, 1))) / 2.0


def bce(logits, y):
    x = logits.float()
    return torch.mean(torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x))))


@contextlib.contextmanager
def lower_precision(precision: str, device):
    """'f32': float32 throughout, TF32 off (the configurations' precision);
    'tf32': matrix products in TF32; 'bf16': the forward and backward under
    bfloat16 autocast.  The two last are the controls, never the reference."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        if precision == "bf16":
            with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class RefTrainer:
    """Dense Adagrad on a reference model, one batch a `step`.

    Returns the step's loss; keeps `acc`."""

    def __init__(self, model: nn.Module, lr_fn, grad_clip: float = 5.0, eps: float = 1e-2,
                 precision: str = "f32"):
        self.model, self.lr_fn, self.clip, self.eps = model, lr_fn, grad_clip, eps
        self.precision = precision
        self.names = [n for n, _ in model.named_parameters()]
        self.params = dict(model.named_parameters())
        self.acc = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.step_no = 0

    def step(self, dense, cat, y) -> float:
        model = self.model
        table = model.embedding.table
        rows = model.embedding.rows(cat)                                 # [B, S]
        stem = table.detach()[rows.reshape(-1)].reshape(cat.shape[0], -1).requires_grad_(True)
        dense_names = [n for n in self.names if n != "embedding.table"]
        wrt = [self.params[n] for n in dense_names] + [stem]
        with lower_precision(self.precision, dense.device):
            logits = model.forward_stem(dense, stem)
            loss = bce(logits, y)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
        grads = [g.float() for g in grads]
        with torch.no_grad():
            g = dict(zip(dense_names, grads[:len(dense_names)]))
            gt = torch.zeros_like(table)
            gt.index_add_(0, rows.reshape(-1), grads[-1].reshape(-1, table.shape[1]))
            g["embedding.table"] = gt
            sq = sum(torch.sum(t * t) for t in g.values())
            scale = torch.clamp(self.clip / (torch.sqrt(sq) + 1e-6), max=1.0)
            lr = float(self.lr_fn(self.step_no))
            for n, t in g.items():
                t.mul_(scale)
                a = self.acc[n]
                a.addcmul_(t, t)
                self.params[n].addcdiv_(t, a.sqrt().add_(self.eps), value=-lr)
            del g
        self.step_no += 1
        return float(loss.detach())


def build(model_fn, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """`model_fn()` built without memory and given `weights` (its own
    tensors, no copy)."""
    with torch.device("meta"):
        model = model_fn()
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def shapes_of(model_fn) -> nn.Module:
    """`model_fn()` on the meta device: names and shapes, no memory."""
    with torch.device("meta"):
        return model_fn()
