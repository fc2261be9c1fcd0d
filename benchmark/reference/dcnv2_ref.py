"""Plain PyTorch reference of DLRM-DCNv2 and of its training step.

Written from the DCN V2 paper (Wang et al., arXiv:2008.13535: the cross layer
x_{l+1} = x_0 * (W_l (V_l x_l) + b_l) + x_l in its low-rank form) and from
MLPerf Training's recommender (github.com/mlcommons/training,
recommendation_v2/torchrec_dlrm: the dense arch, the concatenation of its
output with the sum-pooled multi-hot bags, 3 cross layers of rank 512, the
over arch, BCE, Adagrad for the dense and the sparse parameters), importing
nothing of the port and no kernel.  A model is a configuration dict
(`benchmark/configs/criteo1tb-dcnv2.json`'s keys); its parameters carry the
port's names (`nasrec_tpu_torch/models/dcn.py`), so that one set of weights,
made here from the run's seed, loads into both.  Float32 throughout, TF32
off (`lower_precision("f32")`).

Departures from the source, each the same in the program:

  - float32, not the mixed precision of MLPerf's submissions;
  - one card's share of a 4-card host: each table's first ceil(rows / 4)
    rows (the configuration's `vocab_sizes`), ids drawn from that share, and
    16384 rows of the global batch of 65536; what the other cards' rows
    would add to a bag is left out;
  - the table's Adagrad is the dense formula applied to the rows the batch
    touches, which is exact: a row whose gradient is zero moves neither its
    value nor its accumulator (torchrec fuses the same update into the
    backward);
  - assumed where the source leaves it to library defaults: Adagrad's eps
    (the configuration's `adagrad_eps`), the tables drawn
    U(-1/sqrt(rows), 1/sqrt(rows)) of the whole table's rows, the linear
    layers as nn.Linear draws them (weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in))), the cross layers' V and W xavier-normal and their
    bias zero.

The table is drawn in chunks of TABLE_CHUNK rows, each from its own stream of
the seed, so that a change over the whole table (51 M rows at the cell's
size) is measured chunk by chunk (`table_change_sq`) without a second table.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

TABLE = "embedding.table"
TABLE_CHUNK = 1 << 20


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the stream `what` of run seed `seed` (any integer)."""
    h = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def width(cfg) -> int:
    return cfg["embedding_dim"] * (1 + len(cfg["vocab_sizes"]))


def dense_specs(cfg) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, a) of every parameter but the table: kind
    "uniform" U(-a, a), "normal" N(0, a^2), "zeros"."""
    out = []

    def mlp(prefix, dims):
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            bound = 1.0 / math.sqrt(a)
            out.extend([(f"{prefix}.{i}.weight", (b, a), "uniform", bound),
                        (f"{prefix}.{i}.bias", (b,), "uniform", bound)])

    mlp("dense_arch", [cfg["num_dense"]] + list(cfg["dense_arch_layer_sizes"]))
    w, r = width(cfg), cfg["dcn_low_rank_dim"]
    std = math.sqrt(2.0 / (w + r))
    for layer in range(cfg["dcn_num_layers"]):
        out.extend([(f"cross.{layer}.v", (r, w), "normal", std),
                    (f"cross.{layer}.w", (w, r), "normal", std),
                    (f"cross.{layer}.bias", (w,), "zeros", 0.0)])
    over = list(cfg["over_arch_layer_sizes"])
    mlp("over_arch", [w] + over[:-1])
    bound = 1.0 / math.sqrt(over[-2])
    out.extend([("final.weight", (1, over[-2]), "uniform", bound),
                ("final.bias", (1,), "uniform", bound)])
    return out


def make_dense(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter but the table, from the seed: one uniform and one
    normal draw for all of them, each part scaled in place."""
    specs = dense_specs(cfg)
    out = {}
    for kind, draw in (("uniform", lambda t, g: t.uniform_(-1.0, 1.0, generator=g)),
                       ("normal", lambda t, g: t.normal_(0.0, 1.0, generator=g))):
        part = [s for s in specs if s[2] == kind]
        sizes = [math.prod(s[1]) for s in part]
        flat = draw(torch.empty(sum(sizes), device=device),
                    generator(seed, f"dense-{kind}", device))
        for (name, shape, _, a), t in zip(part, torch.split(flat, sizes)):
            out[name] = t.view(shape).mul_(a)
    for name, shape, kind, _ in specs:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, *_ in specs}


def _bounds(cfg) -> List[Tuple[int, int, float]]:
    """(first fused row, end row, init bound) of each slot."""
    rows = cfg.get("published_vocab_sizes", cfg["vocab_sizes"])
    out, start = [], 0
    for v, n in zip(cfg["vocab_sizes"], rows):
        out.append((start, start + int(v), 1.0 / math.sqrt(int(n))))
        start += int(v)
    return out


def table_rows(cfg) -> int:
    return int(sum(cfg["vocab_sizes"]))


def table_chunk(cfg, seed: int, k: int, device) -> torch.Tensor:
    """The initial rows [k * TABLE_CHUNK, (k + 1) * TABLE_CHUNK) of the table."""
    lo = k * TABLE_CHUNK
    hi = min(lo + TABLE_CHUNK, table_rows(cfg))
    t = torch.empty(hi - lo, cfg["embedding_dim"], device=device)
    t.uniform_(-1.0, 1.0, generator=generator(seed, f"table-{k}", device))
    for a, b, bound in _bounds(cfg):
        if a < hi and b > lo:
            t[max(a, lo) - lo:min(b, hi) - lo].mul_(bound)
    return t


def fill_table(table: torch.Tensor, cfg, seed: int) -> torch.Tensor:
    """The initial table, written into `table` [rows, E] in place."""
    for k in range(-(-table.shape[0] // TABLE_CHUNK)):
        table[k * TABLE_CHUNK:(k + 1) * TABLE_CHUNK] = table_chunk(cfg, seed, k, table.device)
    return table


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    out = {TABLE: fill_table(torch.empty(table_rows(cfg), cfg["embedding_dim"], device=device),
                             cfg, seed)}
    out.update(make_dense(cfg, seed, device))
    return out


@torch.no_grad()
def table_change_sq(table: torch.Tensor, cfg, seed: int) -> float:
    """Sum of (table - its initial value)^2 over every element, in float64,
    a chunk at a time."""
    total = 0.0
    for k in range(-(-table.shape[0] // TABLE_CHUNK)):
        part = table[k * TABLE_CHUNK:(k + 1) * TABLE_CHUNK].double()
        total += float((part - table_chunk(cfg, seed, k, table.device).double()).square().sum())
    return total


@torch.no_grad()
def sum_sq(t: torch.Tensor) -> float:
    """Sum of t^2 in float64, a chunk of rows at a time."""
    return sum(float(t[i:i + TABLE_CHUNK].double().square().sum())
               for i in range(0, t.shape[0], TABLE_CHUNK))


@torch.no_grad()
def total(t: torch.Tensor) -> float:
    """Sum of t in float64, a chunk of rows at a time."""
    return sum(float(t[i:i + TABLE_CHUNK].double().sum())
               for i in range(0, t.shape[0], TABLE_CHUNK))


def column_offsets(cfg, device) -> torch.Tensor:
    """The fused-row offset of each column of a batch's ids [B, H]."""
    starts = [a for a, _, _ in _bounds(cfg)]
    return torch.as_tensor([s for s, h in zip(starts, cfg["multi_hot_sizes"]) for _ in range(h)],
                           device=device, dtype=torch.int64)


def pool(table: torch.Tensor, idx: torch.Tensor, cfg) -> torch.Tensor:
    """[B, H] fused rows -> [B, S*E]: each slot's bag of rows summed."""
    out, c = [], 0
    for h in cfg["multi_hot_sizes"]:
        out.append(table[idx[:, c:c + h]].sum(dim=1))
        c += h
    return torch.cat(out, dim=1)


def forward_stem(p: Dict[str, torch.Tensor], cfg, dense: torch.Tensor,
                 stem: torch.Tensor) -> torch.Tensor:
    """Logits [B, 1] from dense [B, 13] and the pooled stem [B, S*E]."""
    x = dense
    for i in range(len(cfg["dense_arch_layer_sizes"])):
        x = F.relu(F.linear(x, p[f"dense_arch.{i}.weight"], p[f"dense_arch.{i}.bias"]))
    x0 = torch.cat([x, stem], dim=1)
    x = x0
    for layer in range(cfg["dcn_num_layers"]):
        xv = F.linear(x, p[f"cross.{layer}.v"])
        x = x0 * F.linear(xv, p[f"cross.{layer}.w"], p[f"cross.{layer}.bias"]) + x
    for i in range(len(cfg["over_arch_layer_sizes"]) - 1):
        x = F.relu(F.linear(x, p[f"over_arch.{i}.weight"], p[f"over_arch.{i}.bias"]))
    return F.linear(x, p["final.weight"], p["final.bias"])


def bce(logits, y):
    x = logits.float()
    return torch.mean(torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x))))


@contextlib.contextmanager
def lower_precision(precision: str, device):
    """'f32': float32 throughout, TF32 off (the configuration's precision);
    'tf32': matrix products in TF32; 'bf16': the forward and backward under
    bfloat16 autocast.  The two last are the controls, never the reference."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        if precision == "bf16":
            with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class RefTrainer:
    """Adagrad on the reference model, one batch a `step` (the loss back).
    `params` holds every parameter, the table under TABLE; `acc` their
    accumulators; `first_grad` each parameter's gradient norm at the first
    step (float64)."""

    def __init__(self, cfg, weights: Dict[str, torch.Tensor], lr: float, eps: float,
                 precision: str = "f32"):
        self.cfg, self.lr, self.eps, self.precision = cfg, lr, eps, precision
        self.params = weights
        self.names = list(weights)
        self.acc = {n: torch.zeros_like(t) for n, t in weights.items()}
        self.first_grad = None

    def step(self, dense, ids, y) -> float:
        cfg, table = self.cfg, self.params[TABLE]
        idx = ids.long() + column_offsets(cfg, ids.device)[None, :]
        with torch.no_grad():
            stem = pool(table, idx, cfg)
        stem.requires_grad_(True)
        names = [n for n in self.names if n != TABLE]
        p = {n: self.params[n].detach().requires_grad_(True) for n in names}
        with lower_precision(self.precision, dense.device):
            loss = bce(forward_stem(p, cfg, dense, stem), y)
            grads = torch.autograd.grad(loss, [p[n] for n in names] + [stem])
        with torch.no_grad():
            g = {n: t.float() for n, t in zip(names, grads)}
            # The table's gradient on the rows the batch touches: each
            # lookup's gradient is its bag's pooled gradient.
            rows, inv = torch.unique(idx.reshape(-1), return_inverse=True)
            inv = inv.reshape(idx.shape)
            d = grads[-1].float().reshape(idx.shape[0], -1, cfg["embedding_dim"])
            gu = torch.zeros(rows.numel(), cfg["embedding_dim"], device=table.device)
            c = 0
            for s, h in enumerate(cfg["multi_hot_sizes"]):
                gu.index_add_(0, inv[:, c:c + h].reshape(-1),
                              d[:, s, None, :].expand(-1, h, -1).reshape(-1, cfg["embedding_dim"]))
                c += h
            if self.first_grad is None:
                self.first_grad = {n: math.sqrt(sum_sq(t)) for n, t in g.items()}
                self.first_grad[TABLE] = math.sqrt(sum_sq(gu))
            for n, t in g.items():
                a = self.acc[n]
                a.add_(t * t)
                self.params[n].sub_(self.lr * t / (torch.sqrt(a) + self.eps))
            acc_t = self.acc[TABLE]
            a = acc_t.index_select(0, rows) + gu * gu
            acc_t.index_copy_(0, rows, a)
            table.index_copy_(0, rows, table.index_select(0, rows)
                              - self.lr * gu / (torch.sqrt(a) + self.eps))
        return float(loss.detach())


def step_flops(cfg, batch: int) -> float:
    """Matmul FLOPs of one training step (forward and backward) at `batch`,
    counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        p = {n: torch.empty(shape, requires_grad=True) for n, shape, _, _ in dense_specs(cfg)}
        dense = torch.empty(batch, cfg["num_dense"])
        stem = torch.empty(batch, len(cfg["vocab_sizes"]) * cfg["embedding_dim"], requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        forward_stem(p, cfg, dense, stem).sum().backward()
    return float(fc.get_total_flops())
