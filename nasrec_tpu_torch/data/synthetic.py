"""Synthetic CTR data with learnable structure, for tests and benchmarks
(a copy of `nasrec_tpu/data/synthetic.py` whose batches are torch tensors).

Plays the role of the reference's NUM_EMBEDDINGS_TEST tiny-vocab fixture
(ref: nasrec/utils/config.py:41) but with an actual planted signal so
end-to-end convergence can be asserted: the label is Bernoulli of a logistic
model over the dense features plus per-slot categorical effects.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_dense: int = 13
    num_sparse: int = 26
    vocab: int = 100
    signal_scale: float = 2.0
    # Planted second-order structure: the label also depends on dot products
    # of per-(slot,value) latent factors over this many random slot pairs —
    # the kind of signal CTR interaction ops (dot-product, FM) exist to model.
    interaction_pairs: int = 0
    interaction_scale: float = 1.0


def synthetic_arrays(
    n: int, spec: SyntheticSpec = SyntheticSpec(), seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dense f32 [N,D], cat i32 [N,S], label f32 [N,1]).

    The planted model (w, cat_effects, latent factors) depends only on `spec`,
    so different seeds draw train/eval examples from the SAME ground-truth
    distribution.
    """
    model_rng = np.random.RandomState(1234)
    w = model_rng.randn(spec.num_dense).astype(np.float32) / np.sqrt(spec.num_dense)
    cat_effects = model_rng.randn(spec.num_sparse, spec.vocab).astype(np.float32) * 0.3
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, spec.num_dense).astype(np.float32)
    cat = rng.randint(0, spec.vocab, size=(n, spec.num_sparse)).astype(np.int32)
    logits = spec.signal_scale * (
        dense @ w + cat_effects[np.arange(spec.num_sparse)[None, :], cat].sum(1)
    )
    if spec.interaction_pairs > 0:
        d_lat = 4
        z = model_rng.randn(spec.num_sparse, spec.vocab, d_lat).astype(np.float32)
        pairs = [
            tuple(model_rng.choice(spec.num_sparse, 2, replace=False))
            for _ in range(spec.interaction_pairs)
        ]
        inter = np.zeros(n, np.float32)
        for i, j in pairs:
            inter += np.einsum("nd,nd->n", z[i, cat[:, i]], z[j, cat[:, j]])
        logits = logits + spec.interaction_scale * inter / np.sqrt(
            spec.interaction_pairs
        )
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random_sample(n) < p).astype(np.float32)[:, None]
    return dense, cat, y


def synthetic_batches(
    n: int,
    batch_size: int,
    spec: SyntheticSpec = SyntheticSpec(),
    seed: int = 0,
    loop: bool = False,
    device: str | torch.device = "cpu",
):
    """Yield (dense f32 [B, D], cat i32 [B, S], label f32 [B, 1]) tensors on
    `device`.  The whole split is moved once; batches are views of it."""
    dense, cat, y = (
        torch.from_numpy(a).to(device) for a in synthetic_arrays(n, spec, seed)
    )
    while True:
        for i in range(0, n - batch_size + 1, batch_size):
            yield dense[i : i + batch_size], cat[i : i + batch_size], y[i : i + batch_size]
        if not loop:
            return


def multihot_arrays(n: int, vocab_sizes: Sequence[int], bag_sizes: Sequence[int],
                    num_dense: int = 13, seed: int = 0,
                    signal_scale: float = 2.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dense f32 [N, D] ~ N(0, 1), ids i32 [N, H], label f32 [N, 1]) for a
    multi-hot model (models/dcn.py): slot s's bag is bag_sizes[s] ids, each
    uniform over its vocab_sizes[s] rows and drawn independently, in columns
    [sum(bag_sizes[:s]), sum(bag_sizes[:s + 1])).  The label is Bernoulli of a
    logistic model of the dense features (the planted weights depend only on
    num_dense), so that training has a signal to find."""
    w = np.random.RandomState(1234).randn(num_dense).astype(np.float32) / np.sqrt(num_dense)
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, num_dense).astype(np.float32)
    vocab = np.repeat(np.asarray(vocab_sizes, np.int64), np.asarray(bag_sizes))
    ids = (rng.random_sample((n, vocab.size)) * vocab).astype(np.int32)
    p = 1.0 / (1.0 + np.exp(-signal_scale * (dense @ w)))
    y = (rng.random_sample(n) < p).astype(np.float32)[:, None]
    return dense, ids, y


def multihot_batches(n: int, batch_size: int, vocab_sizes: Sequence[int],
                     bag_sizes: Sequence[int], num_dense: int = 13, seed: int = 0,
                     loop: bool = False, device: str | torch.device = "cpu"):
    """Yield (dense [B, D], ids [B, H], label [B, 1]) tensors of
    `multihot_arrays` on `device`.  The whole split is moved once; batches
    are views of it."""
    arrays = [torch.from_numpy(a).to(device)
              for a in multihot_arrays(n, vocab_sizes, bag_sizes, num_dense, seed)]
    while True:
        for i in range(0, n - batch_size + 1, batch_size):
            yield tuple(a[i:i + batch_size] for a in arrays)
        if not loop:
            return


_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def synthetic_tsv_lines(n: int, num_dense: int, num_sparse: int, rng: np.random.RandomState,
                        missing_rate: float = 0.15, short_rate: float = 0.02) -> list:
    """n raw TSV rows (bytes, no newline) shaped like the Criteo dumps:
    label 0/1, `num_dense` decimal integers in [-3, 1000), `num_sparse`
    8-digit hex values over the full 31-bit range; `missing_rate` of the
    fields empty and `short_rate` of the rows cut short after a random field
    (their trailing fields missing)."""
    labels = rng.randint(0, 2, size=(n, 1)).astype("S1")
    ints = rng.randint(-3, 1000, size=(n, num_dense)).astype("S5")
    vals = rng.randint(0, 1 << 31, size=(n, num_sparse)).astype(np.uint32)
    shifts = np.arange(28, -1, -4, dtype=np.uint32)
    digits = _HEX[(vals[:, :, None] >> shifts) & 15]
    cats = np.ascontiguousarray(digits).view("S8")[:, :, 0]
    ints = np.where(rng.rand(n, num_dense) < missing_rate, b"", ints)
    cats = np.where(rng.rand(n, num_sparse) < missing_rate, b"", cats)
    fields = np.concatenate([labels, ints.astype("S8"), cats], axis=1).tolist()
    cut = np.where(rng.rand(n) < short_rate,
                   rng.randint(1, 1 + num_dense + num_sparse, size=n), 1 + num_dense + num_sparse)
    return [b"\t".join(row[:k]) for row, k in zip(fields, cut.tolist())]


def write_tsv_shards(root: str, num_dense: int, num_sparse: int, rows: dict,
                     num_shards: int, seed: int = 0, **kw) -> None:
    """Write `root/shard-<i>/<split>.txt` for each split in `rows`
    ({split: total rows}), the rows of a split dealt into `num_shards`
    contiguous parts, from synthetic_tsv_lines with RandomState(seed)."""
    import os

    rng = np.random.RandomState(seed)
    for split, total in rows.items():
        lines = synthetic_tsv_lines(total, num_dense, num_sparse, rng, **kw)
        bounds = np.linspace(0, total, num_shards + 1).astype(int)
        for i in range(num_shards):
            d = os.path.join(root, f"shard-{i}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{split}.txt"), "wb") as f:
                f.write(b"".join(line + b"\n" for line in lines[bounds[i]:bounds[i + 1]]))
