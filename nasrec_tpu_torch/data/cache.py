"""Binary cache: a one-time TSV -> .npy conversion, then memory-mapped
batches with no parsing per epoch (a copy of `nasrec_tpu/data/cache.py`).

`build_binary_cache` converts this host's shards of a split into three arrays
(dense f32, cat i32, label f32) and a `.meta.json`, under the names
`{split}-h{host}.{dense,cat,label}.npy` that the JAX package uses, so each
package opens the other's cache; `open_binary_cache` streams batches from
them.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from nasrec_tpu_torch.config import DATASETS
from nasrec_tpu_torch.data.pipeline import batch_iterator, shard_paths
from nasrec_tpu_torch.data.transforms import get_transform


def build_binary_cache(
    dataset: str,
    root_dir: str,
    split: str,
    out_dir: str,
    *,
    vocab_cap: Optional[int] = None,
    chunk_rows: int = 65536,
    host_id: int = 0,
    num_hosts: int = 1,
    use_native: str | bool = "auto",
) -> str:
    """Parse this host's shards of `split` into {out_dir}/{split}-h{host}.*;
    returns that prefix."""
    spec = DATASETS[dataset]
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, f"{split}-h{host_id}")
    transform = get_transform(dataset, vocab_cap)
    paths = shard_paths(root_dir, split, host_id, num_hosts)

    dense_parts, cat_parts, y_parts = [], [], []
    for dense, cat, y in batch_iterator(
        paths, chunk_rows, transform, drop_remainder=False, interleave=False,
        use_native=use_native,
    ):
        dense_parts.append(dense)
        cat_parts.append(cat)
        y_parts.append(y)
    dense = np.concatenate(dense_parts)
    cat = np.concatenate(cat_parts)
    y = np.concatenate(y_parts)

    np.save(prefix + ".dense.npy", dense)
    np.save(prefix + ".cat.npy", cat)
    np.save(prefix + ".label.npy", y)
    with open(prefix + ".meta.json", "w") as f:
        json.dump(
            {
                "dataset": dataset,
                "rows": int(len(y)),
                "num_dense": spec.num_dense,
                "num_sparse": spec.num_sparse,
                "vocab_cap": vocab_cap,
            },
            f,
        )
    return prefix


def open_binary_cache(
    prefix: str,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
    loop: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream numpy batches from a binary cache (memory-mapped; O(1) startup).
    With shuffle, each pass draws a permutation from a RandomState(seed) and
    gathers every batch's rows in sorted order (local reads of the map)."""
    dense = np.load(prefix + ".dense.npy", mmap_mode="r")
    cat = np.load(prefix + ".cat.npy", mmap_mode="r")
    y = np.load(prefix + ".label.npy", mmap_mode="r")
    n = len(y)
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n) if shuffle else None
        stop = n - batch_size + 1 if drop_remainder else n
        for start in range(0, stop, batch_size):
            sl = slice(start, min(start + batch_size, n))
            if order is None:
                yield np.asarray(dense[sl]), np.asarray(cat[sl]), np.asarray(y[sl])
            else:
                idx = np.sort(order[sl])
                yield dense[idx], cat[idx], y[idx]
        if not loop:
            return
