"""Offline stratified split of raw Kaggle CTR data into shard directories
(port of `nasrec_tpu/tools/split_data.py`; the fold assignment is NumPy
only, so the tool runs where scikit-learn is not installed).

Layout parity with the reference split tools
(ref: nasrec/tools/autoctr_split_data_{criteo,avazu,kdd}.py):
  out_dir/shard-{i}/{train,val,test,trainval}.txt
with the folds of StratifiedKFold(n_splits=10, shuffle=True,
random_state=2018) and 8/1/1 train/val/test folds (ref:
autoctr_split_data_criteo.py:62-67), reproduced by `_fold_assignment`.

KDD preprocessing joins userid_profile.txt, binarises the label, and reorders
the 14 columns (ref: autoctr_split_data_kdd.py:29-70).

Usage:
  python -m nasrec_tpu_torch.tools.split_data --dataset criteo-kaggle \
      --data_path ./criteo/train.txt --output_dir ./data/criteo_kaggle_autoctr
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List

import numpy as np


def _stratified_test_folds(labels: np.ndarray, n_splits: int, seed: int) -> np.ndarray:
    """Each row's test fold under StratifiedKFold(n_splits, shuffle=True,
    random_state=seed), as scikit-learn computes it: classes numbered by
    first appearance; each class's rows spread over the folds round robin over
    the sorted class codes; each class's fold ids, in class order, shuffled by
    one RandomState(seed), then laid on that class's rows in row order."""
    rng = np.random.RandomState(seed)
    _, first, inverse = np.unique(labels, return_index=True, return_inverse=True)
    _, by_appearance = np.unique(first, return_inverse=True)
    codes = by_appearance[inverse.reshape(-1)]
    n_classes = len(first)
    counts = np.bincount(codes)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         "members in each class")
    ordered = np.sort(codes)
    allocation = np.asarray([np.bincount(ordered[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(labels), dtype=np.int64)
    for k in range(n_classes):
        fold_ids = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(fold_ids)
        folds[codes == k] = fold_ids
    return folds


def _fold_assignment(labels: np.ndarray, num_train=8, num_val=1, num_test=1,
                     seed=2018) -> np.ndarray:
    """Per-row split id: 0=train, 1=val, 2=test."""
    folds = _stratified_test_folds(np.asarray(labels), num_train + num_val + num_test, seed)
    assign = np.full(len(folds), 2, dtype=np.int8)
    assign[folds < num_train + num_val] = 1
    assign[folds < num_train] = 0
    return assign


class _ShardWriter:
    """Round-robin line writer over shard-{i}/{name}.txt files."""

    def __init__(self, out_dir: str, name: str, num_shards: int, total_rows: int):
        self.files = []
        self.rows_per_shard = max(1, round(total_rows / num_shards))
        self.count = 0
        self.shard = -1
        self.fp = None
        self.out_dir = out_dir
        self.name = name
        self.num_shards = num_shards

    def write(self, line: str):
        if self.fp is None or (
            self.count >= self.rows_per_shard and self.shard < self.num_shards - 1
        ):
            if self.fp:
                self.fp.close()
            self.shard += 1
            d = os.path.join(self.out_dir, f"shard-{self.shard}")
            os.makedirs(d, exist_ok=True)
            self.fp = open(os.path.join(d, f"{self.name}.txt"), "w")
            self.count = 0
        self.fp.write(line)
        self.count += 1

    def close(self):
        if self.fp:
            self.fp.close()


def _iter_criteo_avazu(data_path: str) -> Iterator[str]:
    with open(data_path, "r") as f:
        for line in f:
            yield line if line.endswith("\n") else line + "\n"


def _iter_kdd(data_dir: str) -> Iterator[str]:
    """Join userid_profile, binarise label, reorder 14 cols (ref kdd:29-70)."""
    user_file = os.path.join(data_dir, "userid_profile.txt")
    training_file = os.path.join(data_dir, "training.txt")
    user_dict = {}
    with open(user_file, "r") as fp:
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            user_dict[parts[0]] = parts[1:]
    reorder = [0, 1, 5, 6, 2, 3, 4, 7, 8, 9, 10, 11, 12, 13]
    with open(training_file, "r") as fp:
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            parts[0] = "1" if int(parts[0]) > 0 else "0"
            parts += user_dict.get(parts[-1], ["0", "0"])
            yield "\t".join(parts[i] for i in reorder) + "\n"


def split_dataset(
    line_iter_fn,
    output_dir: str,
    num_shards: int = 8,
    seed: int = 2018,
    log_fn=print,
):
    # Pass 1: labels.
    labels: List[int] = []
    for line in line_iter_fn():
        labels.append(int(line.split("\t", 1)[0]))
    labels_arr = np.asarray(labels)
    assign = _fold_assignment(labels_arr, seed=seed)
    counts = [int((assign == k).sum()) for k in range(3)]
    log_fn(f"train/val/test rows: {counts}")

    # Pass 2: write shards (train/val/test + trainval = train||val per shard).
    writers = {
        0: _ShardWriter(output_dir, "train", num_shards, counts[0]),
        1: _ShardWriter(output_dir, "val", num_shards, counts[1]),
        2: _ShardWriter(output_dir, "test", num_shards, counts[2]),
        3: _ShardWriter(output_dir, "trainval", num_shards, counts[0] + counts[1]),
    }
    for i, line in enumerate(line_iter_fn()):
        k = int(assign[i])
        writers[k].write(line)
        if k in (0, 1):
            writers[3].write(line)
        if (i + 1) % 1_000_000 == 0:
            log_fn(f"written {i + 1} rows")
    for w in writers.values():
        w.close()
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   choices=["criteo-kaggle", "avazu", "kdd"])
    p.add_argument("--data_path", default=None,
                   help="raw train.txt (criteo/avazu)")
    p.add_argument("--data_dir", default=None,
                   help="dir with training.txt + userid_profile.txt (kdd)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_shards", type=int, default=8)
    p.add_argument("--seed", type=int, default=2018)
    args = p.parse_args(argv)

    if args.dataset == "kdd":
        if not args.data_dir:
            p.error("--data_dir is required for kdd")
        it = lambda: _iter_kdd(args.data_dir)
    else:
        if not args.data_path:
            p.error("--data_path is required")
        it = lambda: _iter_criteo_avazu(args.data_path)
    split_dataset(it, args.output_dir, args.num_shards, args.seed)


if __name__ == "__main__":
    main()
