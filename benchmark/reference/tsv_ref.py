"""Plain parse of Criteo-format TSV lines (NasRec `utils/data_pipes.py`):
label, then dense log(max(x, 0) + 1) (empty: 0), then each categorical field
as a hex integer (empty: -1) folded into its table by fmod(x, vocab - 1) + 1,
the sign following the dividend.  A short line reads its missing fields as
empty."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def parse(lines: List[bytes], num_dense: int, vocab: Sequence[int]):
    """-> (dense f32 [N, D], cat int32 [N, S], label f32 [N, 1])."""
    n, s = len(lines), len(vocab)
    label = np.zeros((n, 1), np.float32)
    ints = np.zeros((n, num_dense), np.float64)
    cats = np.full((n, s), -1, np.int64)
    for r, line in enumerate(lines):
        f = line.split(b"\t")
        label[r, 0] = float(f[0]) if f[0] else 0.0
        for d, v in enumerate(f[1:1 + num_dense]):
            if v:
                ints[r, d] = float(v)
        for c, v in enumerate(f[1 + num_dense:1 + num_dense + s]):
            if v:
                cats[r, c] = int(v, 16)
    dense = np.log(np.maximum(ints, 0.0) + 1.0).astype(np.float32)
    cat = (np.fmod(cats, np.asarray(vocab, np.int64)[None, :] - 1) + 1).astype(np.int32)
    return dense, cat, label
