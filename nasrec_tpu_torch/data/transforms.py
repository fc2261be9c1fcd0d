"""Per-dataset row transforms in NumPy (a copy of
`nasrec_tpu/data/transforms.py`).

Reference semantics (ref: nasrec/utils/data_pipes.py:135-253):
  - dense:  log(max(x, 0) + 1)            (Criteo/KDD; Avazu dense = zeros)
  - categorical: parse hex string (empty -> -1), then fmod(vocab-1) + 1,
    where fmod keeps the dividend's sign (torch.fmod), so empty values map to
    index 0 and real values land in [1, vocab-1].

The raw TSV rows are  label \\t ints... \\t cats...  with the per-dataset
feature counts of `nasrec_tpu_torch.config.DATASETS`; a short row reads its
missing trailing fields as "".

One difference from the JAX package's copy: the dense field is parsed to
float64 and log(max(x, 0) + 1) is evaluated in float64 and rounded once to
float32, as the C++ parser (data/native/fast_parse.cpp) does, so the two
parsers of the port give equal bits.  The JAX package's NumPy transform rounds
x to float32 first and takes the log in float32, which differs from both by
one unit in the last place on a few percent of values.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from nasrec_tpu_torch.config import DATASETS


def hex_to_int(values: Sequence[str]) -> np.ndarray:
    """Vectorised int(v, 16) with empty -> -1 (ref: data_pipes.py:164)."""
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        out[i] = int(v, 16) if v else -1
    return out


def fmod_index(x: np.ndarray, vocab: int) -> np.ndarray:
    """torch-style fmod(vocab-1) + 1: sign follows the dividend, so -1 -> 0."""
    return (np.fmod(x, vocab - 1) + 1).astype(np.int32)


def log1p_dense(x: np.ndarray) -> np.ndarray:
    """log(max(x, 0) + 1) in float64, rounded once to float32."""
    return np.log(np.maximum(np.asarray(x, np.float64), 0.0) + 1.0).astype(np.float32)


def _parse_rows(
    rows: List[List[str]], num_dense: int, num_sparse: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """rows of split TSV fields -> (label f32 [B,1], ints f64 [B,D], cats i64)."""
    n = len(rows)
    labels = np.empty((n, 1), np.float32)
    ints = np.zeros((n, num_dense), np.float64)
    cats = np.empty((n, num_sparse), np.int64)
    for r, row in enumerate(rows):
        # Rows may be short (trailing empty fields stripped); missing -> "".
        row = row + [""] * (1 + num_dense + num_sparse - len(row))
        labels[r, 0] = float(row[0]) if row[0] else 0.0
        for d in range(num_dense):
            v = row[1 + d]
            ints[r, d] = float(v) if v else 0.0  # safe_cast default 0 (ref: torchrec/utils.py:154)
        for s in range(num_sparse):
            v = row[1 + num_dense + s]
            cats[r, s] = int(v, 16) if v else -1
    return labels, ints, cats


def _make_transform(dataset: str, zero_dense: bool, cap: int | None = None) -> Callable:
    spec = DATASETS[dataset]
    vocab = np.asarray(spec.vocab_sizes(cap), np.int64)

    def transform(rows: List[List[str]]):
        labels, ints, cats = _parse_rows(rows, spec.num_dense, spec.num_sparse)
        dense = (
            np.zeros(ints.shape, np.float32) if zero_dense else log1p_dense(ints)
        )
        cat_idx = (np.fmod(cats, vocab[None, :] - 1) + 1).astype(np.int32)
        return dense, cat_idx, labels

    # Metadata read by the C++ parser (data/native/).
    transform.num_dense = spec.num_dense
    transform.num_sparse = spec.num_sparse
    transform.vocab = vocab
    transform.zero_dense = zero_dense
    return transform


transform_criteo = _make_transform("criteo-kaggle", zero_dense=False)
# Avazu's single pseudo-dense feature is always zero (ref: data_pipes.py:179-188).
transform_avazu = _make_transform("avazu", zero_dense=True)
transform_kdd = _make_transform("kdd", zero_dense=False)

TRANSFORMS: Dict[str, Callable] = {
    "criteo-kaggle": transform_criteo,
    "avazu": transform_avazu,
    "kdd": transform_kdd,
}

_ZERO_DENSE = {"criteo-kaggle": False, "avazu": True, "kdd": False}


def get_transform(dataset: str, cap: int | None = None) -> Callable:
    """Transform with a vocabulary cap (cap=SEARCH_MAX_NUM_EMBEDDINGS during
    supernet search; None = uncapped for final evaluation, ref: utils/config.py:17-19).

    The cap MUST match the model's embedding-table sizes."""
    return _make_transform(dataset, _ZERO_DENSE[dataset], cap)
