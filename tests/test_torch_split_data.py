"""The port's `tools/split_data.py` against scikit-learn and the JAX
package's tool, on the host: the NumPy fold assignment equals
StratifiedKFold(n_splits=10, shuffle=True, random_state=2018) on balanced
labels, on 3 % positives and with one class smaller than 10; `split_dataset`
on a criteo-format file written here gives the JAX package's shard files,
byte for byte, and so does the CLI.

Tolerance: none.  Folds and files must be equal.
"""

import warnings

import numpy as np
import pytest

from nasrec_tpu.tools import split_data as jax_split

from nasrec_tpu_torch.data.synthetic import synthetic_tsv_lines
from nasrec_tpu_torch.tools import split_data

sklearn_model_selection = pytest.importorskip("sklearn.model_selection")


def _labels(kind):
    rng = np.random.RandomState(3)
    if kind == "balanced":
        return rng.randint(0, 2, size=1000)
    if kind == "positives-3pct":
        return (rng.rand(5000) < 0.03).astype(np.int64)
    return rng.permutation(np.r_[np.zeros(200, np.int64), np.ones(7, np.int64)])


@pytest.mark.parametrize("kind", ["balanced", "positives-3pct", "class-below-10"])
def test_fold_assignment_equals_scikit_learn(kind):
    labels = _labels(kind)
    folds = np.empty(len(labels), np.int64)
    splitter = sklearn_model_selection.StratifiedKFold(n_splits=10, shuffle=True,
                                                       random_state=2018)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the class of 7 warns
        for fold, (_, idx) in enumerate(splitter.split(np.zeros_like(labels), labels)):
            folds[idx] = fold
    np.testing.assert_array_equal(split_data._stratified_test_folds(labels, 10, 2018), folds)
    want = np.where(folds < 8, 0, np.where(folds < 9, 1, 2)).astype(np.int8)
    np.testing.assert_array_equal(split_data._fold_assignment(labels), want)


def test_too_many_splits_for_every_class_raises():
    with pytest.raises(ValueError, match="n_splits"):
        split_data._stratified_test_folds(np.array([0, 1, 0, 1]), 10, 2018)


@pytest.fixture
def raw_file(tmp_path):
    path = tmp_path / "train.txt"
    lines = synthetic_tsv_lines(3000, 13, 26, np.random.RandomState(5))
    path.write_bytes(b"".join(line + b"\n" for line in lines))
    return path


def _shard_files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.txt"))}


def test_split_dataset_writes_the_jax_packages_shards(raw_file, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_split.split_dataset(lambda: jax_split._iter_criteo_avazu(str(raw_file)),
                                       str(tmp_path / "jax"), num_shards=4, log_fn=lambda s: None)
    got = split_data.split_dataset(lambda: split_data._iter_criteo_avazu(str(raw_file)),
                                   str(tmp_path / "port"), num_shards=4, log_fn=lambda s: None)
    assert got == want and sum(got) == 3000
    files = _shard_files(tmp_path / "port")
    assert len(files) == 16 and files == _shard_files(tmp_path / "jax")


def test_split_data_cli_writes_the_same_shards(raw_file, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_split.main(["--dataset", "criteo-kaggle", "--data_path", str(raw_file),
                        "--output_dir", str(tmp_path / "jax"), "--num_shards", "2"])
    split_data.main(["--dataset", "criteo-kaggle", "--data_path", str(raw_file),
                     "--output_dir", str(tmp_path / "port"), "--num_shards", "2"])
    assert _shard_files(tmp_path / "port") == _shard_files(tmp_path / "jax")
