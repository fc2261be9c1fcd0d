"""The port's TSV data layer against the JAX package's on the same files:
transforms, the C++ parser, the shard stream, the binary cache, the copy to
the device, and the cache CLI.

Equal bits everywhere but one place: the JAX package's NumPy transform takes
the dense log in float32, where the port (like both packages' C++ parser)
takes it in float64 and rounds once, so the port's dense features are held
to the JAX NumPy transform's within 1e-6 relative (one unit in the last
place) and to the JAX C++ parser's bit for bit.
"""

import json
import threading

import jax_parser_once  # noqa: F401  (the JAX parser built and loaded under a file lock)
import numpy as np
import pytest
import torch

from nasrec_tpu.data import cache as jax_cache
from nasrec_tpu.data import pipeline as jax_pipeline
from nasrec_tpu.data import transforms as jax_transforms
from nasrec_tpu.data.native import binding as jax_binding

from nasrec_tpu_torch.config import DATASETS, SEARCH_MAX_NUM_EMBEDDINGS
from nasrec_tpu_torch.data import cache, pipeline, transforms
from nasrec_tpu_torch.data.native import binding
from nasrec_tpu_torch.data.synthetic import synthetic_tsv_lines, write_tsv_shards
from nasrec_tpu_torch.tools import build_cache

DATASET_NAMES = ["criteo-kaggle", "avazu", "kdd"]


def _lines(dataset, n, seed):
    spec = DATASETS[dataset]
    return synthetic_tsv_lines(n, spec.num_dense, spec.num_sparse,
                               np.random.RandomState(seed), short_rate=0.1)


def _rows(lines):
    return [l.decode().split("\t") for l in lines]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [None, 1000], ids=["full", "cap1000"])
@pytest.mark.parametrize("dataset", DATASET_NAMES)
def test_transform_matches_jax(dataset, cap):
    lines = _lines(dataset, 400, seed=1) + [b"1", b"0\t-5", b"", b"1\t\t\t"]
    got = transforms.get_transform(dataset, cap)(_rows(lines))
    want = jax_transforms.get_transform(dataset, cap)(_rows(lines))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[1], want[1])       # cats
    np.testing.assert_array_equal(got[2], want[2])       # labels
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    # Empty and negative fields: index 0 and log(1) = 0.
    assert (got[1][-4:-1] == 0).all() and (got[0][-3] == 0).all()
    if dataset == "avazu":
        assert (got[0] == 0).all()
    # The float64 log rounded once is the C++ parser's: equal bits.
    spec = DATASETS[dataset]
    t = jax_transforms.get_transform(dataset, cap)
    native = jax_binding.parse_ctr_buffer(b"\n".join(lines) + b"\n", spec.num_dense,
                                          spec.num_sparse, t.vocab, t.zero_dense)
    for g, w in zip(got, native):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("dataset", DATASET_NAMES)
def test_native_parser_bit_equal_to_numpy_transform(dataset, threads):
    assert binding.native_available(), binding.build_error()
    assert binding.library_path().parent.name == "_build"
    spec = DATASETS[dataset]
    lines = _lines(dataset, 500, seed=2)
    t = transforms.get_transform(dataset, SEARCH_MAX_NUM_EMBEDDINGS)
    got = binding.parse_ctr_buffer(b"\n".join(lines) + b"\n", spec.num_dense,
                                   spec.num_sparse, t.vocab, t.zero_dense, threads)
    want = t(_rows(lines))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def tsv_root(tmp_path_factory):
    """3 shards of criteo-shaped rows; each shard's last train and test batch
    of 64 is short."""
    root = tmp_path_factory.mktemp("tsv")
    write_tsv_shards(str(root), 13, 26, {"trainval": 3 * 250, "test": 3 * 90}, 3, seed=3)
    return str(root)


@pytest.mark.parametrize("host,hosts,cap", [(0, 1, None), (0, 2, None), (1, 2, 1000)])
def test_dataset_iterators_match_jax(tsv_root, host, hosts, cap):
    kw = dict(train_batch_size=64, test_batch_size=64, vocab_cap=cap,
              host_id=host, num_hosts=hosts)
    p_train, p_test = pipeline.make_dataset_iterators("criteo-kaggle", tsv_root, **kw)
    j_train, j_test = jax_pipeline.make_dataset_iterators("criteo-kaggle", tsv_root, **kw)
    train, test = list(p_train()), list(p_test())
    _assert_batches_equal(train, list(j_train()))
    _assert_batches_equal(test, list(j_test()))
    shards = len(range(host, 3, hosts))
    assert len(train) == shards * (250 // 64)                 # short batches dropped
    assert sorted(len(b[2]) for b in test) == sorted([64] * shards + [90 - 64] * shards)
    # The NumPy parser streams the same batches.
    slow = pipeline.batch_iterator(pipeline.shard_paths(tsv_root, "test", host, hosts), 64,
                                   transforms.get_transform("criteo-kaggle", cap),
                                   drop_remainder=False, use_native=False)
    _assert_batches_equal(list(slow), test)


@pytest.mark.parametrize("shuffle", [False, True])
def test_binary_cache_opens_across_packages(tsv_root, tmp_path, shuffle):
    mine = cache.build_binary_cache("criteo-kaggle", tsv_root, "trainval",
                                    str(tmp_path / "port"), vocab_cap=1000)
    theirs = jax_cache.build_binary_cache("criteo-kaggle", tsv_root, "trainval",
                                          str(tmp_path / "jax"), vocab_cap=1000)
    assert mine.endswith("trainval-h0") and theirs.endswith("trainval-h0")
    with open(mine + ".meta.json") as f, open(theirs + ".meta.json") as g:
        assert json.load(f) == json.load(g)
    kw = dict(shuffle=shuffle, seed=5, drop_remainder=False)
    for prefix in (mine, theirs):
        got = list(cache.open_binary_cache(prefix, 100, **kw))
        want = list(jax_cache.open_binary_cache(prefix, 100, **kw))
        _assert_batches_equal(got, want)
        assert sum(len(b[2]) for b in got) == 750
    # Its rows are the stream's rows.
    stream = list(pipeline.batch_iterator(pipeline.shard_paths(tsv_root, "trainval"), 750,
                                          transforms.get_transform("criteo-kaggle", 1000),
                                          drop_remainder=False, interleave=False))
    _assert_batches_equal(list(cache.open_binary_cache(mine, 750)),
                          [tuple(np.concatenate(p) for p in zip(*stream))])


def test_device_prefetch_cpu_passthrough_keeps_order():
    rng = np.random.RandomState(0)
    batches = [(rng.randn(5, 3).astype(np.float32), rng.randint(0, 9, (5, 2)).astype(np.int32),
                rng.rand(5, 1).astype(np.float32)) for _ in range(7)]
    out = list(pipeline.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 7
    for got, want in zip(out, batches):
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), w)


def test_prefetch_raises_the_worker_error_and_stops_on_close():
    def failing():
        yield 1
        raise OSError("disk gone")

    it = pipeline.prefetch(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    before = set(threading.enumerate())
    it = pipeline.prefetch(iter(range(1000)), depth=2)
    assert next(it) == 0
    workers = [t for t in threading.enumerate() if t not in before]
    assert len(workers) == 1
    it.close()
    workers[0].join(timeout=5)
    assert not workers[0].is_alive()


def test_native_refusal_and_auto_fallback(tsv_root, monkeypatch, capsys):
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_build_error", "g++ exited with 1: no compiler")
    monkeypatch.setattr(pipeline, "_fallback_said", threading.Event())
    t = transforms.get_transform("criteo-kaggle")
    path = pipeline.shard_paths(tsv_root, "test")[0]
    with pytest.raises(RuntimeError, match="no compiler"):
        next(pipeline._read_batches(path, 32, t, use_native=True))
    got = list(pipeline._read_batches(path, 32, t, use_native="auto"))
    assert "NumPy transforms" in capsys.readouterr().err
    assert sum(len(b[2]) for b in got) == 90


def test_build_cache_cli(tsv_root, tmp_path):
    prefix = build_cache.main(["--dataset", "criteo-kaggle", "--root_dir", tsv_root,
                               "--split", "test", "--out_dir", str(tmp_path), "--cap_vocab", "1"])
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    assert meta == {"dataset": "criteo-kaggle", "rows": 270, "num_dense": 13,
                    "num_sparse": 26, "vocab_cap": SEARCH_MAX_NUM_EMBEDDINGS}
    dense = np.load(prefix + ".dense.npy")
    assert dense.shape == (270, 13) and dense.dtype == np.float32
    # The JAX package streams the port's cache.
    assert sum(len(b[2]) for b in jax_cache.open_binary_cache(prefix, 64, drop_remainder=False)) == 270
