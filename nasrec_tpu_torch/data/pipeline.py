"""Host input pipeline: shard discovery, interleaved streaming, prefetch, and
the copy to the card (a copy of `nasrec_tpu/data/pipeline.py`, with
`device_prefetch` written for CUDA).

  - shard directories `shard-*/` are discovered and assigned round-robin to
    hosts (`shard_idx % num_hosts == host_id`);
  - each shard is streamed in large chunks through the C++ parser
    (data/native/) or, where it cannot be built and the caller allows it, line
    by line through the NumPy transforms; batches from this host's shards are
    interleaved round-robin (the mixing of the reference's worker per shard,
    ref: nasrec/torchrec/utils.py:263-302);
  - a background thread keeps a small queue of parsed host batches;
  - `device_prefetch` copies batches to the card from pinned host memory on a
    side stream, `depth` batches ahead of the step that reads them;
  - for repeated epochs, convert the shards once to the binary cache
    (data/cache.py) and stream memory-mapped batches instead.
"""

from __future__ import annotations

import collections
import glob
import os
import queue
import sys
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from nasrec_tpu_torch import tracing
from nasrec_tpu_torch.data.transforms import get_transform

_fallback_said = threading.Event()


def shard_paths(
    root_dir: str,
    split: str,
    host_id: int = 0,
    num_hosts: int = 1,
) -> List[str]:
    """This host's shard files, e.g. root/shard-3/train.txt
    (ref shard layout: nasrec/tools/autoctr_split_data_*.py)."""
    dirs = sorted(glob.glob(os.path.join(root_dir, "shard-*")))
    if not dirs:
        raise FileNotFoundError(f"no shard-* dirs under {root_dir!r}")
    mine = [d for i, d in enumerate(dirs) if i % num_hosts == host_id]
    return [os.path.join(d, f"{split}.txt") for d in mine]


def _read_batches(
    path: str, batch_size: int, transform: Callable, use_native: str | bool = "auto"
) -> Iterator:
    """Stream one shard as transformed batches.

    use_native: True takes the C++ parser and raises if it cannot be built;
    "auto" takes it where it builds and otherwise falls back, with a printed
    line, to the NumPy row parser (about 100x slower); False takes the NumPy
    parser."""
    if use_native not in ("auto", True, False):
        raise ValueError(f"use_native must be 'auto', True or False, got {use_native!r}")
    if use_native is not False:
        from nasrec_tpu_torch.data.native import build_error, read_batches_native

        reason = build_error()
        if reason is None:
            yield from read_batches_native(
                path, batch_size, transform.num_dense, transform.num_sparse,
                transform.vocab, transform.zero_dense,
            )
            return
        if use_native is True:
            raise RuntimeError(f"native parser requested but unavailable: {reason}")
        if not _fallback_said.is_set():
            _fallback_said.set()
            print(f"native parser unavailable ({reason.splitlines()[0]}); "
                  "parsing TSV with the NumPy transforms", file=sys.stderr, flush=True)
    rows: List[List[str]] = []
    with open(path, "r") as f:
        for line in f:
            rows.append(line.rstrip("\n").split("\t"))
            if len(rows) == batch_size:
                yield transform(rows)
                rows = []
    if rows:
        yield transform(rows)


def batch_iterator(
    paths: List[str],
    batch_size: int,
    transform: Callable,
    *,
    drop_remainder: bool = True,
    interleave: bool = True,
    use_native: str | bool = "auto",
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Round-robin interleave of per-shard batch streams (each shard's short
    last batch is dropped when drop_remainder)."""
    if interleave and len(paths) > 1:
        alive = [_read_batches(p, batch_size, transform, use_native) for p in paths]
        while alive:
            nxt = []
            for s in alive:
                try:
                    batch = next(s)
                    if drop_remainder and len(batch[2]) < batch_size:
                        continue
                    yield batch
                    nxt.append(s)
                except StopIteration:
                    pass
            alive = nxt
    else:
        for p in paths:
            for batch in _read_batches(p, batch_size, transform, use_native):
                if drop_remainder and len(batch[2]) < batch_size:
                    continue
                yield batch


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it: Iterable, depth: int = 4) -> Iterator:
    """Run `it` in a background thread with a bounded queue.  An exception in
    the thread is raised in the consumer; closing the consumer stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(done)
        except Exception as e:  # handed to the consumer, which raises it
            put(_Failed(e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with tracing.span("data.queue_wait"):
                item = q.get()
            if item is done:
                return
            if isinstance(item, _Failed):
                raise item.exc
            yield item
    finally:
        stop.set()


def device_prefetch(it: Iterable, device: str | torch.device, depth: int = 2) -> Iterator:
    """Batches of numpy arrays -> tuples of tensors on `device`, in order.

    On a CUDA device each batch is copied into pinned host memory and sent
    with non_blocking copies on a side stream, `depth` batches ahead of the
    consumer; the consumer's stream waits on the copy's event before the batch
    is handed out, and each tensor is recorded on that stream so that the
    allocator does not reuse its memory while the consumer's work is queued.
    On the CPU it is a torch.from_numpy pass-through."""
    device = torch.device(device)
    if device.type == "cpu":
        for batch in it:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        return
    if device.type != "cuda":
        raise ValueError(f"device_prefetch: unsupported device {device}")
    side = torch.cuda.Stream(device)
    consumer = torch.cuda.current_stream(device)
    ahead: collections.deque = collections.deque()
    it = iter(it)

    def send(batch):
        with tracing.span("data.pin"):
            host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in batch]
        with tracing.span("data.h2d"), torch.cuda.stream(side):
            out = tuple(h.to(device, non_blocking=True) for h in host)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    while True:
        # The batch handed out and the `depth` behind it are sent before the
        # consumer's stream waits on the first.
        with tracing.span("data.next"):
            while len(ahead) <= depth:
                nxt = next(it, None)
                if nxt is None:
                    break
                ahead.append(send(nxt))
            if not ahead:
                return
            out, ready = ahead.popleft()
            consumer.wait_event(ready)
            for t in out:
                t.record_stream(consumer)
        yield out


def make_dataset_iterators(
    dataset: str,
    root_dir: str,
    *,
    train_batch_size: int,
    test_batch_size: int,
    train_split: str = "trainval",
    validate_split: str = "test",
    vocab_cap: Optional[int] = None,
    host_id: int = 0,
    num_hosts: int = 1,
    prefetch_depth: int = 4,
    use_native: str | bool = "auto",
):
    """(train_iter_fn, test_iter_fn) of numpy batches, mirroring
    get_*_kaggle_pipes (ref: nasrec/utils/data_pipes.py:36-133): the train
    stream drops each shard's short last batch, the test stream keeps it."""
    transform = get_transform(dataset, vocab_cap)
    train_paths = shard_paths(root_dir, train_split, host_id, num_hosts)
    test_paths = shard_paths(root_dir, validate_split, host_id, num_hosts)

    def train_iter():
        return prefetch(
            batch_iterator(train_paths, train_batch_size, transform,
                           use_native=use_native),
            depth=prefetch_depth,
        )

    def test_iter():
        return prefetch(
            batch_iterator(test_paths, test_batch_size, transform,
                           drop_remainder=False, use_native=use_native),
            depth=prefetch_depth,
        )

    return train_iter, test_iter
