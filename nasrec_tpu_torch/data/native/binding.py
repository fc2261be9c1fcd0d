"""Build and bind the C++ TSV parser (fast_parse.cpp) with ctypes (a copy of
`nasrec_tpu/data/native/binding.py`).

The library is compiled with g++ on first use into
`nasrec_tpu_torch/_build/libfastparse-<hash>.so`, where the hash covers the
source and the flags, so an edited source never loads a stale library; the
compile writes a temporary file and renames it into place, so processes that
build at once each load a whole library.  Nothing is built when the module is
imported.  `native_available()` is False when the build fails (no compiler);
`build_error()` then says why, and the pipeline decides whether to raise or
to fall back to the NumPy transforms.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from nasrec_tpu_torch import tracing

_SRC = Path(__file__).resolve().parent / "fast_parse.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + _SRC.read_bytes())
    return BUILD_DIR / f"libfastparse-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile into `out`; None on success, else the reason it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(_SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"{cmd[0]}: {e}"
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"g++ exited with {proc.returncode}: {proc.stderr[-2000:]}"
    os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build_error = _build(so)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _build_error = f"loading {so}: {e}"
            return None
        lib.parse_ctr_buffer.restype = ctypes.c_int64
        lib.parse_ctr_buffer.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.count_rows.restype = ctypes.c_int64
        lib.count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the parser is unavailable (None if it built and loaded)."""
    _load()
    return _build_error


def default_threads() -> int:
    return min(4, os.cpu_count() or 1)


def parse_ctr_buffer(
    buf: bytes,
    num_dense: int,
    num_sparse: int,
    vocab_sizes: np.ndarray,
    zero_dense: bool,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a bytes buffer of complete TSV lines -> (dense, cat, label)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_build_error}")
    if num_threads <= 0:
        num_threads = default_threads()
    n = lib.count_rows(buf, len(buf))
    labels = np.empty((n, 1), np.float32)
    dense = np.empty((n, num_dense), np.float32)
    cats = np.empty((n, num_sparse), np.int32)
    vocab = np.ascontiguousarray(vocab_sizes, dtype=np.int64)
    if len(vocab) != num_sparse:
        raise ValueError(f"{len(vocab)} vocab sizes for {num_sparse} sparse fields")
    written = lib.parse_ctr_buffer(
        buf, len(buf), num_dense, num_sparse, int(zero_dense),
        vocab.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_threads,
    )
    if written != n:
        raise RuntimeError(f"native parser wrote {written} of {n} rows")
    return dense, cats, labels


def _parse_counted(buf: bytes, num_dense: int, num_sparse: int, vocab_sizes, zero_dense):
    """parse_ctr_buffer inside the span `data.parse`, its rows counted there."""
    with tracing.span("data.parse"):
        parsed = parse_ctr_buffer(buf, num_dense, num_sparse, vocab_sizes, zero_dense)
        tracing.count("data.rows_parsed", len(parsed[2]))
    return parsed


def _take(pend: list, rows: int):
    """Pop the first `rows` rows off a queue of parsed (dense, cat, label)
    chunks, as one batch."""
    parts_d, parts_c, parts_l = [], [], []
    need = rows
    while need > 0:
        d, c, l = pend[0]
        if len(l) <= need:
            parts_d.append(d); parts_c.append(c); parts_l.append(l)
            need -= len(l)
            pend.pop(0)
        else:
            parts_d.append(d[:need]); parts_c.append(c[:need]); parts_l.append(l[:need])
            pend[0] = (d[need:], c[need:], l[need:])
            need = 0
    return tuple(parts[0] if len(parts) == 1 else np.concatenate(parts)
                 for parts in (parts_d, parts_c, parts_l))


def read_batches_native(
    path: str,
    batch_size: int,
    num_dense: int,
    num_sparse: int,
    vocab_sizes: np.ndarray,
    zero_dense: bool,
    chunk_bytes: int = 32 << 20,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream a TSV shard in large chunks through the native parser, emitting
    fixed-size batches (the final short batch is emitted too; callers drop it
    if needed)."""
    pend: list = []
    pend_rows = 0
    with open(path, "rb") as f:
        tail = b""
        while True:
            # The read, the last chunk's tail joined, the cut at the last newline.
            with tracing.span("data.read"):
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                chunk = tail + chunk
                nl = chunk.rfind(b"\n")
                if nl < 0:
                    tail = chunk
                    continue
                tail = chunk[nl + 1:]
                lines = chunk[: nl + 1]
            parsed = _parse_counted(lines, num_dense, num_sparse, vocab_sizes, zero_dense)
            pend.append(parsed)
            pend_rows += len(parsed[2])
            while pend_rows >= batch_size:
                pend_rows -= batch_size
                yield _take(pend, batch_size)
        if tail:
            parsed = _parse_counted(tail + b"\n", num_dense, num_sparse, vocab_sizes,
                                    zero_dense)
            pend.append(parsed)
            pend_rows += len(parsed[2])
    while pend_rows > 0:
        take = min(batch_size, pend_rows)
        pend_rows -= take
        yield _take(pend, take)
