"""Build the port's CUDA kernels from the sources in `nasrec_tpu_torch/csrc/`
at first use, and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
`sm_90a` into `nasrec_tpu_torch/_build/lib<name>-<hash>.so`, where the hash
covers the source, the headers of `csrc/` (any source may include them) and
the flags, so an edited source or header never loads a stale library.
Nothing is built when a module is imported: `load_library` builds on the
first launch, and `build_all` builds every kernel at once (one `nvcc`
process per source, all started together).

The kernels launch on PyTorch's current stream, allocate nothing, and return
`cudaGetLastError()`; `check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNEL_SOURCES = ("dotprod", "table_update", "attention", "transformer_body", "segment_sum",
                  "dense_adagrad")

_c_ptr, _c_ll, _c_int, _c_float = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
)

# C signature of every exported function: name -> argtypes (restype is int).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "dotprod": {
        "nasrec_dotprod_fwd": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll, _c_int, _c_int,
                               _c_int, _c_ptr),
        "nasrec_dotprod_bwd": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_int, _c_int,
                               _c_int, _c_int, _c_ptr),
    },
    "table_update": {
        "nasrec_table_update": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll,
                                _c_float, _c_float, _c_ptr),
        "nasrec_table_update128": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll,
                                   _c_float, _c_float, _c_ptr, _c_ptr),
    },
    "attention": {
        "nasrec_attn_fwd": (_c_ptr, _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_ptr),
        "nasrec_attn_bwd": (_c_ptr, _c_ptr, _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_ptr),
    },
    "transformer_body": {
        "nasrec_body_fwd": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_int, _c_int,
                            _c_int, _c_int, _c_int, _c_float, _c_ptr),
        "nasrec_body_bwd": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                            _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float,
                            _c_ptr),
    },
    "segment_sum": {
        "nasrec_segment_sum": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll,
                               _c_int, _c_ptr),
        "nasrec_segment_sum128": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                                  _c_ll, _c_int, _c_ptr),
    },
    "dense_adagrad": {
        "nasrec_dense_clip_scale": (_c_ptr, _c_ptr, _c_int, _c_ptr, _c_ll, _c_float, _c_ptr,
                                    _c_ptr),
        "nasrec_dense_adagrad": (_c_ptr, _c_ptr, _c_int, _c_ptr, _c_float, _c_float, _c_ptr),
    },
}

# Every kernel but the table update and the segment-sum (both f32 under bf16
# compute) has a bf16 twin of each entry point, with the same arguments
# (ctypes binds by name).
for _name in ("dotprod", "attention", "transformer_body"):
    SIGNATURES[_name].update({f"{fn}_bf16": args for fn, args in SIGNATURES[_name].items()})

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Compile every library in `names` that is not built yet, one nvcc per
    source, in parallel.  Returns {name: {"seconds", "log"}} for each library
    compiled here (the log holds ptxas's register and shared-memory report).
    Raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """'auto' -> the kernel for a CUDA tensor, the plain version for a CPU one.
    'kernel' on a CPU tensor raises; 'plain' is the plain version by name
    (tests and the on-card comparison)."""
    if impl == "auto":
        return "kernel" if x.is_cuda else "plain"
    if impl == "kernel":
        if not x.is_cuda:
            raise RuntimeError("the CUDA kernel needs CUDA tensors; got a tensor "
                               f"on {x.device}")
        return "kernel"
    if impl == "plain":
        return "plain"
    raise ValueError(f"unknown impl {impl!r}")
