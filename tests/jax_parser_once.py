"""Builds (where it is missing) and loads the JAX package's C++ parser under
an inter-process file lock, once a process, when a test file of the port
that compares against that parser imports this module at its collection.

The JAX package's binding compiles straight into `libfastparse.so` under a
lock of one process only, so two xdist workers of a fresh checkout could
otherwise build at once, and one load the other's half-written library.
Every worker collects every file before it runs a test, so each has the
parser loaded, under the lock, before any test of any worker runs."""

import fcntl
import hashlib
import os
import tempfile

from nasrec_tpu.data.native import binding

_key = hashlib.sha256(binding._SO.encode()).hexdigest()[:16]
_lock = os.path.join(tempfile.gettempdir(), f"nasrec-tpu-fastparse-{_key}.lock")
with open(_lock, "w") as _f:             # closing the file releases the lock
    fcntl.flock(_f, fcntl.LOCK_EX)
    binding.native_available()
