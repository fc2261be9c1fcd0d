"""ctypes binding of the C++ TSV parser (built with g++ at first use)."""

from nasrec_tpu_torch.data.native.binding import (
    build_error,
    native_available,
    parse_ctr_buffer,
    read_batches_native,
)
