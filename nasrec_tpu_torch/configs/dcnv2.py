"""DLRM-DCNv2 as MLPerf Training runs it on Criteo 1TB with synthetic
multi-hot features (github.com/mlcommons/training,
recommendation_v2/torchrec_dlrm, the reference command's flags; Wang et al.,
arXiv:2008.13535): the published table rows and bag sizes, the widths, and
the optimiser.

`DCNV2_CRITEO1TB` holds the whole tables.  A deployment splits every table
row-wise over the cards of a host; `row_share(config, shards)` is one
card's share (each slot's first ceil(rows / shards) rows), the cut that
MLPerf's tables need to fit: 204,184,588 rows of 128 float32 are 104.5 GB.
"""

from __future__ import annotations

import dataclasses

from nasrec_tpu_torch.models.dcn import DCNv2Config

CRITEO_1TB_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
                   3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
                   40000000, 590152, 12973, 108, 36)
MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3,
                   1, 1)

DCNV2_CRITEO1TB = DCNv2Config(vocab_sizes=CRITEO_1TB_ROWS, bag_sizes=MULTI_HOT_SIZES)

# The optimiser of MLPerf's reference command: Adagrad for the dense and the
# sparse parameters at a constant rate, no clip, no weight decay.  eps is
# assumed: FBGEMM's default for its fused Adagrad.
LEARNING_RATE = 0.005
ADAGRAD_EPS = 1e-8


def row_share(config: DCNv2Config, shards: int) -> DCNv2Config:
    """One card's share of every table split row-wise over `shards` cards;
    the table's init keeps the whole table's bound."""
    return dataclasses.replace(
        config, vocab_sizes=tuple(-(-v // shards) for v in config.vocab_sizes),
        init_rows=config.init_rows or config.vocab_sizes)
