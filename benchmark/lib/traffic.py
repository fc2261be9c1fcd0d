"""The benchmark's one traffic generator: batches made on the device, and
Criteo-format TSV text made on the device and written out as bytes, both
from the run's seed and a cell's parameters.

Batch i of a run is drawn from its own generator (seed, i), so any batch can
be made again without the ones before it, and every seed draws the same
sizes: only the values move.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from lib.weights import generator


def device_batch(seed: int, i: int, batch: int, vocab: Sequence[int], num_dense: int,
                 label_rate: float, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dense f32 [B, D] ~ N(0, 1), per-slot indices int32 [B, S], each slot's
    uniform over its own table, labels f32 [B, 1] ~ Bernoulli(label_rate))."""
    g = generator(seed, f"batch-{i}", device)
    dense = torch.randn(batch, num_dense, generator=g, device=device)
    u = torch.rand(batch, len(vocab), generator=g, device=device, dtype=torch.float64)
    cat = (u * torch.as_tensor(list(vocab), dtype=torch.float64, device=device)).to(torch.int32)
    y = (torch.rand(batch, 1, generator=g, device=device) < label_rate).float()
    return dense, cat, y


_HEX = b"0123456789abcdef"
_LOW, _HIGH = -3, 1000          # the dense fields' integers


def _decimal_table() -> torch.Tensor:
    """[_HIGH - _LOW, 4] uint8: each integer's decimal text, left-aligned,
    padded with 0."""
    rows = [str(v).encode().ljust(4, b"\0") for v in range(_LOW, _HIGH)]
    return torch.frombuffer(bytearray(b"".join(rows)), dtype=torch.uint8).view(-1, 4)


def tsv_shard(seed: int, shard: int, rows: int, num_dense: int, num_sparse: int,
              missing_rate: float, short_rate: float, label_rate: float,
              device="cpu") -> bytes:
    """`rows` Criteo-format lines (label, `num_dense` decimal integers in
    [-3, 1000), `num_sparse` 8-digit hex values over 31 bits, tab-separated),
    with `missing_rate` of the fields empty and `short_rate` of the lines cut
    after a random field.  Built on `device` as one byte matrix whose padding
    is dropped."""
    g = generator(seed, f"tsv-{shard}", device)
    kw = dict(generator=g, device=device)
    fields = 1 + num_dense + num_sparse
    label = (torch.rand(rows, **kw) < label_rate).to(torch.uint8) + ord("0")
    text = _decimal_table().to(device)[torch.randint(_LOW, _HIGH, (rows, num_dense), **kw) - _LOW]
    vals = torch.randint(0, 1 << 31, (rows, num_sparse), **kw)
    nibbles = (vals[:, :, None] >> torch.arange(28, -1, -4, device=device)) & 15
    hexd = torch.frombuffer(bytearray(_HEX), dtype=torch.uint8).to(device)[nibbles]
    # One cell a field: a tab and the field's bytes (0 = nothing); the label's
    # cell has no tab.
    cells = torch.zeros(rows, fields, 9, dtype=torch.uint8, device=device)
    cells[:, 0, 0] = label
    cells[:, 1:, 0] = ord("\t")
    cells[:, 1:1 + num_dense, 1:5] = text
    cells[:, 1 + num_dense:, 1:9] = hexd
    empty = torch.rand(rows, fields - 1, **kw) < missing_rate
    cells[:, 1:, 1:][empty] = 0
    keep = torch.where(torch.rand(rows, **kw) < short_rate,
                       torch.randint(1, fields, (rows,), **kw), fields)
    cells[torch.arange(fields, device=device)[None, :] >= keep[:, None]] = 0
    line = torch.cat([cells.reshape(rows, -1),
                      torch.full((rows, 1), ord("\n"), dtype=torch.uint8, device=device)], 1)
    return line[line != 0].cpu().numpy().tobytes()


def tsv_shards(seed: int, tsv: dict, num_dense: int, num_sparse: int,
               label_rate: float, device="cpu") -> List[bytes]:
    return [tsv_shard(seed, s, tsv["rows_per_shard"], num_dense, num_sparse,
                      tsv["missing_rate"], tsv["short_rate"], label_rate, device)
            for s in range(tsv["shards"])]


def tsv_batch_lines(shards: List[bytes], k: int, batch: int) -> List[bytes]:
    """The lines of batch k of a pass over the shards read in turn, one batch
    from each shard (the shards hold whole batches)."""
    lines = shards[k % len(shards)].split(b"\n")
    start = (k // len(shards)) * batch
    return lines[start:start + batch]
