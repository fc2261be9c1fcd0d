"""Initial weights made from the run's seed, on the device, in a few calls.

The recipe of each parameter (`reference.nasrec_ref.init_specs`: the
reference's names and shapes, NasRec's initialisers) is turned into tensors by
one uniform draw for all the dense parameters and one normal draw for the
table, each scaled in place.  The same seed gives the same weights on the
same device, so the reference makes them again after the window.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the stream `what` of run seed `seed` (any integer)."""
    h = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def make_weights(specs: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for `specs` = [(name, shape, kind, a)]."""
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    dense = [s for s in specs if s[2] != "table"]
    sizes = [int(np.prod(s[1])) for s in dense]
    flat = torch.empty(sum(sizes), device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(seed, "dense-weights", device))
    scale = torch.as_tensor([s[3] if s[2] == "uniform" else 0.0 for s in dense],
                            dtype=torch.float32, device=device)
    shift = torch.as_tensor([s[3] if s[2] == "const" else 0.0 for s in dense],
                            dtype=torch.float32, device=device)
    counts = torch.as_tensor(sizes, device=device)
    flat.mul_(torch.repeat_interleave(scale, counts)).add_(torch.repeat_interleave(shift, counts))
    for (name, shape, _, _), part in zip(dense, torch.split(flat, sizes)):
        out[name] = part.view(shape)
    for name, shape, kind, slots in specs:
        if kind != "table":
            continue
        t = torch.empty(shape, device=device)
        t.normal_(0.0, 1.0, generator=generator(seed, "table", device))
        start = 0
        for rows, std in slots:
            t[start:start + rows].mul_(std)
            start += rows
        out[name] = t
    return out
