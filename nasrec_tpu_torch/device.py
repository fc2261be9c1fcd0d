"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A request
for CUDA on a machine without a card raises instead of falling back.  Under a
torch.distributed process group, "cuda" is card `rank % count`: each rank its
own card where there are several, every rank card 0 on a one-card machine.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if d.type == "cuda" and d.index is None and dist.is_initialized():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return d
