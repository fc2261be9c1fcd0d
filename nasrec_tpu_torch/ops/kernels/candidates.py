"""The kernels' K-candidate rule: what `torch.func.vmap` over K candidates
does to a kernel's autograd Function (the counterpart of `jax.vmap` over a
`pallas_call`, which adds a grid axis over the candidates).

Under vmap a Function's `vmap` staticmethod gets the candidates' tensors
with their batch axis (`in_dims`).  The rule folds that axis into the
kernel's own batch axis, [K, B, ...] -> [K B, ...] (a view where the layout
allows it), and calls the Function once on the folded tensors outside the
transform: one launch for the group, whose autograd node is an ordinary one,
so its backward gets plain tensors and launches once for the group too.  A
tensor that does not vary over the candidates is expanded to K copies first
(the attention and dot-product kernels have no weights; the transformer body
launches its K-candidate form where its parameters vary, and its
one-candidate form over all K B rows where they do not).
"""

from __future__ import annotations

from typing import Optional

import torch


def fold(t: Optional[torch.Tensor], in_dim: Optional[int], k: int) -> Optional[torch.Tensor]:
    """[K, B, ...] with the candidate axis at `in_dim` (None: t has no such
    axis and is the same for every candidate) -> [K B, ...]."""
    if t is None:
        return None
    t = t.expand(k, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.reshape(k * t.shape[1], *t.shape[2:])


def unfold(t: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    """[K B, ...] -> [K, B, ...] (a view)."""
    return None if t is None else t.reshape(k, t.shape[0] // k, *t.shape[1:])


def stacked(t: torch.Tensor, in_dim: Optional[int], k: int) -> torch.Tensor:
    """A parameter with its candidate axis first, [K, ...]; one that does not
    vary is expanded (a view: autograd sums its K gradients)."""
    return t.expand(k, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
