"""Shared attention-score math (the twin of ``tpuscratch.parallel.scores``):
one definition of the scale, the mask sentinel and the f32 contraction.
Tensors may carry leading (stacked mesh) dims."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def masked_scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked scaled scores ``(..., H, S, T)`` in f32 from q ``(..., S, H,
    D)``, k ``(..., T, H, D)`` and a boolean ``(S, T)`` mask (True = attend);
    the contraction is divided by ``sqrt(D)``, as the JAX package does."""
    d = q.shape[-1]
    s = torch.einsum("...shd,...thd->...hst", q.float(), k.float()) / math.sqrt(d)
    return torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))


def masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32 attention weights over the last dim of masked scores: masked
    entries re-zeroed after the exponential, fully masked rows all zero."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.clamp_min(l, 1e-30)
