"""Ulysses-style sequence parallelism: all-to-all head/sequence re-split.

The twin of ``tpuscratch.parallel.ulysses``: one ``all_to_all`` re-splits
the activations from sequence-split to head-split, each rank runs exact
attention for its heads over the full sequence, and a second
``all_to_all`` restores the sequence split. Needs ``n_heads %
axis_size == 0``. Tensors are stacked ``(*mesh, *batch, S, H, D)``; call
inside ``run_spmd``.
"""

from __future__ import annotations

import torch

from tpuscratch_torch.comm.collectives import all_to_all
from tpuscratch_torch.comm.spmd import AxisName, axis_size
from tpuscratch_torch.parallel.scores import masked_scores


def _attn(q, k, v, causal: bool) -> torch.Tensor:
    """Exact attention ``(..., S, H, D)`` -> ``(..., S, H, D)``, f32
    accumulation, the (H, S, T) scores materialized."""
    S, T = q.shape[-3], k.shape[-3]
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    p = torch.softmax(masked_scores(q, k, mask), dim=-1)
    return torch.einsum("...hst,...thd->...shd", p, v.float()).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: AxisName,
                      causal: bool = False, impl: str = "xla") -> torch.Tensor:
    """Exact attention, sequence split over ``axis``, via all-to-all: q, k,
    v ``(*mesh, *batch, S, H, D)`` blocks of a global ``n*S`` sequence with
    H divisible by the axis size -> the ``(*mesh, *batch, S, H, D)`` output
    block. ``impl`` "xla" materializes the local scores; "pallas" runs the
    differentiable flash kernels (``ops.attention.flash_attention``) over
    the gathered sequence."""
    if q.ndim < 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected equal (S,H,D) blocks, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    H = q.shape[-2]
    n = axis_size(axis)
    if H % n:
        raise ValueError(f"n_heads {H} not divisible by axis size {n}")

    def seq_to_heads(x):  # (S, H, D) seq-split -> (n*S, H/n, D) head-split
        return all_to_all(x, axis, split_axis=-2, concat_axis=-3, tiled=True)

    def heads_to_seq(x):
        return all_to_all(x, axis, split_axis=-3, concat_axis=-2, tiled=True)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if impl == "pallas":
        from tpuscratch_torch.ops.attention import flash_attention

        out = flash_attention(qh, kh, vh, causal=causal)
    elif impl == "xla":
        out = _attn(qh, kh, vh, causal)
    else:
        raise ValueError(f"unknown ulysses impl {impl!r}")
    return heads_to_seq(out)
