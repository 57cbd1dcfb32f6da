"""Staged pipeline parallelism: microbatches streaming through a stage chain.

The twin of ``tpuscratch.parallel.pipeline``. Each rank of a mesh axis owns
one stage of a layer chain; activations hop stage to stage over an open
``ppermute`` chain while microbatches stream in behind each other: the GPipe
schedule, ``M + n - 1`` ticks for M microbatches over n stages, so the
bubble is ``(n-1)/(M+n-1)``.

On the stacked mesh the tick loop is a Python loop, and a tick computes
every stage at once: ``stage_fn`` runs once on the stacked ``(*mesh, ...)``
activations, one batched op over the stage dim. Stage 0's injection, the
validity mask of the aux term and the last stage's emit are selections by
``axis_index``, not arithmetic. Stage shapes must be uniform (every stage
maps ``(..., F) -> (..., F)``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.p2p import ppermute
from tpuscratch_torch.comm.spmd import axis_index, axis_size, current_mesh

__all__ = ["bubble_fraction", "gpipe_scan", "pipeline_apply"]


def _under(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``(*mesh)`` mask with unit dims appended up to ``ndim`` dims."""
    return mask.reshape(*mask.shape, *(1,) * (ndim - mask.ndim))


def gpipe_scan(stage_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
               micro: torch.Tensor, axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The GPipe tick loop, the one schedule :func:`pipeline_apply` and the
    pipelined loss (``models.transformer._pp_loss_fn``) both run.

    ``stage_fn(x) -> (y, aux)``: every rank's stage on the stacked ``(*mesh,
    ...)`` activation ``x`` (close over the stage parameters),
    shape-preserving, plus an auxiliary term ``(*mesh)`` (the MoE
    load-balance loss; zeros when unused). ``micro``: the stacked ``(*mesh,
    M, ...)`` microbatch stack, replicated across ``axis``. Returns

    - ``out``: the ``(*mesh, M, ...)`` outputs of the full stage chain,
      replicated over ``axis`` (the masked sum from the last stage);
    - ``aux``: ``(*mesh)``, the sum over (stage, valid tick) of the aux
      term; warmup and drain ticks, where a stage holds no microbatch, are
      masked out.

    Call inside ``run_spmd``. The emitted outputs are kept as a list and
    stacked once at the end (no per-tick copy of the output buffer)."""
    n = axis_size(axis)
    me = axis_index(axis)
    lead = len(current_mesh().shape)
    M = micro.shape[lead]
    shift = [(i, i + 1) for i in range(n - 1)]  # open chain: stage i -> i+1
    act = torch.zeros_like(micro.select(lead, 0))
    first = _under(me == 0, act.ndim)
    aux_acc = torch.zeros(me.shape, dtype=torch.float32, device=micro.device)
    emitted = []
    for t in range(M + n - 1):
        incoming = ppermute(act, axis, shift) if n > 1 else act
        inject = micro.select(lead, t) if t < M else torch.zeros_like(act)
        y, aux = stage_fn(torch.where(first, inject, incoming))
        valid = (t - me >= 0) & (t - me < M)
        aux_acc = aux_acc + torch.where(valid, aux, 0.0)
        if t >= n - 1:  # microbatch t - (n-1) leaves the last stage
            emitted.append(y)
        act = y
    out = torch.stack(emitted, dim=lead)
    # only the last stage's outputs are results; replicate them
    out = allreduce_sum(torch.where(_under(me == n - 1, out.ndim), out, 0.0), axis)
    return out, allreduce_sum(aux_acc, axis)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], params: Any,
                   micro: torch.Tensor, axis: str) -> torch.Tensor:
    """The full stage chain applied to every microbatch, pipelined.

    ``stage_fn(params, x)``: every rank's stage on stacked values,
    shape-preserving. ``params``: the stage parameters, stacked (split the
    ``(n, ...)`` parameters over ``axis`` by the in_specs). ``micro``: the
    ``(*mesh, M, ...)`` microbatch stack, replicated across the axis.
    Returns the ``(*mesh, M, ...)`` outputs of stage_{n-1}(...stage_0(x)...),
    replicated. Call inside ``run_spmd``."""
    lead = len(current_mesh().shape)
    if axis_size(axis) == 1:
        return torch.stack([stage_fn(params, micro.select(lead, i))
                            for i in range(micro.shape[lead])], dim=lead)
    zeros = torch.zeros(current_mesh().shape, dtype=torch.float32, device=micro.device)
    out, _ = gpipe_scan(lambda x: (stage_fn(params, x), zeros), micro, axis)
    return out


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule: (n-1)/(M+n-1)."""
    if n_stages < 1 or n_micro < 1:
        raise ValueError("need at least one stage and one microbatch")
    return (n_stages - 1) / (n_micro + n_stages - 1)
