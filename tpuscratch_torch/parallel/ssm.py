"""Sequence-parallel linear recurrence: the SSM scan over a mesh axis.

The twin of ``tpuscratch.parallel.ssm``. A state-space model advances
``h_t = a_t * h_{t-1} + b_t`` along the sequence; a sequence split across
ranks carries the recurrence over shard boundaries. The pair ``(a, b)``
composes associatively,

    (a1, b1) . (a2, b2) = (a1*a2, b2 + a2*b1)   [segment 1, then segment 2]

so each rank scans its shard locally (a log-depth scan over torch ops in
``lax.associative_scan``'s pairing), publishes its shard aggregate (one
pair, not the sequence), and the exclusive scan of the n aggregates is one
small all_gather plus a static masked combine. The JAX package has no
Pallas kernel here, so the port has no CUDA kernel either.
"""

from __future__ import annotations

import torch

from tpuscratch_torch.comm.collectives import all_gather
from tpuscratch_torch.comm.spmd import axis_index, current_mesh

__all__ = ["local_scan", "ssm_scan"]


def _combine(left, right):
    """Compose two (A, B) recurrence segments, left first."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, b2 + a2 * b1


def _sl(x: torch.Tensor, dim: int, start: int, stop=None, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along ``dim`` (``even`` may hold one more)."""
    n = even.shape[dim] + odd.shape[dim]
    if even.shape[dim] > odd.shape[dim]:
        pad = torch.zeros_like(_sl(even, dim, 0, 1))
        odd = torch.cat([odd, pad], dim=dim)
    out = torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)
    return _sl(out, dim, 0, n)


def _scan(elems, dim: int):
    """The inclusive scan of ``lax.associative_scan``: combine adjacent
    pairs, scan those recursively (the odd outputs), then combine each odd
    output with the next element (the even outputs) and interleave."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = _combine([_sl(e, dim, 0, -1, 2) for e in elems],
                       [_sl(e, dim, 1, None, 2) for e in elems])
    odd = _scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([_sl(e, dim, 0, -1) for e in odd], [_sl(e, dim, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [_sl(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_sl(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def local_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 0):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along
    ``dim``, plus the shard aggregate (A, B) describing the whole shard as
    one segment."""
    dim = dim % a.ndim
    cum_a, cum_b = _scan([a, b], dim)
    return (cum_a, cum_b), (cum_a.select(dim, -1), cum_b.select(dim, -1))


def ssm_scan(a: torch.Tensor, b: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Distributed inclusive scan of the recurrence over ``axis_name``.

    ``a``, ``b``: the stacked ``(*mesh, T/n, ...)`` shards of the per-step
    decay and input sequences; returns the ``(*mesh, T/n, ...)`` shards of
    ``h``. Call inside ``run_spmd``."""
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} != b {tuple(b.shape)}")
    lead = len(current_mesh().shape)
    (cum_a, cum_b), (agg_a, agg_b) = local_scan(a, b, lead)
    # the incoming state of each shard: an exclusive scan of the aggregates,
    # one all_gather and a static combine masked to the ranks before this one
    me = axis_index(axis_name)
    me = me.reshape(*me.shape, *(1,) * (agg_a.ndim - me.ndim))
    all_a = all_gather(agg_a, axis_name)  # (*mesh, n, ...) on every rank
    all_b = all_gather(agg_b, axis_name)
    carry = (torch.ones_like(agg_a), torch.zeros_like(agg_b))
    for i in range(all_a.shape[lead]):
        combined = _combine(carry, (all_a.select(lead, i), all_b.select(lead, i)))
        carry = tuple(torch.where(i < me, new, old) for new, old in zip(combined, carry))
    h_in = carry[1].unsqueeze(lead)
    # continue the local scan from h_in: h_t = cum_b_t + cum_a_t * h_in
    return cum_b + cum_a * h_in
