"""Point-to-point patterns: rings, neighbor exchange, pairwise transfers.

The twin of ``tpuscratch.comm.p2p``. Every pattern is a ``ppermute``: a
static table of (src, dst) rank pairs, ranks flat and row-major along
the named axes. On the stacked mesh one hop is one copy of each source
slice into its destination slice of a fresh tensor; a rank that no pair
sends to receives zeros, as ``lax.ppermute`` gives. Call these inside
``fn`` of ``run_spmd``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpuscratch_torch.comm.collectives import _Front, _recording, record_op
from tpuscratch_torch.comm.spmd import AxisName, axis_size, current_mesh


def ring_perm(n: int, disp: int = 1, periodic: bool = True) -> list[tuple[int, int]]:
    """(src, dst) pairs shifting every rank by ``disp`` around a ring of n
    (a copy of the JAX package's). Non-periodic rings drop the wrap
    pair(s): ranks at the open boundary have no partner (MPI_PROC_NULL)."""
    pairs = []
    for i in range(n):
        j = i + disp
        if periodic:
            pairs.append((i, j % n))
        elif 0 <= j < n:
            pairs.append((i, j))
    return pairs


def ppermute(x: torch.Tensor, axis: AxisName, pairs: Sequence[tuple[int, int]]) -> torch.Tensor:
    """The value of rank src lands on rank dst for each pair; zeros elsewhere."""
    f = _Front(x, axis)
    pairs = [(int(s), int(d)) for s, d in pairs]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute pairs must be a partial permutation, got {pairs}")
    if any(not 0 <= r < f.n for r in srcs + dsts):
        raise ValueError(f"ppermute pair out of range for axis size {f.n}: {pairs}")
    if _recording:
        # one collective-permute over the whole mesh: the pairs of every group
        groups = current_mesh().size // f.n
        record_op("collective-permute", x.numel() // current_mesh().size * x.element_size(),
                  len(pairs) * groups)
    out = torch.empty_like(f.y)
    for s, d in pairs:
        out[d].copy_(f.y[s])
    for r in sorted(set(range(f.n)) - set(dsts)):
        out[r].zero_()
    return f.back(out)


def ring_shift(x, axis: AxisName, disp: int = 1, periodic: bool = True):
    """Every rank receives the value of its neighbor ``disp`` behind it;
    ranks with no sender (open boundary) receive zeros."""
    return ppermute(x, axis, ring_perm(axis_size(axis), disp, periodic))


def neighbor_exchange(x, axis: AxisName, periodic: bool = False):
    """(from_left, from_right): each rank's value shared with both sides
    (mpi5 parity); boundaries receive zeros."""
    return ring_shift(x, axis, +1, periodic), ring_shift(x, axis, -1, periodic)


def send_pairs(x, axis: AxisName, pairs: Sequence[tuple[int, int]]):
    """Explicit pairwise transfers: value of src lands on dst, zeros
    elsewhere (mpi3's two-rank exchange is ``pairs=[(0,1),(1,0)]``)."""
    return ppermute(x, axis, list(pairs))


def send_tree(tree, axis: AxisName, pairs: Sequence[tuple[int, int]]):
    """``send_pairs`` over every tensor of a nest of dicts, lists and
    tuples: each leaf rides the same permutation, so a payload can never
    arrive separated from its metadata."""
    pairs = list(pairs)
    if isinstance(tree, dict):
        return {k: send_tree(v, axis, pairs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(send_tree(v, axis, pairs) for v in tree)
    return ppermute(tree, axis, pairs)


def pingpong(x, axis: AxisName, a: int = 0, b: int = 1, rounds: int = 1):
    """Bounce a value between ranks a and b ``rounds`` times (one round =
    a->b->a); the test-benchmark latency probe. The bounced value ends on
    rank a; every other rank holds zeros."""
    y = x
    for _ in range(rounds):
        y = ppermute(y, axis, [(a, b)])
        y = ppermute(y, axis, [(b, a)])
    return y


def token_ring(x, axis: AxisName, hops: int, increment=1):
    """Lock-step token circulation: ``hops`` hops around the ring, +
    ``increment`` at each (mpi4's counter passing over the full ring);
    after ``hops`` hops rank (hops % n) holds the token that started at
    rank 0."""
    perm = ring_perm(axis_size(axis), 1, periodic=True)
    tok = x
    for _ in range(hops):
        tok = ppermute(tok, axis, perm) + increment
    return tok
