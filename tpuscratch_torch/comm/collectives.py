"""Named collectives over the stacked mesh -- the MPI collective surface.

The twin of ``tpuscratch.comm.collectives``. Call these inside ``fn`` of
``run_spmd``: ``x`` is a stacked ``(*mesh.shape, *local)`` tensor and
each collective is one batched torch op over the leading dims of the
axes it names (a tuple of names is row-major, as ``_axis_index`` is in
the JAX package). Ranks all live on one device, so a "transfer" is a
copy between slices of one tensor. None of these is a TPU kernel in the
JAX package (they are XLA collectives), so torch ops are their port.

Parity notes (reference -> here) are those of the JAX module:
MPI_Allreduce -> ``allreduce_*``; MPI_Reduce to rank 0 ->
``reduce_to_root`` (non-roots hold zeros); MPI_Gather ->
``gather_to_root``; MPI_Bcast -> ``broadcast``; MPI_Scatter ->
``scatter_from_root``; MPI_Scan/Exscan -> ``prefix_sum``.

Wire bytes: inside ``with count_wire_bytes() as wb:`` every collective adds
its analytic per-rank wire bytes to ``wb``, by the formulas of the JAX
package's ``obs.ledger`` (:108-124): an all-reduce 2(n-1)/n of the payload,
a reduce-scatter and an all-gather (n-1) shards. The three legs are those of
``obs.ledger.GradSyncBytes``; all_to_all and the p2p hops move activations
and are not counted. The JAX package reads these bytes off a compiled
program's collectives; here they are counted per call, so a collective the
compiler would merge or elide still counts. With no counter open a
collective pays one list test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from tpuscratch_torch.comm.spmd import AxisName, axis_dims, current_mesh


@dataclasses.dataclass
class WireBytes:
    """Per-rank wire bytes of the collectives called while counting, by
    leg: ``all_reduce`` (psum-shaped calls: allreduce_*, reduce_to_root,
    broadcast, scatter_from_root), ``reduce_scatter`` and ``all_gather``
    (all_gather, gather_to_root, prefix_sum)."""

    all_reduce: float = 0.0
    reduce_scatter: float = 0.0
    all_gather: float = 0.0
    #: calls by leg (the JAX ledger's ``counts()`` of a compiled program)
    ops: dict = dataclasses.field(default_factory=dict)

    @property
    def grad(self) -> float:
        """The gradient-reduction leg: all-reduce plus reduce-scatter."""
        return self.all_reduce + self.reduce_scatter

    @property
    def total(self) -> float:
        """The whole sync of an update: the gradient leg plus the gathers."""
        return self.grad + self.all_gather

    def per_microbatch(self, accum_steps: int = 1) -> float:
        """Sync bytes amortized over ``accum_steps`` microbatches."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        return self.total / accum_steps


_counting: list[WireBytes] = []


@contextlib.contextmanager
def count_wire_bytes():
    """Tally every collective's wire bytes into a fresh :class:`WireBytes`
    while the block runs (nested counters each see every call)."""
    wb = WireBytes()
    _counting.append(wb)
    try:
        yield wb
    finally:
        _counting.remove(wb)


def _tally(leg: str, x: torch.Tensor, n: int) -> None:
    """Add a collective over ``n`` ranks of the stacked value ``x`` (its
    per-rank payload) to every open counter."""
    if not _counting:
        return
    payload = x.numel() // math.prod(current_mesh().shape) * x.element_size()
    if leg == "all_reduce":
        wire = 2.0 * (n - 1) / n * payload
    elif leg == "reduce_scatter":
        wire = float((n - 1) * (payload // n))
    else:  # all_gather: every shard but one's own
        wire = float((n - 1) * payload)
    for wb in _counting:
        setattr(wb, leg, getattr(wb, leg) + wire)
        wb.ops[leg] = wb.ops.get(leg, 0) + 1


class _Front:
    """A stacked value with the named axes flattened into dim 0, row-major
    in the order named: ``y`` is ``(n, *others, *local)``, where ``others``
    are the remaining mesh dims. ``back`` takes any ``(n, *others,
    *new_local)`` to mesh order again."""

    def __init__(self, x: torch.Tensor, axis: AxisName):
        mesh = current_mesh()
        k = len(mesh.shape)
        if tuple(x.shape[:k]) != mesh.shape:
            raise ValueError(f"stacked value {tuple(x.shape)} lacks the mesh dims {mesh.shape}")
        dims = axis_dims(axis, mesh)
        others = [d for d in range(k) if d not in dims]
        self.sizes = [mesh.shape[d] for d in dims]
        self.lead = 1 + len(others)  # dims before the local ones in y
        y = x.permute(list(dims) + others + list(range(k, x.ndim)))
        self.y = y.reshape(-1, *y.shape[len(dims):])
        self.n = self.y.shape[0]
        self._perm = [0] * k
        for j, d in enumerate(list(dims) + others):
            self._perm[d] = j

    def back(self, z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(*self.sizes, *z.shape[1:])
        return z.permute(self._perm + list(range(len(self._perm), z.ndim))).contiguous()

    def rank(self, ndim: int | None = None) -> torch.Tensor:
        """Each rank's flat index along the axes, shaped to broadcast
        against a front-ordered tensor of ``ndim`` dims (default: y's)."""
        ndim = self.y.ndim if ndim is None else ndim
        return torch.arange(self.n, device=self.y.device).reshape((-1,) + (1,) * (ndim - 1))

    def psum(self, z: torch.Tensor | None = None) -> torch.Tensor:
        z = self.y if z is None else z
        return z.sum(0, keepdim=True, dtype=z.dtype).expand_as(z)

    def gathered(self) -> torch.Tensor:
        """``(n, *others, n, *local)``: every rank holds all n values."""
        g = self.y.unsqueeze(0).expand(self.n, *self.y.shape)  # g[r, j] = rank j's
        return g.movedim(1, self.lead)

    def split(self, z: torch.Tensor, dim: int, what: str) -> torch.Tensor:
        """Local dim ``dim`` of ``z`` cut into n pieces: ``(..., n, piece, ...)``."""
        i = self.lead + dim
        if z.shape[i] % self.n:
            raise ValueError(f"{what}: dim {dim} of size {z.shape[i]} not divisible "
                             f"by axis size {self.n}")
        return z.reshape(*z.shape[:i], self.n, z.shape[i] // self.n, *z.shape[i + 1:])

    def own(self, z: torch.Tensor, i: int) -> torch.Tensor:
        """Each rank's own piece along dim ``i`` of size n (drops that dim)."""
        idx = self.rank(z.ndim).expand(*z.shape[:i], 1, *z.shape[i + 1:])
        return torch.gather(z, i, idx).squeeze(i)


def _local_dim(dim: int, f: _Front) -> int:
    nloc = f.y.ndim - f.lead
    if not -nloc <= dim < nloc:
        raise ValueError(f"local dim {dim} out of range for {nloc} local dims")
    return dim % nloc


def allreduce_sum(x, axis: AxisName):
    f = _Front(x, axis)
    _tally("all_reduce", x, f.n)
    return f.back(f.psum())


def allreduce_max(x, axis: AxisName):
    f = _Front(x, axis)
    _tally("all_reduce", x, f.n)
    return f.back(f.y.amax(0, keepdim=True).expand_as(f.y))


def allreduce_min(x, axis: AxisName):
    f = _Front(x, axis)
    _tally("all_reduce", x, f.n)
    return f.back(f.y.amin(0, keepdim=True).expand_as(f.y))


def reduce_to_root(x, axis: AxisName, root: int = 0):
    """Sum-reduce; root rank holds the result, others hold zeros."""
    f = _Front(x, axis)
    _tally("all_reduce", x, f.n)
    total = f.psum()
    return f.back(torch.where(f.rank() == root, total, torch.zeros_like(total)))


def broadcast(x, axis: AxisName, root: int = 0):
    """Every rank receives root's value: a masked sum, as in the JAX
    package, so that it rounds as that does."""
    f = _Front(x, axis)
    _tally("all_reduce", x, f.n)
    return f.back(f.psum(torch.where(f.rank() == root, f.y, torch.zeros_like(f.y))))


def _gather(f: _Front, tiled: bool) -> torch.Tensor:
    g = f.gathered()
    if tiled:
        if g.ndim == f.lead + 1:
            raise ValueError("tiled all_gather needs a local dim to concatenate along")
        g = g.reshape(*g.shape[: f.lead], -1, *g.shape[f.lead + 2:])
    return g


def all_gather(x, axis: AxisName, tiled: bool = False):
    """Every rank's shard along a new leading local dim (or, ``tiled``,
    concatenated along local dim 0)."""
    f = _Front(x, axis)
    _tally("all_gather", x, f.n)
    return f.back(_gather(f, tiled))


def gather_to_root(x, axis: AxisName, root: int = 0, tiled: bool = False):
    """Root holds the gathered array, others hold zeros (MPI_Gather shape)."""
    f = _Front(x, axis)
    _tally("all_gather", x, f.n)
    g = _gather(f, tiled)
    return f.back(torch.where(f.rank(g.ndim) == root, g, torch.zeros_like(g)))


def scatter_from_root(x, axis: AxisName, root: int = 0):
    """Root's array is split evenly along local dim 0; rank i receives
    piece i. Only root's copy matters (MPI_Scatter's non-root send
    buffers are ignored)."""
    f = _Front(x, axis)
    _tally("all_reduce", x, f.n)
    if f.y.ndim == f.lead or f.y.shape[f.lead] % f.n:
        raise ValueError(
            f"scatter: leading dim {tuple(f.y.shape[f.lead:])[:1]} not divisible "
            f"by axis size {f.n}")
    rooted = f.psum(torch.where(f.rank() == root, f.y, torch.zeros_like(f.y)))
    return f.back(f.own(f.split(rooted, 0, "scatter"), f.lead))


def reduce_scatter(x, axis: AxisName, scatter_dimension: int = 0, tiled: bool = False):
    """Sum over the ranks; rank i keeps piece i of ``scatter_dimension``
    (``tiled``) or index i of it (that dim's size must equal the axis
    size, and it is dropped)."""
    f = _Front(x, axis)
    _tally("reduce_scatter", x, f.n)
    d = _local_dim(scatter_dimension, f)
    if not tiled and f.y.shape[f.lead + d] != f.n:
        raise ValueError(f"reduce_scatter: dim {d} of size {f.y.shape[f.lead + d]} "
                         f"!= axis size {f.n}")
    piece = f.own(f.split(f.psum(), d, "reduce_scatter"), f.lead + d)
    return f.back(piece if tiled else piece.squeeze(f.lead + d))


def all_to_all(x, axis: AxisName, split_axis: int = 0, concat_axis: int = 0, tiled: bool = False):
    """Rank i's piece j of ``split_axis`` goes to rank j, which puts the
    pieces in rank order along ``concat_axis`` (``tiled``) or, untiled,
    drops ``split_axis`` (its size must equal the axis size) and stacks
    them as a new ``concat_axis``."""
    f = _Front(x, axis)
    s = _local_dim(split_axis, f)
    if not tiled and f.y.shape[f.lead + s] != f.n:
        raise ValueError(f"all_to_all: split dim of size {f.y.shape[f.lead + s]} "
                         f"!= axis size {f.n}")
    z = f.split(f.y, s, "all_to_all").transpose(0, f.lead + s)
    # z[r, ..., j, c, ...]: rank r's piece c from rank j, j at local dim s
    loc = z.shape[f.lead:]
    if tiled:
        c = _local_dim(concat_axis, f)
        z = z.movedim(f.lead + s, f.lead + c)
        z = z.reshape(*z.shape[: f.lead + c], -1, *z.shape[f.lead + c + 2:])
    else:
        z = z.squeeze(f.lead + s + 1)
        nout = len(loc) - 1
        if not -nout <= concat_axis < nout:
            raise ValueError(f"concat_axis {concat_axis} out of range")
        z = z.movedim(f.lead + s, f.lead + concat_axis % nout)
    return f.back(z)


def prefix_sum(x, axis: AxisName, exclusive: bool = False):
    """Per-rank running sum along the axis -- MPI_Scan / MPI_Exscan.

    Rank r receives ``sum(x_0..x_r)`` (inclusive) or ``sum(x_0..x_{r-1})``
    (exclusive; rank 0 gets zeros). As in the JAX package: one all_gather
    and a masked sum over the gathered dim."""
    f = _Front(x, axis)
    _tally("all_gather", x, f.n)
    g = f.gathered()  # (n, *others, n, *local)
    j = torch.arange(f.n, device=g.device).reshape(
        (1,) * f.lead + (-1,) + (1,) * (g.ndim - f.lead - 1))
    r = f.rank(g.ndim)
    keep = (j < r) if exclusive else (j <= r)
    return f.back((g * keep.to(g.dtype)).sum(f.lead, dtype=g.dtype))

