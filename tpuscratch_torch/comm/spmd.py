"""The SPMD program runner over the stacked mesh.

The twin of ``tpuscratch.comm.spmd``. There, ``run_spmd`` is
``jit(shard_map(fn))``: one program per device, each seeing its shard.
Here every rank lives on one device, so a rank's value is one slice of a
stacked tensor whose leading dims are the mesh's: ``fn`` runs ONCE on
``(*mesh.shape, *local_shape)`` tensors, and the collectives of
``comm.collectives`` / ``comm.p2p`` are batched tensor ops over the
leading dims of the axes they name. While ``fn`` runs, the mesh is the
current one, which is how a collective maps an axis name to a dim. A
per-rank op inside ``fn`` is elementwise or counts its dims from the end
(``dim=-1``): the leading dims are the mesh's.

Specs follow ``shard_map``'s: ``P("x")`` splits an input's dim 0 over
axis ``x`` (a tuple of names splits it row-major over several axes, None
leaves a dim whole), and an input is replicated over every axis its spec
does not name. An output dim named by a spec is concatenated over those
axes; over an axis the spec does not name, the output is rank 0's value
(``check_vma=False``: the value is taken to be the same on every rank).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device

AxisName = Union[str, Sequence[str]]


class PartitionSpec(tuple):
    """One entry per array dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

_current: list[StackedMesh] = []


@contextlib.contextmanager
def mesh_context(mesh: StackedMesh):
    """Make ``mesh`` the current one (what ``shard_map``'s axis env is)."""
    _current.append(mesh)
    try:
        yield mesh
    finally:
        _current.pop()


def current_mesh() -> StackedMesh:
    if not _current:
        raise RuntimeError("collectives run inside run_spmd (no current mesh)")
    return _current[-1]


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_dims(axis: AxisName, mesh: Optional[StackedMesh] = None) -> tuple[int, ...]:
    """The leading dims of the named axes, in the order named (row-major)."""
    mesh = mesh if mesh is not None else current_mesh()
    dims = []
    for name in _names(axis):
        if name not in mesh.axis_names:
            raise ValueError(f"unknown axis {name!r} (mesh axes {mesh.axis_names})")
        dims.append(mesh.axis_names.index(name))
    if len(set(dims)) != len(dims):
        raise ValueError(f"axis named twice in {axis!r}")
    return tuple(dims)


def axis_size(axis: AxisName, mesh: Optional[StackedMesh] = None) -> int:
    mesh = mesh if mesh is not None else current_mesh()
    return math.prod(mesh.shape[d] for d in axis_dims(axis, mesh))


def _split(x: torch.Tensor, spec, mesh: StackedMesh) -> torch.Tensor:
    """Global array -> stacked ``(*mesh.shape, *local)`` tensor."""
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than the array's {x.ndim} dims")
    k = len(mesh.shape)
    shape, order, seen = [], [None] * k, set()
    for i, entry in enumerate(spec):
        dims = axis_dims(entry, mesh) if entry is not None else ()
        n = math.prod(mesh.shape[d] for d in dims)
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of size {x.shape[i]} does not split over {n} ranks")
        if seen & set(dims):
            raise ValueError(f"axis used twice in spec {spec}")
        seen |= set(dims)
        for d in dims:
            order[d] = len(shape)
            shape.append(mesh.shape[d])
        shape.append(x.shape[i] // n)
    y = x.reshape(shape)
    local = [j for j in range(len(shape)) if j not in order]
    present = [d for d in range(k) if order[d] is not None]
    y = y.permute([order[d] for d in present] + local)
    for d in range(k):  # replicated over the axes the spec does not name
        if order[d] is None:
            y = y.unsqueeze(d)
    return y.expand(*mesh.shape, *y.shape[k:])


def _join(y: torch.Tensor, spec, mesh: StackedMesh) -> torch.Tensor:
    """Stacked ``(*mesh.shape, *local)`` tensor -> global array."""
    k = len(mesh.shape)
    if y.shape[:k] != mesh.shape:
        raise ValueError(f"output {tuple(y.shape)} lacks the mesh dims {mesh.shape}")
    nloc = y.ndim - k
    spec = tuple(spec) + (None,) * (nloc - len(spec))
    if len(spec) > nloc:
        raise ValueError(f"out spec {spec} has more entries than the output's {nloc} dims")
    used = [d for entry in spec for d in (axis_dims(entry, mesh) if entry is not None else ())]
    for d in sorted(set(range(k)) - set(used), reverse=True):
        y = y.select(d, 0)  # rank 0's value over an axis the spec does not name
    kept = [d for d in range(k) if d in used]
    pos = {d: j for j, d in enumerate(kept)}
    perm, shape = [], []
    for i, entry in enumerate(spec):
        dims = axis_dims(entry, mesh) if entry is not None else ()
        perm += [pos[d] for d in dims] + [len(kept) + i]
        shape.append(math.prod(mesh.shape[d] for d in dims) * y.shape[len(kept) + i])
    return y.permute(perm).reshape(shape)


def _per_arg(specs, n: int) -> tuple:
    if isinstance(specs, PartitionSpec):
        return (specs,) * n
    specs = tuple(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def run_spmd(mesh: StackedMesh, fn: Callable[..., Any], in_specs, out_specs) -> Callable[..., Any]:
    """The program ``fn`` over ``mesh``: global tensors in (on
    ``mesh.device``), global tensors out. ``fn`` sees stacked tensors."""

    def program(*args):
        for a in args:
            if not isinstance(a, torch.Tensor) or a.device != mesh.device:
                where = a.device if isinstance(a, torch.Tensor) else type(a).__name__
                raise ValueError(f"run_spmd wants tensors on {mesh.device}, got {where}")
        stacked = [_split(a, s, mesh) for a, s in zip(args, _per_arg(in_specs, len(args)))]
        with mesh_context(mesh):
            out = fn(*stacked)
        if isinstance(out, (tuple, list)):
            return type(out)(_join(o, s, mesh) for o, s in zip(out, _per_arg(out_specs, len(out))))
        if not isinstance(out_specs, PartitionSpec):
            raise ValueError("one output needs one PartitionSpec")
        return _join(out, out_specs, mesh)

    return program


def shards_from_numpy(a: np.ndarray, n: int, device=None) -> torch.Tensor:
    """A 1D mesh's stacked operand from numpy: ``(n*shard,)`` -> ``(n, shard)``
    on ``device`` (the card unless the caller asks for the CPU), bit for
    bit -- the inputs a JAX run shards with ``P(axis)``."""
    if a.ndim != 1 or a.shape[0] % n:
        raise ValueError(f"want a vector of n*shard elements for n={n}, got {a.shape}")
    host = torch.from_numpy(np.array(a, order="C", copy=True))
    return host.reshape(n, -1).to(resolve_device(device))
