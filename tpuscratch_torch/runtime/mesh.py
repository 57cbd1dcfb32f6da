"""The stacked mesh: every rank of a mesh of any rank on one device.

The JAX package shards a ``(rows, cols, ph, pw)`` tile array over a device
mesh and runs one SPMD program per device (``tpuscratch.runtime.mesh`` +
``shard_map``). Here the same array is ONE tensor on one device and every
per-rank operation is a batched tensor operation over its leading
``(rows, cols)`` dims. Ranks are flat and row-major, so mesh position ==
``CartTopology`` rank == flat tile index, exactly as in the JAX package.
On one H100 the headline mesh is 1x1; larger meshes let the halo and
driver code run the JAX package's multi-rank cases without a cluster.
A 1D mesh (``make_mesh_1d``) stacks ``n`` ranks as ``n`` slices of one
tensor, the layout of the comm layer and the dot product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from tpuscratch_torch.runtime.topology import CartTopology


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA card. Raises when no card is present and the caller did
    not ask for the CPU — nothing falls back to the CPU quietly."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} requested but CUDA is not available")
            if device.index is None:  # tensors report the index: cuda -> cuda:N
                device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: tpuscratch_torch runs on the card by default; "
            "pass device='cpu' to run the plain CPU path"
        )
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class StackedMesh:
    """A grid of ranks (any rank count per axis, any number of axes) whose
    per-rank values live stacked on ``device``: a rank's value is the
    slice at its mesh coordinates of the leading ``len(shape)`` dims."""

    shape: tuple[int, ...]
    device: torch.device
    axis_names: tuple[str, ...] = ("row", "col")

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or min(self.shape, default=0) < 1:
            raise ValueError(f"bad mesh shape {self.shape} for axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device=None) -> StackedMesh:
    """A stacked mesh of any rank (the twin of ``make_mesh(shape, names)``)."""
    return StackedMesh(tuple(int(s) for s in shape), resolve_device(device), tuple(axis_names))


def make_mesh_1d(name: str = "x", n: Optional[int] = None, device=None) -> StackedMesh:
    """A 1D stacked mesh of ``n`` ranks (default 1: the single-card run),
    the MPI_COMM_WORLD analogue."""
    return make_mesh((1 if n is None else n,), (name,), device)


def make_mesh_2d(
    shape: Optional[tuple[int, int]] = None,
    device=None,
    axis_names: Sequence[str] = ("row", "col"),
) -> StackedMesh:
    """A 2D stacked mesh; ``shape`` defaults to 1x1, the single-card run."""
    shape = (1, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"bad 2D mesh shape {shape}")
    names = tuple(axis_names)
    if len(names) != 2:
        raise ValueError(f"need 2 axis names, got {names}")
    return StackedMesh(shape, resolve_device(device), names)


def topology_of(mesh: StackedMesh, periodic: bool | Sequence[bool] = True) -> CartTopology:
    """The CartTopology matching a mesh's shape (rank == flat tile index)."""
    dims = tuple(mesh.shape)
    if isinstance(periodic, bool):
        per = tuple(periodic for _ in dims)
    else:
        per = tuple(periodic)
    return CartTopology(dims, per)
