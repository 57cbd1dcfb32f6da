"""The stacked-tile mesh: every rank of a rows x cols grid on one device.

The JAX package shards a ``(rows, cols, ph, pw)`` tile array over a device
mesh and runs one SPMD program per device (``tpuscratch.runtime.mesh`` +
``shard_map``). Here the same array is ONE tensor on one device and every
per-rank operation is a batched tensor operation over its leading
``(rows, cols)`` dims. Ranks are flat and row-major, so mesh position ==
``CartTopology`` rank == flat tile index, exactly as in the JAX package.
On one H100 the headline mesh is 1x1; larger meshes let the halo and
driver code run the JAX package's multi-rank cases without a cluster.
"""

from __future__ import annotations

import dataclasses
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
    """A rows x cols grid of ranks whose tiles live stacked on ``device``."""

    shape: tuple[int, int]
    device: torch.device
    axis_names: tuple[str, str] = ("row", "col")

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


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
