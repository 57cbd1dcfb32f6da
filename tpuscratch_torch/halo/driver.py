"""Whole-grid drivers: decompose, iterate, reassemble.

The twin of ``tpuscratch.halo.driver``: cut the world into per-rank
padded tiles, run ``steps`` exchange+compute iterations on the stacked
``(rows, cols, ph, pw)`` tensor, and reassemble the cores. ``decompose``,
``assemble`` and ``distributed_stencil`` take and return numpy arrays, so
a state saved by the JAX package (``np.asarray`` of its tiles, a
checkpoint's ``.npy``) continues here through ``tiles_from_numpy``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.halo.exchange import HaloSpec
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import (
    JACOBI,
    run_stencil,
    run_stencil_deep,
    run_stencil_resident,
    run_stencil_stream,
)
from tpuscratch_torch.ops.halo_dma import run_stencil_dma, run_stencil_dma_hbm
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_2d, resolve_device, topology_of
from tpuscratch_torch.runtime.topology import CartTopology


def decompose(world: np.ndarray, topo: CartTopology, layout: TileLayout) -> np.ndarray:
    """Cut a (rows*core_h, cols*core_w) world into padded per-rank tiles of
    shape (rows, cols, padded_h, padded_w); ghost borders start at zero
    (they are filled by the first exchange)."""
    rows, cols = topo.dims
    th, tw = layout.core_h, layout.core_w
    if world.shape != (rows * th, cols * tw):
        raise ValueError(
            f"world {world.shape} != grid {(rows * th, cols * tw)}"
        )
    tiles = np.zeros((rows, cols) + layout.padded_shape, dtype=world.dtype)
    hy, hx = layout.halo_y, layout.halo_x
    for r in range(rows):
        for c in range(cols):
            tiles[r, c, hy : hy + th, hx : hx + tw] = world[
                r * th : (r + 1) * th, c * tw : (c + 1) * tw
            ]
    return tiles


def assemble(tiles: np.ndarray, topo: CartTopology, layout: TileLayout) -> np.ndarray:
    """Inverse of decompose: concatenate the cores back into the world."""
    rows, cols = topo.dims
    th, tw = layout.core_h, layout.core_w
    hy, hx = layout.halo_y, layout.halo_x
    world = np.zeros((rows * th, cols * tw), dtype=tiles.dtype)
    for r in range(rows):
        for c in range(cols):
            world[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = tiles[
                r, c, hy : hy + th, hx : hx + tw
            ]
    return world


def tiles_from_numpy(np_tiles: np.ndarray, device=None) -> torch.Tensor:
    """Stacked tiles (rows, cols, ph, pw) from numpy onto ``device`` (the
    card unless the caller asks for the CPU), bit for bit — e.g. the
    state of a JAX run, to continue it here."""
    if np_tiles.ndim != 4:
        raise ValueError(f"want (rows, cols, ph, pw) tiles, got {np_tiles.shape}")
    host = torch.from_numpy(np.array(np_tiles, order="C", copy=True))
    return host.to(resolve_device(device))


def tiles3d_from_numpy(np_tiles: np.ndarray, device=None) -> torch.Tensor:
    """Stacked 3D tiles (mz, my, mx, pz, py, px) from numpy onto ``device``
    (the card unless the caller asks for the CPU), bit for bit."""
    if np_tiles.ndim != 6:
        raise ValueError(f"want (mz, my, mx, pz, py, px) tiles, got {np_tiles.shape}")
    host = torch.from_numpy(np.array(np_tiles, order="C", copy=True))
    return host.to(resolve_device(device))


def cores3d_from_numpy(np_cores: np.ndarray, device=None) -> torch.Tensor:
    """Stacked 3D cores (mz, my, mx, cz, cy, cx), the state the compact and
    stream impls of ``halo.halo3d`` carry, from numpy onto ``device``."""
    return tiles3d_from_numpy(np_cores, device)


#: Impls that run one exchange and one update a step.
PER_STEP = ("xla", "pallas", "blocked", "overlap")


def _depth(impl: str, default: int) -> int:
    """The ``:k`` depth of an impl string (``stream:16``, ``dma-deep:8``)."""
    depth = int(impl.split(":", 1)[1]) if ":" in impl else default
    if depth < 1:
        raise ValueError(f"{impl.split(':')[0]} depth must be >= 1, got {impl!r}")
    return depth


def make_stencil_program(
    mesh: StackedMesh,
    spec: HaloSpec,
    steps: int,
    coeffs=JACOBI,
    impl: str = "xla",
    unroll: int | None = None,
):
    """The program: (rows, cols, ph, pw) tiles on ``mesh.device`` -> same,
    after ``steps`` exchange+compute iterations. ``impl``:

    - ``xla``, ``overlap``, ``pallas``, ``blocked``: one exchange per step;
    - ``deep`` / ``deep-pallas``: the communication-avoiding trapezoid
      (depth = the layout halo width; torch ops / the shared-memory kernel);
    - ``resident``: the single-device one-launch kernel;
    - ``stream[:k]``: the streamed kernel, k substeps a launch (default 8);
    - ``dma``: the DMA-halo ring kernel, all steps in one launch;
      ``dma-deep:k``: its depth-k kernel, k substeps a launch;
      ``dma-hbm``: one launch per step.

    9-point coefficients run on ``xla``, the ``dma`` impls and ``stream``.
    ``unroll`` is accepted for the JAX package's signature."""
    if len(coeffs) == 9 and impl != "xla" and not impl.startswith(("dma", "stream")):
        raise ValueError(
            f"9-point coeffs need impl='xla', a dma impl, or 'stream:k', got {impl!r}"
        )
    if tuple(spec.topology.dims) != tuple(mesh.shape):
        raise ValueError(f"spec topology {spec.topology.dims} != mesh {mesh.shape}")
    if impl == "resident":
        run = lambda t: run_stencil_resident(t, spec, steps, coeffs, unroll=8 if unroll is None else unroll)  # noqa: E731
    elif impl == "dma-hbm":
        run = lambda t: run_stencil_dma_hbm(t, spec, steps, coeffs)  # noqa: E731
    elif impl == "stream" or impl.startswith("stream:"):
        sdepth = _depth(impl, 8)
        run = lambda t: run_stencil_stream(t, spec, steps, coeffs, sdepth)  # noqa: E731
    elif impl == "dma" or impl.startswith("dma-deep:"):
        depth = _depth(impl, 1)
        run = lambda t: run_stencil_dma(t, spec, steps, coeffs, depth)  # noqa: E731
    elif impl in ("deep", "deep-pallas"):
        sub = "pallas" if impl == "deep-pallas" else "xla"
        run = lambda t: run_stencil_deep(t, spec, steps, coeffs, impl=sub)  # noqa: E731
    elif impl in PER_STEP:
        run = lambda t: run_stencil(t, spec, steps, coeffs, impl, unroll or 1)  # noqa: E731
    else:
        raise ValueError(f"unknown stencil impl {impl!r}")

    def program(tiles: torch.Tensor) -> torch.Tensor:
        if tiles.device != mesh.device:
            raise ValueError(f"tiles on {tiles.device}, mesh on {mesh.device}")
        return run(tiles)

    return program


def _setup(world_shape, mesh: Optional[StackedMesh], halo, periodic: bool,
           neighbors: int = 8, device=None):
    """Shared driver prologue: default mesh, topology, divisibility check,
    layout and spec construction."""
    if mesh is None:
        mesh = make_mesh_2d(device=device)
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} != mesh device {mesh.device}")
    topo = topology_of(mesh, periodic=periodic)
    rows, cols = topo.dims
    if world_shape[0] % rows or world_shape[1] % cols:
        raise ValueError(f"world {world_shape} not divisible by mesh {topo.dims}")
    layout = TileLayout(
        world_shape[0] // rows, world_shape[1] // cols, halo[0], halo[1]
    )
    spec = HaloSpec(layout=layout, topology=topo, axes=tuple(mesh.axis_names),
                    neighbors=neighbors)
    return mesh, topo, layout, spec


def distributed_stencil(
    world: np.ndarray,
    steps: int,
    mesh: Optional[StackedMesh] = None,
    halo: tuple[int, int] = (1, 1),
    coeffs=JACOBI,
    impl: str = "xla",
    periodic: bool = True,
    sink=None,
    device=None,
) -> np.ndarray:
    """End-to-end: decompose over the mesh (default: 1x1 on ``device``, the
    card unless ``device='cpu'``), iterate, reassemble. ``sink`` (anything
    with ``emit(kind, **fields)`` and ``flush()``) receives one
    ``halo/run`` event with the fenced wall seconds and cell-updates/s."""
    mesh, topo, layout, spec = _setup(world.shape, mesh, halo, periodic, device=device)
    program = make_stencil_program(mesh, spec, steps, coeffs, impl)
    tiles = tiles_from_numpy(decompose(world, topo, layout), mesh.device)
    t0 = time.perf_counter()
    out = program(tiles)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    wall = time.perf_counter() - t0
    if sink is not None:
        sink.emit(
            "halo/run",
            world_h=world.shape[0], world_w=world.shape[1], steps=steps,
            impl=impl, mesh=f"{topo.dims[0]}x{topo.dims[1]}",
            wall_s=round(wall, 6),
            cell_updates_per_s=round(
                world.shape[0] * world.shape[1] * steps / wall, 3
            ),
        )
        sink.flush()
    return assemble(out.cpu().numpy(), topo, layout)
