"""Stencil throughput benchmark: cell-updates/s (the headline metric).

The twin of ``tpuscratch.bench.stencil_bench``'s ``bench_stencil`` and
``bench_stencil3d``, with the same impl strings. A measured iteration is
one halo exchange + one 5-point (3D: 7- or 27-point) update of every core
cell.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.bench.timing import BenchResult, time_device
from tpuscratch_torch.halo.driver import decompose, make_stencil_program
from tpuscratch_torch.halo.exchange import HaloSpec
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh, make_mesh_2d, topology_of
from tpuscratch_torch.runtime.topology import CartTopology, factor3d


def bench_stencil(
    grid: tuple[int, int] = (1024, 1024),
    steps: int = 10,
    mesh: Optional[StackedMesh] = None,
    impl: str = "xla",
    iters: int = 5,
    dtype=torch.float32,
    device=None,
) -> BenchResult:
    """cell-updates/s for ``steps`` iterations of the full pipeline on a
    ``grid`` world decomposed over ``mesh`` (default: 1x1 on ``device``,
    the card unless ``device='cpu'``).

    ``impl``: ``deep:K`` / ``deep-pallas:K`` = trapezoid scheme with a
    K-deep halo (K steps per exchange); ``resident[:U]`` = one-launch
    resident kernel; ``X+unroll`` = impl X with its unroll set to
    ``steps``; anything else is passed to ``make_stencil_program``.
    """
    mesh = mesh if mesh is not None else make_mesh_2d(device=device)
    topo = topology_of(mesh, periodic=True)
    rows, cols = topo.dims
    if grid[0] % rows or grid[1] % cols:
        raise ValueError(f"grid {grid} not divisible by mesh {topo.dims}")
    halo, unroll, label = 1, None, impl
    if impl.startswith("deep"):
        impl, _, depth = impl.partition(":")
        halo = int(depth) if depth else min(steps, 8)
    elif impl.startswith("resident"):
        impl, _, u = impl.partition(":")
        unroll = int(u) if u else 8
    elif impl.endswith("+unroll"):
        impl, unroll = impl.removesuffix("+unroll"), steps
    layout = TileLayout(grid[0] // rows, grid[1] // cols, halo, halo)
    spec = HaloSpec(layout=layout, topology=topo, axes=tuple(mesh.axis_names))
    program = make_stencil_program(mesh, spec, steps, impl=impl, unroll=unroll)

    rng = np.random.default_rng(0)
    world = rng.standard_normal(grid).astype(np.float32)
    tiles = torch.from_numpy(decompose(world, topo, layout)).to(
        device=mesh.device, dtype=dtype
    )

    return time_device(
        program, tiles,
        iters=iters, warmup=2,
        name=f"stencil {grid[0]}x{grid[1]} x{steps} on {rows}x{cols} ({label})",
        items=grid[0] * grid[1] * steps,
    )


def bench_stencil3d(
    grid: tuple[int, int, int] = (64, 64, 64),
    steps: int = 10,
    mesh: Optional[StackedMesh] = None,
    impl: str = "compact",
    iters: int = 5,
    coeffs=None,
    device=None,
) -> BenchResult:
    """cell-updates/s for the 3D halo + 7-point (27 with 27 ``coeffs``)
    pipeline of ``halo.halo3d`` on a periodic ``grid`` world over a 3-axis
    mesh (default: 1x1x1 on ``device``, the card unless ``device='cpu'``)."""
    from tpuscratch_torch.halo.halo3d import (
        HaloSpec3D,
        TileLayout3D,
        decompose3d,
        decompose3d_cores,
        make_stencil3d_program,
    )

    if mesh is None:
        mesh = make_mesh(factor3d(1), ("z", "row", "col"), device)
    dims = tuple(mesh.shape)
    if any(g % d for g, d in zip(grid, dims)):
        raise ValueError(f"grid {grid} not divisible by mesh {dims}")
    topo = CartTopology(dims, (True,) * 3)
    layout = TileLayout3D(tuple(g // d for g, d in zip(grid, dims)))
    spec = HaloSpec3D(
        layout=layout, topology=topo, axes=tuple(mesh.axis_names),
        neighbors=26 if coeffs is not None and len(coeffs) == 27 else 6,
    )
    if coeffs is None:
        program = make_stencil3d_program(mesh, spec, steps, impl=impl)
    else:
        program = make_stencil3d_program(mesh, spec, steps, tuple(coeffs), impl)
    rng = np.random.default_rng(0)
    world = rng.standard_normal(grid).astype(np.float32)
    if impl.startswith(("compact", "stream")):
        tiles = decompose3d_cores(world, dims)
    else:
        tiles = decompose3d(world, topo, layout)
    tiles = torch.from_numpy(tiles).to(mesh.device)
    cells = grid[0] * grid[1] * grid[2]
    return time_device(
        program, tiles, iters=iters, warmup=2,
        name=f"stencil3d {grid[0]}x{grid[1]}x{grid[2]} x{steps} on "
             f"{dims[0]}x{dims[1]}x{dims[2]} "
             f"({impl}{'' if coeffs is None else f',{len(coeffs)}pt'})",
        items=cells * steps,
    )
