"""3D halo exchange and 7/27-point stencil on a stacked 3-axis mesh.

The twin of ``tpuscratch.halo.halo3d``, with its names and contracts. Every
rank's tile lives in ONE tensor on one device, stacked over the mesh dims:
``(mz, my, mx, pz, py, px)`` padded tiles for the ``padded`` impl,
``(mz, my, mx, cz, cy, cx)`` cores for the ``compact*`` and ``stream``
impls. A ``ppermute`` of the JAX package is a gather along the flat rank
dim here, and a scanned step loop a Python loop of eager torch operations.

- The plan (``HaloSpec3D.plan``) is the JAX package's pure-Python one: 6
  face transfers, or all 26 regions for 27-point stencils; the executor is
  ``halo.exchange``'s, which serves a plan over any number of mesh dims.
- Open boundaries: ``halo_exchange3d`` leaves an open side's ghosts as
  they were (MPI_PROC_NULL); ``halo_exchange3d_seq``, the compact arrivals
  and the stream gathers put ZEROS there, as a ``ppermute`` does.
- ``impl``: ``compact`` (torch ops on one assembled padded tile),
  ``compact-pallas`` / ``compact-strips`` / ``compact-asm`` (the
  hand-written one-step kernel of ``ops.stencil_kernel``, fed a padded
  tile, a z-padded core with strips, or the bare core with its arrivals),
  ``padded`` (ghost-padded tiles through the general exchange) and
  ``stream[:k]`` (``ops.stencil_stream.seven_point_streamed_pallas``, k
  substeps a pass). On CUDA tensors the kernel impls launch their kernels;
  on CPU tensors they run the kernels' plain torch versions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from tpuscratch_torch import native
from tpuscratch_torch.dtypes import SubarraySpec
from tpuscratch_torch.halo.driver import cores3d_from_numpy, tiles3d_from_numpy
from tpuscratch_torch.halo.exchange import halo_arrivals, halo_scatter
from tpuscratch_torch.halo.stencil import _neighbor_block
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh, resolve_device, topology_of
from tpuscratch_torch.runtime.topology import CartTopology, factor3d

#: The 6 face offsets of a 3D cell, exchange-plan order.
FACES: tuple[tuple[int, int, int], ...] = (
    (-1, 0, 0), (1, 0, 0),
    (0, -1, 0), (0, 1, 0),
    (0, 0, -1), (0, 0, 1),
)

#: All 26 neighbor offsets: faces first (plan-order stability), then the
#: 12 edges, then the 8 corners.
OFFSETS26: tuple[tuple[int, int, int], ...] = FACES + tuple(
    sorted(
        (
            (dz, dy, dx)
            for dz in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dz, dy, dx) != (0, 0, 0)
            and abs(dz) + abs(dy) + abs(dx) >= 2
        ),
        key=lambda d: (abs(d[0]) + abs(d[1]) + abs(d[2]), d),
    )
)


@dataclasses.dataclass(frozen=True)
class TileLayout3D:
    """One rank's 3D tile: core extent + ghost slab widths per axis."""

    core: tuple[int, int, int]
    halo: tuple[int, int, int] = (1, 1, 1)

    def __post_init__(self):
        object.__setattr__(self, "core", tuple(int(c) for c in self.core))
        object.__setattr__(self, "halo", tuple(int(h) for h in self.halo))
        if len(self.core) != 3 or len(self.halo) != 3:
            raise ValueError(f"need 3 extents, got {self.core}/{self.halo}")
        if any(c <= 0 for c in self.core) or any(h < 0 for h in self.halo):
            raise ValueError(f"bad layout {self.core}/{self.halo}")
        if any(h > c for h, c in zip(self.halo, self.core)):
            raise ValueError("halo deeper than core: neighbor slabs overlap")

    @property
    def padded_shape(self) -> tuple[int, int, int]:
        return tuple(c + 2 * h for c, h in zip(self.core, self.halo))

    def send_region(self, offset: Sequence[int]) -> SubarraySpec:
        """Core slab adjacent to face ``offset`` — what travels there."""
        starts, extents = [], []
        for c, h, o in zip(self.core, self.halo, offset):
            if o < 0:
                starts.append(h), extents.append(h)
            elif o > 0:
                starts.append(h + c - h), extents.append(h)
            else:
                starts.append(h), extents.append(c)
        return SubarraySpec(tuple(starts), tuple(extents))

    def halo_region(self, offset: Sequence[int]) -> SubarraySpec:
        """Ghost slab on face ``offset`` — where that neighbor's data lands."""
        starts, extents = [], []
        for c, h, o in zip(self.core, self.halo, offset):
            if o < 0:
                starts.append(0), extents.append(h)
            elif o > 0:
                starts.append(h + c), extents.append(h)
            else:
                starts.append(h), extents.append(c)
        return SubarraySpec(tuple(starts), tuple(extents))


@dataclasses.dataclass(frozen=True)
class Transfer3D:
    """One region's worth of the plan (mirrors ``halo.exchange.Transfer``)."""

    offset: tuple[int, int, int]
    send: SubarraySpec
    recv: SubarraySpec
    perm: tuple[tuple[int, int], ...]
    has_sender: tuple[bool, ...]

    @property
    def is_identity(self) -> bool:
        """Every rank receives from itself (a self-wrapping periodic axis)."""
        return all(s == d for s, d in self.perm) and all(self.has_sender)


@dataclasses.dataclass(frozen=True)
class HaloSpec3D:
    """The constant description of one 3D halo exchange.

    ``neighbors``: 6 (faces only — 7-point stencils) or 26 (faces +
    edges + corners — 27-point stencils)."""

    layout: TileLayout3D
    topology: CartTopology
    axes: tuple[str, str, str] = ("z", "row", "col")
    neighbors: int = 6

    def __post_init__(self):
        if self.topology.ndim != 3:
            raise ValueError("3D halo exchange requires a 3D topology")
        if self.neighbors not in (6, 26):
            raise ValueError("neighbors must be 6 or 26")

    def directions(self) -> tuple[tuple[int, int, int], ...]:
        return OFFSETS26 if self.neighbors == 26 else FACES

    def plan(self) -> tuple[Transfer3D, ...]:
        return _cached_plan3d(self.layout, self.topology, self.neighbors)


@functools.lru_cache(maxsize=None)
def _cached_plan3d(
    layout: TileLayout3D, topology: CartTopology, neighbors: int = 6
) -> tuple[Transfer3D, ...]:
    """The plan from the native planner (``tpuscratch_torch.native``)."""
    out = []
    for nat in native.build_plan3d(topology.dims, topology.periodic, layout.core,
                                   layout.halo, neighbors):
        perm = tuple((int(a), int(b)) for a, b in nat["perm"])
        receivers = {dst for _, dst in perm}
        out.append(Transfer3D(
            offset=tuple(nat["offset"]),
            send=SubarraySpec(tuple(nat["send_rect"][:3]), tuple(nat["send_rect"][3:])),
            recv=SubarraySpec(tuple(nat["recv_rect"][:3]), tuple(nat["recv_rect"][3:])),
            perm=perm,
            has_sender=tuple(r in receivers for r in topology.ranks()),
        ))
    return tuple(out)


def python_plan3d(layout: TileLayout3D, topology: CartTopology,
                  neighbors: int = 6) -> tuple[Transfer3D, ...]:
    """The same plan from the pure-Python topology and layout math (the
    native planner's plain version)."""
    directions = OFFSETS26 if neighbors == 26 else FACES
    out = []
    for d in directions:
        flow = tuple(-x for x in d)  # data in my d halo was sent toward -d
        perm = tuple(topology.send_permutation(flow))
        receivers = {dst for _, dst in perm}
        out.append(
            Transfer3D(
                offset=d,
                send=layout.send_region(flow),
                recv=layout.halo_region(d),
                perm=perm,
                has_sender=tuple(r in receivers for r in topology.ranks()),
            )
        )
    return tuple(out)


def halo_exchange3d(tiles: torch.Tensor, spec: HaloSpec3D) -> torch.Tensor:
    """Fill every rank's ghost regions (6 face slabs, or all 26 regions
    for a ``neighbors=26`` spec) from its mesh neighbors, on the stacked
    ``(mz, my, mx, pz, py, px)`` tensor. Delegates to the 2D library's
    executor pair, whose plan protocol is rank-agnostic; an open side
    keeps its ghost values."""
    return halo_scatter(tiles, spec, halo_arrivals(tiles, spec))


def halo_exchange3d_seq(tiles: torch.Tensor, spec: HaloSpec3D) -> torch.Tensor:
    """Fill the FULL ghost shell — faces, edges AND corners — with six
    transfers at ANY halo depth: the axis-sequential deep exchange. Axis
    ``a``'s slab carries the PADDED extent of every already-exchanged
    axis, so edge and corner data arrives transitively in two or three
    single-axis hops.

    Open-boundary semantics differ from ``halo_exchange3d``: a rank with
    no sender gets ZEROS in that slab, not its prior ghost values."""
    lay = spec.layout
    core, halo = lay.core, lay.halo
    want = tuple(spec.topology.dims) + lay.padded_shape
    if tuple(tiles.shape) != want:
        raise ValueError(f"tiles {tuple(tiles.shape)} != stacked padded {want}")
    out = tiles.clone()
    for a in range(3):
        h = halo[a]
        if h == 0:
            continue
        ext = []
        for b in range(3):
            if b < a:          # already exchanged: ship ghosts too
                ext.append(slice(0, core[b] + 2 * halo[b]))
            elif b > a:        # not yet exchanged: core only
                ext.append(slice(halo[b], halo[b] + core[b]))
            else:
                ext.append(None)
        for d_a in (-1, 1):    # the face whose ghosts this transfer fills
            flow = [0, 0, 0]
            flow[a] = -d_a     # data travels opposite the ghost face
            send_a = (slice(core[a], core[a] + h) if flow[a] > 0
                      else slice(h, 2 * h))
            recv_a = (slice(0, h) if d_a < 0
                      else slice(h + core[a], 2 * h + core[a]))
            src = (Ellipsis,) + tuple(send_a if b == a else ext[b] for b in range(3))
            dst = (Ellipsis,) + tuple(recv_a if b == a else ext[b] for b in range(3))
            # source and landing slabs are disjoint along axis a, so the
            # self-wrap case may land a view of `out` into `out`
            out[dst] = _neighbor_block(out[src], spec, tuple(flow))
    return out


def seq_exchange_wire_bytes(spec: HaloSpec3D, itemsize: int = 4) -> float:
    """Analytic per-rank OFF-RANK bytes of one ``halo_exchange3d_seq`` at
    this spec's halo depth. Self-wrap pairs move nothing between ranks;
    open-edge ranks that send nowhere are averaged out."""
    lay = spec.layout
    topo = spec.topology
    core, halo = lay.core, lay.halo
    total = 0
    for a in range(3):
        h = halo[a]
        if h == 0:
            continue
        elems = h
        for b in range(3):
            if b < a:
                elems *= core[b] + 2 * halo[b]
            elif b > a:
                elems *= core[b]
        for d_a in (-1, 1):
            flow = [0, 0, 0]
            flow[a] = -d_a
            perm = tuple(topo.send_permutation(tuple(flow)))
            if len(perm) == topo.size and all(s == d for s, d in perm):
                continue
            total += elems * itemsize * sum(1 for s, d in perm if s != d)
    return total / topo.size


#: 7-point Jacobi default: equal face weights, no center term.
JACOBI7 = (1 / 6,) * 6 + (0.0,)


def _check_coeffs(coeffs) -> None:
    if len(coeffs) not in (7, 27):
        raise ValueError(
            f"need 6+1 or 26+1 coeffs (FACES/OFFSETS26 + center), "
            f"got {len(coeffs)}"
        )


def _weighted_sum(u: torch.Tensor, core_shape, coeffs, h=(1, 1, 1)) -> torch.Tensor:
    """The stencil over a padded tensor ``u`` whose core starts at ``h``:
    the centre term, then the neighbours in FACES / OFFSETS26 order."""
    hz, hy, hx = h
    cz, cy, cx = core_shape
    sl = lambda dz, dy, dx: u[  # noqa: E731
        ..., hz + dz : hz + dz + cz, hy + dy : hy + dy + cy, hx + dx : hx + dx + cx
    ]
    directions = OFFSETS26 if len(coeffs) == 27 else FACES
    new = coeffs[-1] * sl(0, 0, 0)
    for d, w in zip(directions, coeffs[:-1]):
        new = new + w * sl(*d)
    return new


def stencil_step3d(
    tiles: torch.Tensor, spec: HaloSpec3D, coeffs=JACOBI7
) -> torch.Tensor:
    """One exchange + stencil update of the stacked padded tiles.

    ``coeffs`` order: 7-point = FACES + (center,); 27-point = OFFSETS26 +
    (center,), which requires a ``neighbors=26`` spec (a face-only
    exchange never fills the edge/corner ghosts a 27-point stencil
    reads)."""
    _check_coeffs(coeffs)
    if len(coeffs) == 27 and spec.neighbors != 26:
        raise ValueError(
            "27-point coeffs need a neighbors=26 HaloSpec3D: the face-only "
            "exchange never fills the edge/corner ghosts the stencil reads"
        )
    hz, hy, hx = spec.layout.halo
    if hz < 1 or hy < 1 or hx < 1:
        raise ValueError(
            f"3D stencils need halo >= 1 on every axis, got {spec.layout.halo}"
        )
    u = halo_exchange3d(tiles, spec)
    cz, cy, cx = spec.layout.core
    new = _weighted_sum(u, (cz, cy, cx), coeffs, (hz, hy, hx))
    # a fresh buffer by concatenation, never the core written into `u`
    # while shifted reads of it are live (see halo.stencil.rebuild)
    mid = torch.cat(
        [u[..., hz:hz + cz, hy:hy + cy, :hx], new, u[..., hz:hz + cz, hy:hy + cy, hx + cx:]],
        dim=-1,
    )
    slab = torch.cat(
        [u[..., hz:hz + cz, :hy, :], mid, u[..., hz:hz + cz, hy + cy:, :]], dim=-2
    )
    return torch.cat([u[..., :hz, :, :], slab, u[..., hz + cz:, :, :]], dim=-3)


def run_stencil3d(
    tiles: torch.Tensor, spec: HaloSpec3D, steps: int, coeffs=JACOBI7
) -> torch.Tensor:
    """``steps`` exchange+compute iterations of the padded tiles."""
    for _ in range(steps):
        tiles = stencil_step3d(tiles, spec, coeffs)
    return tiles


def _check_cores(cores: torch.Tensor, spec: HaloSpec3D) -> None:
    want = tuple(spec.topology.dims) + spec.layout.core
    if tuple(cores.shape) != want:
        raise ValueError(f"cores {tuple(cores.shape)} != stacked cores {want}")


def stencil_step3d_compact(
    cores: torch.Tensor, spec: HaloSpec3D, coeffs=JACOBI7, compute: str = "xla"
) -> torch.Tensor:
    """One exchange + stencil update carrying the CORES only. 7-point
    coeffs gather 6 face planes (edge/corner lines are zeros, never read);
    27-point coeffs gather all 26 pieces, ``compute='xla'`` only (the
    kernels are 7-point). Same numbers as the padded path: on open
    boundaries the missing arrivals are zeros, which equal the zero ghosts
    the padded path keeps.

    ``compute``: ``xla`` (torch ops on one assembled padded tile),
    ``pallas`` (the kernel on that padded tile), ``pallas-strips`` (the
    kernel on the z-padded cores and the y/x strips) or ``pallas-asm``
    (the kernel on the bare cores and their arrivals)."""
    _check_coeffs(coeffs)
    if len(coeffs) == 27 and compute != "xla":
        raise ValueError(
            f"27-point compact supports compute='xla' only, got {compute!r} "
            "(the banded Pallas kernels are 7-point)"
        )
    if spec.layout.halo != (1, 1, 1):
        raise ValueError(
            f"compact step supports halo (1,1,1), got {spec.layout.halo}"
        )
    _check_cores(cores, spec)
    topo = spec.topology
    cz, cy, cx = spec.layout.core

    def arrival(d):
        """The sub-block each rank's d-neighbor sends (its far side along
        -d): a face plane, edge line, or corner point by d's rank."""
        flow = tuple(-x for x in d)
        take = (Ellipsis,) + tuple(
            slice(None) if d[a] == 0
            else (slice(-1, None) if flow[a] > 0 else slice(0, 1))
            for a in range(3)
        )
        return _neighbor_block(cores[take], spec, flow)

    if len(coeffs) == 27:
        return _compact27(cores, coeffs, arrival)

    a_mz, a_pz, a_my, a_py, a_mx, a_px = (arrival(d) for d in FACES)

    if compute == "pallas-asm":
        from tpuscratch_torch.ops.stencil_kernel import seven_point_assembled_pallas

        wrap_y = topo.dims[1] == 1 and topo.periodic[1]
        wrap_x = topo.dims[2] == 1 and topo.periodic[2]
        return seven_point_assembled_pallas(
            cores, a_mz, a_pz,
            None if wrap_y else a_my, None if wrap_y else a_py,
            None if wrap_x else a_mx, None if wrap_x else a_px,
            (cz, cy, cx), tuple(coeffs),
        )

    if compute == "pallas-strips":
        from tpuscratch_torch.ops.stencil_kernel import seven_point_strips_pallas

        zpad = torch.cat([a_mz, cores, a_pz], dim=-3)
        return seven_point_strips_pallas(
            zpad, a_my, a_py, a_mx, a_px, (cz, cy, cx), tuple(coeffs)
        )

    if compute not in ("xla", "pallas"):
        raise ValueError(f"unknown compact compute {compute!r}")
    # ONE padded-tile materialization by nested concat (edge/corner lines
    # are zeros — a 7-point stencil never reads them)
    lead = tuple(cores.shape[:-3])
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=cores.dtype, device=cores.device)  # noqa: E731
    mid = torch.cat([a_mx, cores, a_px], dim=-1)             # (cz, cy, cx+2)
    zy = zeros(cz, 1, 1)
    north = torch.cat([zy, a_my, zy], dim=-1)                # (cz, 1, cx+2)
    south = torch.cat([zy, a_py, zy], dim=-1)
    mid = torch.cat([north, mid, south], dim=-2)             # (cz, cy+2, cx+2)
    zz = zeros(1, 1, cx + 2)
    zc = zeros(1, cy, 1)
    top = torch.cat([zz, torch.cat([zc, a_mz, zc], dim=-1), zz], dim=-2)
    bot = torch.cat([zz, torch.cat([zc, a_pz, zc], dim=-1), zz], dim=-2)
    u = torch.cat([top, mid, bot], dim=-3)                   # padded tile

    if compute == "pallas":
        from tpuscratch_torch.ops.stencil_kernel import seven_point_banded_pallas

        return seven_point_banded_pallas(u, (cz, cy, cx), tuple(coeffs))
    return _weighted_sum(u, (cz, cy, cx), coeffs)


def _compact27(cores: torch.Tensor, coeffs, arrival) -> torch.Tensor:
    """27-point core-carry update: ONE padded tile from all 26 arrival
    pieces by nested concatenation, then the 27 shifted reads."""
    A = {d: arrival(d) for d in OFFSETS26}
    A[(0, 0, 0)] = cores

    def rows(dz, dy):
        return torch.cat([A[(dz, dy, -1)], A[(dz, dy, 0)], A[(dz, dy, 1)]], dim=-1)

    def plane(dz):
        return torch.cat([rows(dz, -1), rows(dz, 0), rows(dz, 1)], dim=-2)

    u = torch.cat([plane(-1), plane(0), plane(1)], dim=-3)
    return _weighted_sum(u, tuple(cores.shape[-3:]), coeffs)


def run_stencil3d_compact(
    cores: torch.Tensor,
    spec: HaloSpec3D,
    steps: int,
    coeffs=JACOBI7,
    compute: str = "xla",
) -> torch.Tensor:
    """``steps`` compact iterations (core carry)."""
    for _ in range(steps):
        cores = stencil_step3d_compact(cores, spec, coeffs, compute)
    return cores


def _stream_flags3d(spec: HaloSpec3D, device) -> torch.Tensor | None:
    """Per-rank int32 [z-, z+, y-, y+, x-, x+] open-end flags, stacked
    ``(mz, my, mx, 6)``; None when the topology is fully periodic."""
    topo = spec.topology
    if all(topo.periodic):
        return None
    parts = []
    for axis, n in enumerate(topo.dims):
        shape = [1, 1, 1]
        shape[axis] = n
        idx = torch.arange(n, device=device).reshape(shape).expand(topo.dims)
        if topo.periodic[axis]:
            lo = hi = torch.zeros(topo.dims, dtype=torch.bool, device=device)
        else:
            lo, hi = idx == 0, idx == n - 1
        parts += [lo, hi]
    return torch.stack(parts, dim=-1).to(torch.int32).contiguous()


def run_stencil3d_stream(
    cores: torch.Tensor,
    spec: HaloSpec3D,
    steps: int,
    coeffs=JACOBI7,
    depth: int = 4,
    band: Optional[int] = None,
    nbuf: int = 2,
) -> torch.Tensor:
    """``steps`` iterations via the streamed kernel: ``depth`` substeps
    fold into each pass, one ``depth``-deep gather of ghosts per pass, the
    remainder of ``steps`` as a shallower last pass.

    z ghosts travel as ``(depth, cy, cx)`` slabs. A periodic size-1 y or x
    axis self-wraps in the kernel (z-slab mode); a DISTRIBUTED (or open) y
    or x axis rides ghost strips — the neighbors' edge slabs with the
    diagonal neighbors' corner segments — 7-point only. Open boundaries get
    zero ghosts, re-imposed after every substep through per-rank flags.
    ``band`` and ``nbuf`` are passed on for the JAX package's signature.
    """
    from tpuscratch_torch.ops.stencil_stream import seven_point_streamed_pallas

    if len(coeffs) not in (7, 27):
        raise ValueError(
            f"stream impl takes 7 or 27 coefficients, got {len(coeffs)}"
        )
    _check_cores(cores, spec)
    topo = spec.topology
    cz, cy, cx = spec.layout.core
    wrap_y = topo.dims[1] == 1 and topo.periodic[1]
    wrap_x = topo.dims[2] == 1 and topo.periodic[2]
    if len(coeffs) == 27 and not (wrap_y and wrap_x):
        raise ValueError(
            "the 27-point stream impl needs a z-slab decomposition "
            f"(self-wrapping y and x), got dims={topo.dims} "
            f"periodic={topo.periodic}; use impl='compact-asm' for "
            "distributed y/x axes"
        )
    flags = _stream_flags3d(spec, cores.device)

    def gather(block, off):
        return _neighbor_block(block, spec, off)

    def strip_z(block_top, block_mid, block_bot, off_yx):
        """A ghost strip spanning global planes [-d, cz+d): the
        off_yx-neighbor's mid block plus the z-diagonal neighbors'
        corner segments."""
        dy, dx = off_yx
        return torch.cat([
            gather(block_top, (1, dy, dx)),
            gather(block_mid, (0, dy, dx)),
            gather(block_bot, (-1, dy, dx)),
        ], dim=-3)

    def pass_fn(c, d):
        top, bot = slice(cz - d, None), slice(None, d)
        a_mz = gather(c[..., top, :, :], (1, 0, 0))
        a_pz = gather(c[..., bot, :, :], (-1, 0, 0))
        gy = gx = gc = None
        if not wrap_y:
            # [plus | minus] rows: the +y neighbors' first d rows, then
            # the -y neighbors' last d rows, each z-extended
            lo, hi = slice(None, d), slice(cy - d, None)
            gy = torch.cat([
                strip_z(c[..., top, lo, :], c[..., :, lo, :], c[..., bot, lo, :], (-1, 0)),
                strip_z(c[..., top, hi, :], c[..., :, hi, :], c[..., bot, hi, :], (1, 0)),
            ], dim=-2)
        if not wrap_x:
            lo, hi = slice(None, d), slice(cx - d, None)
            gx = torch.cat([
                strip_z(c[..., top, :, lo], c[..., :, :, lo], c[..., bot, :, lo], (0, -1)),
                strip_z(c[..., top, :, hi], c[..., :, :, hi], c[..., bot, :, hi], (0, 1)),
            ], dim=-1)
        if not wrap_y and not wrap_x:
            # xy-corner strip: quadrants [y-plus | y-minus] x
            # [x-plus | x-minus], each from the matching diagonal
            # neighbor's opposite corner block, z-extended
            def quad(oy, ox):
                ys = slice(0, d) if oy == -1 else slice(cy - d, cy)
                xs = slice(0, d) if ox == -1 else slice(cx - d, cx)
                return strip_z(c[..., top, ys, xs], c[..., :, ys, xs], c[..., bot, ys, xs],
                               (oy, ox))

            gc = torch.cat([
                torch.cat([quad(-1, -1), quad(-1, 1)], dim=-1),
                torch.cat([quad(1, -1), quad(1, 1)], dim=-1),
            ], dim=-2)
        return seven_point_streamed_pallas(
            c, a_mz, a_pz, (cz, cy, cx), tuple(coeffs), d, band, nbuf,
            open_flags=flags, gy=gy, gx=gx, gc=gc,
        )

    q, r = divmod(steps, depth)
    out = cores
    for _ in range(q):
        out = pass_fn(out, depth)
    if r:
        out = pass_fn(out, r)
    return out


def decompose3d(
    world: np.ndarray, topo: CartTopology, layout: TileLayout3D
) -> np.ndarray:
    """(Z, Y, X) world -> (mz, my, mx, pz, py, px) padded tiles (zero ghosts)."""
    mz, my, mx = topo.dims
    cz, cy, cx = layout.core
    if world.shape != (mz * cz, my * cy, mx * cx):
        raise ValueError(f"world {world.shape} != grid {(mz*cz, my*cy, mx*cx)}")
    tiles = np.zeros((mz, my, mx) + layout.padded_shape, dtype=world.dtype)
    hz, hy, hx = layout.halo
    tiles[:, :, :, hz:hz + cz, hy:hy + cy, hx:hx + cx] = decompose3d_cores(world, topo.dims)
    return tiles


IMPLS3D = ("compact", "compact-pallas", "compact-strips", "compact-asm",
           "padded", "stream")  # "stream" takes an optional ":depth"

#: impl name -> compact compute backend
_COMPACT_COMPUTE = {
    "compact": "xla",
    "compact-pallas": "pallas",
    "compact-strips": "pallas-strips",
    "compact-asm": "pallas-asm",
}


def make_stencil3d_program(mesh: StackedMesh, spec: HaloSpec3D, steps: int,
                           coeffs=JACOBI7, impl: str = "compact"):
    """The program: stacked tiles on ``mesh.device`` -> the same after
    ``steps`` iterations. Compact and stream impls take and return CORES
    (``decompose3d_cores``), ``padded`` takes ghost-padded tiles
    (``decompose3d``)."""
    base = impl.split(":", 1)[0]
    if base not in IMPLS3D or (":" in impl and base != "stream"):
        raise ValueError(f"unknown 3D stencil impl {impl!r}; have {IMPLS3D}")
    if impl.startswith("compact") and len(coeffs) == 27 and impl != "compact":
        raise ValueError(
            f"27-point compact supports compute='xla' only, got {impl!r} "
            "(the banded Pallas kernels are 7-point); use impl='compact' "
            "or 'padded'"
        )
    if tuple(spec.topology.dims) != tuple(mesh.shape):
        raise ValueError(f"spec topology {spec.topology.dims} != mesh {mesh.shape}")
    if base == "stream":
        depth = int(impl.split(":", 1)[1]) if ":" in impl else 4
        if depth < 1:
            raise ValueError(f"stream depth must be >= 1, got {impl!r}")
        run = lambda t: run_stencil3d_stream(t, spec, steps, coeffs, depth)  # noqa: E731
    elif impl.startswith("compact"):
        compute = _COMPACT_COMPUTE[impl]
        run = lambda t: run_stencil3d_compact(t, spec, steps, coeffs, compute)  # noqa: E731
    else:
        run = lambda t: run_stencil3d(t, spec, steps, coeffs)  # noqa: E731

    def program(tiles: torch.Tensor) -> torch.Tensor:
        if tiles.device != mesh.device:
            raise ValueError(f"tiles on {tiles.device}, mesh on {mesh.device}")
        return run(tiles)

    return program


def decompose3d_cores(world: np.ndarray, dims: tuple[int, int, int]) -> np.ndarray:
    """(Z, Y, X) world -> (mz, my, mx, cz, cy, cx) CORE tiles (no ghosts)
    — the compact path's decomposition."""
    mz, my, mx = dims
    cz, cy, cx = (s // d for s, d in zip(world.shape, dims))
    return np.ascontiguousarray(
        world.reshape(mz, cz, my, cy, mx, cx).transpose(0, 2, 4, 1, 3, 5)
    )


def assemble3d_cores(tiles: np.ndarray) -> np.ndarray:
    """Inverse of decompose3d_cores."""
    mz, my, mx, cz, cy, cx = tiles.shape
    return tiles.transpose(0, 3, 1, 4, 2, 5).reshape(
        mz * cz, my * cy, mx * cx
    )


def assemble3d(
    tiles: np.ndarray, topo: CartTopology, layout: TileLayout3D
) -> np.ndarray:
    """Inverse of decompose3d: concatenate the cores back into the world."""
    cz, cy, cx = layout.core
    hz, hy, hx = layout.halo
    if tuple(tiles.shape) != tuple(topo.dims) + layout.padded_shape:
        raise ValueError(f"tiles {tiles.shape} != {tuple(topo.dims) + layout.padded_shape}")
    return assemble3d_cores(tiles[:, :, :, hz:hz + cz, hy:hy + cy, hx:hx + cx])


def distributed_stencil3d(
    world: np.ndarray,
    steps: int,
    mesh: Optional[StackedMesh] = None,
    halo: tuple[int, int, int] = (1, 1, 1),
    coeffs=JACOBI7,
    periodic: bool | Sequence[bool] = True,
    impl: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """End to end in 3D: decompose over a 3-axis mesh (default: 1x1x1
    on ``device``, the card unless ``device='cpu'``), iterate, reassemble.

    ``impl='compact'`` carries cores and rebuilds one padded tile per step
    by concatenation, halo-1 only; ``impl='padded'`` carries ghost-padded
    tiles through the general exchange executor. Default (None)
    auto-selects: compact when the halo allows it."""
    if impl is None:
        impl = (
            "compact"
            if tuple(halo) == (1, 1, 1) and len(coeffs) in (7, 27)
            else "padded"
        )
    if impl.startswith(("compact", "stream")) and tuple(halo) != (1, 1, 1):
        raise ValueError(
            f"impl={impl!r} supports halo (1,1,1) only, got {halo}; "
            "use impl='padded' for deeper ghosts"
        )
    if mesh is None:
        mesh = make_mesh(factor3d(1), ("z", "row", "col"), device)
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} != mesh device {mesh.device}")
    dims = tuple(mesh.shape)
    topo = topology_of(mesh, periodic=periodic)
    if len(dims) != 3 or world.ndim != 3:
        raise ValueError(f"need a 3-axis mesh and a 3D world, got {dims} and {world.shape}")
    if any(w % d for w, d in zip(world.shape, dims)):
        raise ValueError(f"world {world.shape} not divisible by mesh {dims}")
    layout = TileLayout3D(
        tuple(w // d for w, d in zip(world.shape, dims)), halo
    )
    spec = HaloSpec3D(
        layout=layout, topology=topo, axes=tuple(mesh.axis_names),
        neighbors=26 if len(coeffs) == 27 else 6,
    )
    program = make_stencil3d_program(mesh, spec, steps, coeffs, impl)
    if impl.startswith(("compact", "stream")):
        out = program(cores3d_from_numpy(decompose3d_cores(world, dims), mesh.device))
        return assemble3d_cores(out.cpu().numpy())
    out = program(tiles3d_from_numpy(decompose3d(world, topo, layout), mesh.device))
    return assemble3d(out.cpu().numpy(), topo, layout)
