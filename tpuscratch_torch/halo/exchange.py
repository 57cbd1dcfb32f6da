"""The halo-exchange plan and executor over a stacked-tile tensor.

Plan-then-execute, as in ``tpuscratch.halo.exchange``:

- The PLAN is built once per (layout, topology, neighbors): for each of
  the 8 directions, the send strip (core edge), the landing strip (halo
  piece on the opposite side at the receiver), the flat-rank permutation
  table and which ranks have a sender (open boundaries). The native C++
  planner builds it (``tpuscratch_torch.native``, as the JAX package's
  plan does when its library is built); ``python_plan`` is the pure-Python
  planner, its plain version, which the tests hold it equal to.
- The EXECUTOR works on the ``(rows, cols, ph, pw)`` tensor holding every
  rank's tile, or on the stacked tensor of any plan with the same protocol
  (``halo.halo3d``'s ``(mz, my, mx, pz, py, px)``): the leading dims are
  the topology's, whatever their number. Each payload is taken from the PRE-exchange tiles, moved
  between ranks by gathering along the flat rank dim with the transfer's
  permutation table, and landed in the receive rectangle of a fresh copy.
  Ranks with no sender (open boundaries) keep their existing ghost values
  (MPI_PROC_NULL semantics); they are never zeroed.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpuscratch_torch import native
from tpuscratch_torch.comm.collectives import _recording, record_op
from tpuscratch_torch.dtypes import SubarraySpec
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.runtime.topology import ALL_DIRECTIONS, CartTopology, Direction

#: 4-neighbor subset for stencils without diagonal terms (5-point).
EDGE_DIRECTIONS = (Direction.TOP, Direction.BOTTOM, Direction.LEFT, Direction.RIGHT)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One direction's worth of the plan (send and recv descriptors)."""

    direction: Direction
    send: SubarraySpec            # core strip leaving toward `direction`
    recv: SubarraySpec            # halo strip where the opposite flow lands
    perm: tuple[tuple[int, int], ...]  # flat-rank (src, dst) table
    has_sender: tuple[bool, ...]  # per-rank: does data arrive? (open bounds)

    @property
    def is_identity(self) -> bool:
        """Every rank receives from itself (a self-wrapping periodic axis)."""
        return all(s == d for s, d in self.perm) and all(self.has_sender)


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """The constant description of one halo exchange."""

    layout: TileLayout
    topology: CartTopology
    axes: tuple[str, str] = ("row", "col")
    neighbors: int = 8  # 8 (corners, 9-point) or 4 (edges only, 5-point)

    def __post_init__(self):
        if self.topology.ndim != 2:
            raise ValueError("halo exchange requires a 2D topology")
        if self.neighbors not in (4, 8):
            raise ValueError("neighbors must be 4 or 8")

    def directions(self) -> tuple[Direction, ...]:
        return ALL_DIRECTIONS if self.neighbors == 8 else EDGE_DIRECTIONS

    def plan(self) -> tuple[Transfer, ...]:
        """The full transfer plan, built once and cached."""
        return _cached_plan(self.layout, self.topology, self.neighbors)


@functools.lru_cache(maxsize=None)
def _cached_plan(
    layout: TileLayout, topology: CartTopology, neighbors: int
) -> tuple[Transfer, ...]:
    """The plan from the native planner (one call for every direction)."""
    out = []
    for nat in native.build_plan(topology.dims, topology.periodic, layout.core_h,
                                 layout.core_w, layout.halo_y, layout.halo_x, neighbors):
        perm = tuple((int(a), int(b)) for a, b in nat["perm"])
        receivers = {dst for _, dst in perm}
        sy, sx, sh, sw = nat["send_rect"]
        ry, rx, rh, rw = nat["recv_rect"]
        out.append(Transfer(
            direction=Direction(tuple(nat["direction"])),
            send=SubarraySpec((sy, sx), (sh, sw)),
            recv=SubarraySpec((ry, rx), (rh, rw)),
            perm=perm,
            has_sender=tuple(r in receivers for r in topology.ranks()),
        ))
    return tuple(out)


def python_plan(layout: TileLayout, topology: CartTopology,
                neighbors: int = 8) -> tuple[Transfer, ...]:
    """The same plan from the pure-Python topology and layout math."""
    directions = ALL_DIRECTIONS if neighbors == 8 else EDGE_DIRECTIONS
    out = []
    for d in directions:
        # data arriving in my `d` halo was SENT toward opposite(d)
        # by my d-neighbor; build the table for that flow.
        flow = d.opposite
        perm = tuple(topology.send_permutation(flow))
        receivers = {dst for _, dst in perm}
        out.append(
            Transfer(
                direction=d,
                send=layout.send_region(flow),
                recv=layout.halo_region(d),
                perm=perm,
                has_sender=tuple(r in receivers for r in topology.ranks()),
            )
        )
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _index(ranks: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(ranks, dtype=torch.long, device=device)


def _sources(t) -> tuple[int, ...]:
    """Entry r: the rank whose payload lands in rank r's halo, or r itself
    (a placeholder that is never landed) where no rank sends."""
    src = list(range(len(t.has_sender)))
    for s, d in t.perm:
        src[d] = s
    return tuple(src)


def _check_tiles(tiles: torch.Tensor, spec) -> int:
    """Raise unless ``tiles`` is the spec's stacked padded tensor; returns
    the number of mesh dims."""
    want = tuple(spec.topology.dims) + tuple(spec.layout.padded_shape)
    if tuple(tiles.shape) != want:
        raise ValueError(
            f"tiles {tuple(tiles.shape)} != stacked padded {want} "
            "(the mesh dims, then the padded tile)"
        )
    return spec.topology.ndim


def halo_arrivals(tiles: torch.Tensor, spec) -> list[torch.Tensor]:
    """Phase 1: every transfer's payload, packed from the PRE-exchange
    tiles and moved to its receivers. Entry ``i`` holds, for each rank, the
    strip that lands in its ``plan()[i].recv`` rectangle, shaped
    ``(ranks, *recv.shape)``. ``spec`` is a ``HaloSpec`` or any spec of the
    same protocol over any number of mesh dims. A self-wrapping transfer's entry is a view of
    ``tiles``; ``halo_scatter`` lands into a copy, so the view stays valid.

    An open ledger (``comm.collectives.record_collectives``) records every
    transfer as one ``collective-permute`` of the plan's pairs, self-wrap
    ones too: the JAX package sends each through a ``ppermute``."""
    nd = _check_tiles(tiles, spec)
    out = []
    for t in spec.plan():
        payload = t.send.region(tiles).flatten(0, nd - 1)
        if _recording:
            record_op("collective-permute", payload[0].numel() * payload.element_size(),
                      len(t.perm))
        if not t.is_identity:
            payload = payload.index_select(0, _index(_sources(t), tiles.device))
        out.append(payload)
    return out


def halo_scatter(
    tiles: torch.Tensor, spec, arrivals: list[torch.Tensor]
) -> torch.Tensor:
    """Phase 2: land the arrivals in the (disjoint) border pieces of a copy
    of ``tiles``. Open boundary = no sender: the existing ghost values stay."""
    nd = _check_tiles(tiles, spec)
    out = tiles.clone()
    flat = out.flatten(0, nd - 1)  # a view of `out`
    for t, arrived in zip(spec.plan(), arrivals):
        land = t.recv.region(flat)
        if all(t.has_sender):
            land.copy_(arrived)
        elif t.perm:
            dst = _index(tuple(d for _, d in t.perm), tiles.device)
            land[dst] = arrived[dst]
    return out


def halo_exchange(tiles: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """Fill every rank's ghost border from its 8 (or 4) mesh neighbors.

    ``tiles`` is the stacked ``(rows, cols, ph, pw)`` tensor. Returns a new
    tensor with refreshed halos; the cores are untouched."""
    return halo_scatter(tiles, spec, halo_arrivals(tiles, spec))
