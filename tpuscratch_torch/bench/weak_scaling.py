"""Weak-scaling stencil benchmark (BASELINE config 5).

The twin of ``tpuscratch.bench.weak_scaling``. Fixed per-rank tile,
growing mesh: ideal scaling keeps per-rank cell-updates/s constant, so
efficiency(N) = rate_per_rank(N) / rate_per_rank(1). The reference has no
weak-scaling harness — its scaling story is the qualitative capacity note
at mpicuda2.cu:44-47 — so this keeps the JAX package's methodology: same
program, same per-rank work, mesh as the only variable.

Here the ranks are stacked on one card (the reference's N-ranks-on-one-box
trick, mpicuda2.cu:31-32): the card does N times the work at N ranks, so
the measured per-rank rate falls about as 1/N by construction, and no
halo byte crosses a link. ``comm_ratio`` (analytic halo bytes per computed
cell, from the exchange plan) is the number that transfers to a mesh of
cards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from tpuscratch_torch.bench.stencil_bench import bench_stencil
from tpuscratch_torch.bench.timing import BenchResult
from tpuscratch_torch.runtime.mesh import make_mesh_2d, resolve_device
from tpuscratch_torch.runtime.topology import factor2d

#: the JAX harness's mesh sizes (record.py config 5)
DEVICE_COUNTS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class WeakScalingPoint:
    n_devices: int
    dims: tuple[int, int]
    grid: tuple[int, int]
    result: BenchResult
    halo_bytes_per_chip_step: float  # analytic, from the exchange plan
    cells_per_chip_step: int

    @property
    def per_chip_rate(self) -> float:
        return self.result.items_per_s / self.n_devices

    @property
    def comm_ratio(self) -> float:
        """Exact analytic halo bytes per computed cell per step — the
        quantity weak-scaling efficiency depends on across cards. Unlike
        the measured rates of ranks stacked on one card, this number
        transfers directly to a real mesh."""
        return self.halo_bytes_per_chip_step / self.cells_per_chip_step


def halo_traffic_per_chip(
    dims: tuple[int, int],
    per_chip: tuple[int, int],
    impl: str = "xla",
    itemsize: int = 4,
) -> tuple[float, int]:
    """(off-rank halo bytes per rank per step, cells per rank per step),
    computed EXACTLY from the exchange plan: every transfer whose pair
    leaves the rank counts its send-strip bytes; self-wrap pairs (1-wide
    axes) move nothing between ranks. Deep-halo impls amortize a k-deep
    exchange over k steps."""
    from tpuscratch_torch.halo.exchange import HaloSpec
    from tpuscratch_torch.halo.layout import TileLayout
    from tpuscratch_torch.runtime.topology import CartTopology

    halo, steps_per_exchange = 1, 1
    if impl.startswith("deep"):
        _, _, depth = impl.partition(":")
        halo = int(depth) if depth else 8
        steps_per_exchange = halo
    topo = CartTopology(tuple(dims), (True, True))
    lay = TileLayout(per_chip[0], per_chip[1], halo, halo)
    spec = HaloSpec(layout=lay, topology=topo)
    total = 0
    for t in spec.plan():
        strip = t.send.shape[0] * t.send.shape[1] * itemsize
        total += strip * sum(1 for s, d in t.perm if s != d)
    per_chip_bytes = total / topo.size / steps_per_exchange
    return per_chip_bytes, per_chip[0] * per_chip[1]


def halo3d_traffic_per_chip(
    dims: tuple[int, int, int],
    per_chip: tuple[int, int, int],
    itemsize: int = 4,
    depth: int = 1,
    sweeps_per_exchange: int = 1,
) -> tuple[float, int]:
    """(off-rank halo bytes per rank per sweep, cells per rank per sweep)
    for 3D solver tiles — the 2D :func:`halo_traffic_per_chip` one
    dimension up, computed EXACTLY from the exchange plan.

    ``depth=1`` prices the per-sweep faces exchange (6 slabs,
    ``halo.halo3d.FACES`` plan); ``depth>1`` prices the deep
    AXIS-SEQUENTIAL exchange (``halo.halo3d.halo_exchange3d_seq``: 6
    slabs whose extents grow by the earlier axes' ghost bands — the
    edge/corner data rides transitively), amortized over
    ``sweeps_per_exchange`` sweeps.  The s-step smoothers use
    ``depth=s, sweeps_per_exchange=s`` (Jacobi) or ``depth=2s,
    sweeps_per_exchange=s`` (red-black GS, two half-updates per sweep);
    self-wrap pairs on 1-wide axes move nothing between ranks, exactly
    as in 2D."""
    from tpuscratch_torch.halo.halo3d import (
        HaloSpec3D,
        TileLayout3D,
        seq_exchange_wire_bytes,
    )
    from tpuscratch_torch.runtime.topology import CartTopology

    topo = CartTopology(tuple(dims), (True, True, True))
    lay = TileLayout3D(tuple(per_chip), (depth,) * 3)
    spec = HaloSpec3D(layout=lay, topology=topo,
                      axes=("z", "row", "col"), neighbors=6)
    if depth == 1:
        total = 0
        for t in spec.plan():
            total += t.send.size * itemsize * sum(
                1 for s, d in t.perm if s != d)
        per_chip_bytes = total / topo.size
    else:
        per_chip_bytes = seq_exchange_wire_bytes(spec, itemsize)
    cells = per_chip[0] * per_chip[1] * per_chip[2]
    return per_chip_bytes / sweeps_per_exchange, cells


def bench_weak_scaling(
    per_chip: tuple[int, int] = (1024, 1024),
    steps: int = 10,
    device_counts: Optional[Sequence[int]] = None,
    impl: str = "xla",
    iters: int = 5,
    device=None,
) -> list[WeakScalingPoint]:
    """One point per rank count (default :data:`DEVICE_COUNTS`), the ranks
    stacked on ``device`` (the card unless ``device='cpu'``); the global
    grid grows with the mesh. Each point is ``bench_stencil``'s timing:
    2 warm-up runs, then ``iters`` timed runs, each fenced."""
    dev = resolve_device(device)
    points = []
    for n in sorted(device_counts if device_counts is not None else DEVICE_COUNTS):
        rows, cols = factor2d(n)
        grid = (rows * per_chip[0], cols * per_chip[1])
        mesh = make_mesh_2d((rows, cols), dev)
        halo_bytes, cells = halo_traffic_per_chip((rows, cols), per_chip, impl)
        points.append(
            WeakScalingPoint(
                n_devices=n,
                dims=(rows, cols),
                grid=grid,
                result=bench_stencil(grid, steps, mesh=mesh, impl=impl, iters=iters),
                halo_bytes_per_chip_step=halo_bytes,
                cells_per_chip_step=cells,
            )
        )
    return points


def efficiency(points: Sequence[WeakScalingPoint]) -> dict[int, float]:
    """Per-rank-rate ratio vs the smallest-mesh point."""
    if not points:
        raise ValueError("no points")
    base = min(points, key=lambda p: p.n_devices).per_chip_rate
    return {p.n_devices: p.per_chip_rate / base for p in points}


def report(points: Sequence[WeakScalingPoint]) -> str:
    eff = efficiency(points)
    lines = []
    for p in points:
        lines.append(
            f"{p.n_devices:3d} dev {p.dims[0]}x{p.dims[1]}  grid "
            f"{p.grid[0]}x{p.grid[1]}  {p.per_chip_rate:.3e} cells/s/chip  "
            f"eff {eff[p.n_devices] * 100:5.1f}%  "
            f"halo {p.comm_ratio:.4f} B/cell (analytic)"
        )
    return "\n".join(lines)
