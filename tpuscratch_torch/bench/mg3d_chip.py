"""3D multigrid V-cycle cost by smoother at 256^3 on the card.

The twin of ``tpuscratch.bench.mg3d_chip``: times fixed V-cycles (no
tolerance loop) for each smoother — ``rbgs`` (the default), ``jacobi``,
and ``jacobi-stream`` (the fine levels' sweeps folded into passes of the
streamed 3D kernel with its rhs term) — and reports the marginal ms a
V-cycle by cycle-count differencing: (t(9 cycles) - t(3 cycles)) / 6,
each the median of fenced calls, so the fixed cost of a call cancels.
``profile_cycles`` says where a cycle's time goes (device time by kernel,
the device's idle share).

Usage: python -m tpuscratch_torch.bench.mg3d_chip [N]   (on the card)
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpuscratch_torch.bench.timing import time_device
from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.halo.halo3d import TileLayout3D
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh, topology_of
from tpuscratch_torch.solvers.multigrid3d import level_specs3, v_cycle3

SMOOTHERS = ("rbgs", "jacobi", "jacobi-stream")


def build(n: int, mesh: StackedMesh, levels: int):
    """The per-level spec pairs of an n^3 world on ``mesh``."""
    topo = topology_of(mesh, periodic=True)
    core = tuple(n // d for d in mesh.shape)
    return level_specs3(TileLayout3D(core, (1, 1, 1)), topo, tuple(mesh.axis_names), levels)


def cycles_program(mesh: StackedMesh, specs, smoother: str, cycles: int):
    """fn(b_tiles) running ``cycles`` V(2,2)-cycles from u = 0."""
    spec = P(*mesh.axis_names, None, None, None)

    def body(bt):
        f = bt[..., 0, 0, 0, :, :, :]
        u = torch.zeros_like(f)
        for _ in range(cycles):
            u = v_cycle3(u, f, specs, 0, 2, 32, 6 / 7, smoother)
        return u[..., None, None, None, :, :, :]

    return run_spmd(mesh, body, spec, spec)


def race(n: int = 256, levels: int = 5, smoothers=SMOOTHERS, device=None,
         lo: int = 3, hi: int = 9, iters: int = 3) -> dict:
    """Marginal ms a V-cycle for each smoother at n^3 on a 1x1x1 mesh
    (the card unless ``device='cpu'``)."""
    mesh = make_mesh((1, 1, 1), ("z", "row", "col"), device)
    specs = build(n, mesh, levels)
    rng = np.random.default_rng(21)
    b = rng.standard_normal((n, n, n)).astype(np.float32)
    b -= b.mean()
    bt = torch.from_numpy(b).to(mesh.device)[None, None, None]
    out = {}
    for sm in smoothers:
        t_lo = time_device(cycles_program(mesh, specs, sm, lo), bt, warmup=1, iters=iters,
                           fence="readback")
        t_hi = time_device(cycles_program(mesh, specs, sm, hi), bt, warmup=1, iters=iters,
                           fence="readback")
        out[sm] = (t_hi.p50 - t_lo.p50) * 1e3 / (hi - lo)
    return out


def profile_cycles(n: int = 256, smoother: str = "jacobi-stream", levels: int = 5,
                   cycles: int = 3, device=None) -> dict:
    """Where a V-cycle's time goes at n^3 on a 1x1x1 mesh: ``cycles``
    cycles timed unprofiled, then as many under ``torch.profiler`` (CPU and
    CUDA activity), after a warm-up run. Returns the unprofiled wall a
    cycle, the device's kernel time a cycle (one stream, so kernels do not
    overlap), its idle share against that wall, kernel launches a cycle,
    and kernel time a cycle by group and by name (the ten largest)."""
    from torch.profiler import ProfilerActivity, profile

    from tpuscratch_torch.bench.decode_bench import device_time_split
    from tpuscratch_torch.bench.timing import _fence

    mesh = make_mesh((1, 1, 1), ("z", "row", "col"), device)
    prog = cycles_program(mesh, build(n, mesh, levels), smoother, cycles)
    b = np.random.default_rng(21).standard_normal((n, n, n)).astype(np.float32)
    bt = torch.from_numpy(b - b.mean()).to(mesh.device)[None, None, None]
    _fence(prog(bt))
    t0 = time.perf_counter()
    _fence(prog(bt))
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fence(prog(bt))
    split = device_time_split(prof, cycles)
    cycle_ms = plain / cycles * 1e3
    return {"cycle_ms": cycle_ms, "device_ms": split["device_ms"],
            "idle_share": 1.0 - split["device_ms"] / cycle_ms,
            "launches_per_cycle": split["launches"], "groups_ms": split["groups_ms"],
            "top_ms": split["top_ms"]}


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    for sm, ms in race(n).items():
        print(f"# {sm}: {ms:.2f} ms/V-cycle at {n}^3", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
