"""BASELINE configs 2, 3, 4 and 10 on the card.

``python -m tpuscratch_torch.bench.record [--configs 2,3,4,10]`` prints one
JSON line per metric, with the JAX package's metric names
(``tpuscratch.bench.record``): config 2 the dot product, 3 pingpong, 4 the
2D stencil on a 4x4 mesh at 8192^2, 10 the DMA-halo stencil at 1024^2.
Each line names the device it ran on. Unlike the JAX harness, nothing is
caught: a failing method, impl or re-measure fails the run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from tpuscratch_torch.bench.dot_bench import bench_dot
from tpuscratch_torch.bench.headline import race, two_phase_stencil
from tpuscratch_torch.bench.pingpong import DEFAULT_SIZES, sweep, verify_echo
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_1d, make_mesh_2d

DOT_N = 100_000_000
METHODS = ("full", "partials", "xla")


def _device_name(mesh: StackedMesh) -> str:
    if mesh.device.type == "cuda":
        return torch.cuda.get_device_name(mesh.device)
    return "cpu"


def _emit(out: list, mesh: StackedMesh, **kv) -> dict:
    kv.setdefault("platform", mesh.device.type)
    kv.setdefault("device", _device_name(mesh))
    out.append(kv)
    print(json.dumps(kv), flush=True)
    return kv


def config2_dot(out: list, iters: int = 10, n_elems: int = DOT_N, screen_rounds: int = 200,
                final_s: float = 1.0, device=None) -> dict:
    """Latency of one call, then the race of ``full`` / ``partials`` /
    ``xla`` at ``screen_rounds`` chained dots, then the winner re-measured
    with enough rounds that one timed call lasts about ``final_s``.
    Returns ``{"latency", "screen", "final", "winner"}``."""
    mesh = make_mesh_1d("x", device=device)
    lat = bench_dot(mesh, n_elems=n_elems, iters=iters, check=True, fence="readback")
    _emit(out, mesh, config=2, metric="dot_1e8_f32_call_latency_s", value=lat.p50,
          detail=lat.name, n_devices=mesh.size)
    it = max(2, iters // 3)
    screen = {}
    for m in METHODS:
        screen[m] = bench_dot(mesh, n_elems=n_elems, iters=it, check=True, fence="readback",
                              method=m, rounds=screen_rounds)
        print(f"# {screen[m].summary()}", file=sys.stderr)
    winner = max(screen, key=lambda m: screen[m].items_per_s)
    per_round = screen[winner].p50 / screen_rounds
    rounds = max(screen_rounds, math.ceil(final_s / per_round))
    final = bench_dot(mesh, n_elems=n_elems, iters=it, check=True, fence="readback",
                      method=winner, rounds=rounds)
    print(f"# final: {final.summary()}", file=sys.stderr)
    _emit(out, mesh, config=2, metric="dot_1e8_f32_elements_per_s", value=final.items_per_s,
          p50_s=final.p50, gbps=final.gbps, detail=final.name, n_devices=mesh.size)
    return {"latency": lat, "screen": screen, "final": final, "winner": winner}


def config3_pingpong(out: list, iters: int = 10, sizes=DEFAULT_SIZES, device=None) -> dict:
    """The echo check, then the sweep over ``sizes`` on a 2-rank mesh. Both
    ranks are stacked on one device: a hop is a copy on that device and
    crosses no link, and the line says so."""
    mesh = make_mesh_1d("x", 2, device=device)
    if not verify_echo(mesh, "x", 1024):
        raise AssertionError("pingpong echo self-check FAILED")
    results = sweep(mesh, sizes_bytes=sizes, iters=iters, fence="readback")
    peak = max(results, key=lambda r: r.gbps)
    where = "one card: on-card copies" if mesh.device.type == "cuda" else "the CPU: host copies"
    return _emit(
        out, mesh, config=3, metric="pingpong_peak_GBps", value=peak.gbps,
        p50_latency_s_smallest=results[0].p50,
        detail=f"peak at {peak.name}; echo PASSED; stacked on {where}, no link",
        stacked=True,
        sweep=[{"bytes": r.bytes_moved // 2, "p50_s": r.p50, "gbps": r.gbps} for r in results],
    )


#: Config 4's race (record.py:306-308 of the JAX package, its chip set).
CONFIG4_IMPLS = ("xla", "overlap", "deep:4", "dma", "dma-hbm", "stream:16", "stream:32")
#: Config 10's race.
CONFIG10_IMPLS = ("overlap", "dma", "dma-deep:8", "resident:8")


def _where(mesh: StackedMesh) -> str:
    return "one card: on-card reads" if mesh.device.type == "cuda" else "the CPU"


def config4_stencil_mesh(out: list, iters: int = 3, grid=(8192, 8192), impls=CONFIG4_IMPLS,
                         screen_s: float = 0.1, final_s: float = 1.0, device=None) -> dict:
    """The 2D stencil on a 4x4 mesh: every impl of the race sized to runs
    of at least ``screen_s``, the winner re-measured for ``final_s``
    (``bench.headline``'s sized race). All 16 ranks are stacked on one
    device (a 2048^2 tile each at 8192^2), so a halo crosses no link and
    the value is the whole card's rate: ``n_devices`` is 1 and nothing is
    divided by 16. Returns ``{"final", "winner", "screen"}``."""
    mesh = make_mesh_2d((4, 4), device=device)
    final, winner, screen = two_phase_stencil(impls, grid, mesh, iters, screen_s, final_s)
    _emit(out, mesh, config=4,
          metric=f"stencil2d_{grid[0]}x{grid[1]}_4x4_cell_updates_per_s_per_chip",
          value=final.items_per_s, p50_s=final.p50,
          detail=f"{final.name}; 4x4 ranks stacked on {_where(mesh)}, no link",
          n_devices=1, stacked=True,
          screen={i: r.items_per_s for i, r in screen.items()})
    return {"final": final, "winner": winner, "screen": screen}


def config10_dma_halo(out: list, iters: int = 3, grid=(1024, 1024), impls=CONFIG10_IMPLS,
                      min_s: float = 0.1, device=None) -> dict:
    """The DMA-halo stencil on a 1x1 mesh against its rivals, each impl's
    steps sized to runs of at least ``min_s``; the value is the fastest
    ``dma*`` impl's cell-updates/s. Returns every impl's result."""
    mesh = make_mesh_2d((1, 1), device=device)
    rows = race(impls, grid, mesh, iters, min_s)
    best = max((r for i, r in rows.items() if i.startswith("dma")),
               key=lambda r: r.items_per_s, default=None)
    if best is None:
        raise ValueError(f"config 10 races no dma impl: {impls}")
    cells = grid[0] * grid[1]
    _emit(out, mesh, config=10, metric=f"dma_halo_{grid[0]}x{grid[1]}_cell_updates_per_s",
          value=best.items_per_s, p50_s=best.p50,
          us_per_step={i: r.p50 / (r.items // cells) * 1e6 for i, r in rows.items()},
          detail=best.name, n_devices=1)
    return rows


CONFIGS = {2: config2_dot, 3: config3_pingpong, 4: config4_stencil_mesh, 10: config10_dma_halo}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="2,3,4,10", help="comma-separated config numbers")
    args = ap.parse_args(argv)
    out: list = []
    for c in (int(s) for s in args.configs.split(",")):
        if c not in CONFIGS:
            raise SystemExit(f"config {c} is not ported (have {sorted(CONFIGS)})")
        CONFIGS[c](out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
