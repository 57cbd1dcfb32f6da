"""The headline: 2D 5-point stencil, 1024^2, on one card.

``python -m tpuscratch_torch.bench.headline`` prints ONE JSON line of
``bench.py``'s shape, ``{"metric", "value", "unit", "vs_baseline"}``,
for ``stencil2d_1024x1024_cell_updates_per_s``. The logic is that of
``tpuscratch.bench.record.two_phase_stencil`` over ``bench.py``'s impl
ladder: race every impl, then re-measure the winner with a longer run.
Two differences:

- A failing impl fails the race (the JAX harness skips it): an impl that
  cannot run on the card is a fault to see, not a row to drop.
- Step counts are sized per impl from a short probe so that every timed
  run lasts at least ``min_s`` (100 ms in the race, 1 s for the final),
  instead of the fixed step counts the JAX harness needs to hide a remote
  transport's per-call cost.

``vs_baseline`` is null: ``BENCH_BASELINE.json`` pins a TPU run, which
is no baseline for this card.
"""

from __future__ import annotations

import json
import math
import sys

from tpuscratch_torch.bench.stencil_bench import bench_stencil
from tpuscratch_torch.bench.timing import BenchResult
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_2d

GRID = (1024, 1024)
IMPLS = ("xla", "deep:16", "deep-pallas:16", "deep-pallas:32", "resident:8")
METRIC = "stencil2d_1024x1024_cell_updates_per_s"
PROBE_STEPS = 64
QUANTUM = 32  # step counts stay multiples of every ladder depth


def sized_steps(impl: str, grid, mesh: StackedMesh, min_s: float) -> int:
    """Steps for one timed run of at least ``min_s``: probe at
    ``PROBE_STEPS`` and rescale until a probe run lasts ``min_s`` (a short
    probe overstates the per-step time by its fixed cost, so one rescale
    can fall short)."""
    steps = PROBE_STEPS
    for _ in range(4):
        took = bench_stencil(grid, steps, mesh=mesh, impl=impl, iters=1).p50
        if took >= min_s:
            break
        steps = math.ceil(steps * 1.1 * min_s / took / QUANTUM) * QUANTUM
    return steps


def measure(impl: str, grid, mesh: StackedMesh, iters: int, min_s: float) -> BenchResult:
    return bench_stencil(grid, sized_steps(impl, grid, mesh, min_s),
                         mesh=mesh, impl=impl, iters=iters)


def race(impls, grid, mesh: StackedMesh, iters: int, min_s: float = 0.1) -> dict[str, BenchResult]:
    """Every impl's result; any failure propagates."""
    out = {}
    for impl in impls:
        out[impl] = measure(impl, grid, mesh, iters, min_s)
        print(f"# {out[impl].summary()}", file=sys.stderr)
    return out


def two_phase_stencil(impls, grid, mesh: StackedMesh, iters: int,
                      screen_s: float = 0.1, final_s: float = 1.0):
    """(final result, winning impl, every screen result)."""
    screen = race(impls, grid, mesh, iters, screen_s)
    best_impl = max(screen, key=lambda i: screen[i].items_per_s)
    final = measure(best_impl, grid, mesh, iters, final_s)
    print(f"# final: {final.summary()}", file=sys.stderr)
    return final, best_impl, screen


def headline_line(result: BenchResult) -> dict:
    return {
        "metric": METRIC,
        "value": round(result.items_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": None,
    }


def main() -> int:
    final, impl, _ = two_phase_stencil(IMPLS, GRID, make_mesh_2d((1, 1)), iters=3)
    print(f"# winner: {impl}", file=sys.stderr)
    print(json.dumps(headline_line(final)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
