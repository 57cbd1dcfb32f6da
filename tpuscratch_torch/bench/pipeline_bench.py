"""Pipeline-parallel schedule benchmark: measured against analytic bubble.

The twin of ``tpuscratch.bench.pipeline_bench``. GPipe's idle fraction is
(n-1)/(M+n-1) by construction (``parallel.pipeline``). This bench checks
that the executed schedule has that shape: the wall time of a pipelined run
must grow as its ticks, M + n - 1, not as M * n. The cost of a tick is the
slope between M and 2M microbatches, and

    measured_bubble(M) = 1 - M * tick_cost / wall(M)

is the share of the wall beyond M useful ticks.

On the stacked mesh the n stages share one card and every tick computes
them all in one batched op, so a tick costs about the same whatever n is:
the result is flagged ``proxy``, as the JAX package flags its CPU-mesh
runs. ``python -m tpuscratch_torch.bench.pipeline_bench`` runs M = 4, 8 and
32 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.bench.timing import time_device
from tpuscratch_torch.parallel.pipeline import bubble_fraction
from tpuscratch_torch.parallel.plan import ShardingPlan
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh


@dataclasses.dataclass(frozen=True)
class PipelineBubbleResult:
    n_stages: int
    n_micro: int
    wall_s: float          # p50 wall for n_micro microbatches
    tick_s: float          # marginal cost of one extra microbatch (tick)
    measured_bubble: float
    analytic_bubble: float
    proxy: bool            # True when the stages share one device (stacked mesh)

    def summary(self) -> str:
        return (f"pipeline {self.n_stages} stages x {self.n_micro} micro: "
                f"wall {self.wall_s * 1e3:.2f} ms, tick {self.tick_s * 1e6:.0f} us, "
                f"bubble measured {self.measured_bubble:.3f} vs "
                f"analytic {self.analytic_bubble:.3f}"
                + (" [stacked-mesh proxy]" if self.proxy else ""))


def bench_pipeline_bubble(n_micro: int = 8, feature: int = 256, iters: int = 10,
                          axis: str = "stage", mesh: Optional[StackedMesh] = None,
                          n_stages: int = 4, fence: str = "block",
                          device=None) -> PipelineBubbleResult:
    """Measure the GPipe schedule's bubble: the same stage chain (tanh(x @
    W_s) on ``feature`` columns) at ``n_micro`` and ``2 * n_micro``
    microbatches, built through a ``ShardingPlan``'s ``pipeline_program`` so
    that it runs the trainer's schedule (``gpipe_scan``). The mesh defaults
    to ``(1, 1, n_stages)`` ("dp", "sp", ``axis``) on ``device`` (the card
    unless the caller asks for the CPU)."""
    if mesh is None:
        mesh = make_mesh((1, 1, n_stages), ("dp", "sp", axis), device)
    elif "dp" not in mesh.axis_names or "sp" not in mesh.axis_names:
        # a 1-axis stage mesh: trivial dp/sp axes, so the plan's roles resolve
        mesh = make_mesh((1, 1, mesh.size), ("dp", "sp", axis), mesh.device)
    n = mesh.shape[mesh.axis_names.index(axis)]
    plan = ShardingPlan(mesh, pp=axis, n_micro=n_micro)
    rng = np.random.default_rng(0)
    Ws = torch.from_numpy(rng.standard_normal((n, feature, feature)).astype(np.float32)
                          * 0.1).to(mesh.device)
    def stage(W, x):  # stacked: x (*mesh, F), this rank's W (*mesh, 1, F, F)
        return torch.tanh((x[..., None, :] @ W[..., 0, :, :])[..., 0, :])

    f = plan.pipeline_program(stage)
    walls = {}
    for M in (n_micro, 2 * n_micro):
        micro = torch.from_numpy(rng.standard_normal((M, feature)).astype(np.float32)).to(
            mesh.device)
        r = time_device(f, Ws, micro, iters=iters, warmup=2, fence=fence,
                        name=f"pipeline n={n} M={M}")
        walls[M] = r.p50
    tick = max((walls[2 * n_micro] - walls[n_micro]) / n_micro, 1e-12)
    return PipelineBubbleResult(
        n_stages=n, n_micro=n_micro, wall_s=walls[n_micro], tick_s=tick,
        measured_bubble=1.0 - (n_micro * tick) / walls[n_micro],
        analytic_bubble=bubble_fraction(n, n_micro), proxy=True)


def main() -> int:
    for M in (4, 8, 32):
        print(bench_pipeline_bubble(n_micro=M).summary())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
