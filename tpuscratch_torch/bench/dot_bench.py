"""Distributed dot-product benchmark (mpicuda3/4 timing parity).

The twin of ``tpuscratch.bench.dot_bench``: shard two vectors over the
stacked mesh, reduce every shard in one batched launch, one
``allreduce_sum``, report elements/s. All ranks are slices on one card,
so the reference's max-min span over per-rank stamps collapses to one
fenced bracket.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuscratch_torch.bench.timing import BenchResult, time_device
from tpuscratch_torch.comm import P, allreduce_sum, run_spmd
from tpuscratch_torch.ops import reduction
from tpuscratch_torch.ops.fill import fill
from tpuscratch_torch.ops.reduction import local_dot_psum
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_1d

#: The plausibility bound on the card: about 1.3x the H100 SXM's published
#: 3.35 TB/s, the rule the JAX package's docstring gives for its
#: ``max_gbps`` (its 1000 GB/s default was set for a v5e TPU and would
#: reject an honest H100 run). Even partial hoisting (one operand stream
#: skipped, an apparent 2x) trips it.
H100_MAX_GBPS = 1.3 * 3350.0

#: The per-round perturbation factor of ``dot_program`` (see there).
PERTURB = 1e-30


def dot_program(
    mesh: StackedMesh,
    axis: str = "x",
    method: str = "full",
    block_rows: int = 512,
    rounds: int = 1,
):
    """The distributed dot over ``mesh``; ``rounds`` > 1 chains that many
    dots in one call, each queued behind the last with no host sync in
    between.

    Each round perturbs the input by ``1e-30 * acc`` (loop-carried, so no
    round can be computed before the one before it has finished) -- far
    below f32 resolution for O(1) data, so the result is unchanged while
    every round honestly re-reads both vectors. The perturbation rides
    the kernels' ``offset``, read through a device pointer: adding it to
    a materialized ``a + eps`` would cost every round an extra read and
    write of the vector.
    """

    def one(a, b, offset=None):
        return local_dot_psum(a, b, axis, method=method, block_rows=block_rows, offset=offset)

    if rounds == 1:
        return run_spmd(mesh, one, (P(axis), P(axis)), P())

    def repeated(a, b):
        # prep (pad/reshape to lane blocks) once, outside the loop
        if method == "xla":
            def step(acc):
                return one(a, b, offset=acc * PERTURB)
        else:
            x2, y2, _, block = reduction.prep(a, b, block_rows)

            def step(acc):
                s = reduction.dot_prepped(x2, y2, block, method, offset=acc * PERTURB)
                return allreduce_sum(s, axis)

        acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
        for _ in range(rounds):
            acc = step(acc)
        return acc

    return run_spmd(mesh, repeated, (P(axis), P(axis)), P())


def bench_dot(
    mesh: Optional[StackedMesh] = None,
    n_elems: int = 100_000_000,
    axis: str = "x",
    method: str = "full",
    iters: int = 5,
    check: bool = True,
    fence: str = "block",
    rounds: int = 1,
    max_gbps: float = H100_MAX_GBPS,
    device=None,
) -> BenchResult:
    """Time ``rounds`` distributed dots of ``n_elems`` f32 (BASELINE
    config 2) over ``mesh`` (default: one rank on ``device``, the card
    unless ``device='cpu'``). ``rounds=1`` measures single-call latency;
    large ``rounds`` the memory-bound rate.

    ``x`` and ``y`` are two distinct buffers of ones made on the device by
    ``fill``. One vector passed twice (as the JAX package does) would let
    the card's L1 serve the second load of each address, so it would read
    4n bytes while ``bytes_moved`` counts 8n. ``max_gbps`` is the
    plausibility bound: a multi-round rate above it means the rounds did
    not each re-read both vectors, and the number is refused."""
    mesh = mesh if mesh is not None else make_mesh_1d(axis, device=device)
    n_elems = (n_elems // mesh.size) * mesh.size  # even shards
    x = fill((n_elems,), 1.0, device=mesh.device)
    y = fill((n_elems,), 1.0, device=mesh.device)
    f = dot_program(mesh, axis, method, rounds=rounds)
    if check:
        got = float(f(x, y))
        if abs(got - n_elems) > 1e-3 * n_elems:
            raise AssertionError(f"dot self-check FAILED: {got} != {n_elems}")
    res = time_device(
        f, x, y,
        iters=iters, warmup=2, fence=fence,
        name=f"dot {n_elems:.0e} f32 ({method}) x{rounds}",
        items=n_elems * rounds,
        bytes_moved=2 * 4 * n_elems * rounds,
    )
    if rounds > 1 and res.gbps > max_gbps:
        raise AssertionError(
            f"implausible {res.gbps:.0f} GB/s (> {max_gbps:.0f}): the chained "
            "dots did not each re-read both vectors; fix dot_program's "
            "perturbation before trusting this benchmark"
        )
    return res
