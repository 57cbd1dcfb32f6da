"""Timing conventions for device benchmarks.

The twin of ``tpuscratch.bench.timing``: fenced per-iteration wall times
with warmup (kernel builds, allocator growth) excluded. CUDA launches are
asynchronous, so every timed call ends in ``torch.cuda.synchronize()``;
a host clock without it would measure the enqueue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (a copy of ``tpuscratch.obs.metrics``'s)."""
    ys = sorted(xs)
    if not ys:
        raise ValueError("empty sample")
    idx = min(len(ys) - 1, max(0, round(q / 100 * (len(ys) - 1))))
    return ys[idx]


@dataclasses.dataclass(frozen=True)
class BenchResult:
    name: str
    times_s: tuple[float, ...]
    items: int = 0

    @property
    def p50(self) -> float:
        return percentile(self.times_s, 50)

    @property
    def items_per_s(self) -> float:
        return self.items / self.p50 if self.items else 0.0

    def summary(self) -> str:
        parts = [f"{self.name}: p50 {self.p50 * 1e3:.3f} ms"]
        if self.items:
            parts.append(f"{self.items_per_s:.3e} items/s")
        return ", ".join(parts)


def _fence(out) -> None:
    """Wait until ``out`` is computed when it lives on a card."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def time_device(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    name: str = "bench",
    items: int = 0,
) -> BenchResult:
    """Fence-bracketed per-iteration wall times of ``fn(*args)``; the
    ``warmup`` runs are excluded."""
    for _ in range(warmup):
        _fence(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args))
        times.append(time.perf_counter() - t0)
    return BenchResult(name=name, times_s=tuple(times), items=items)
