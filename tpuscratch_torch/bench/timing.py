"""Timing conventions for device benchmarks.

The twin of ``tpuscratch.bench.timing``: fenced per-iteration wall times
with warmup (kernel builds, allocator growth) excluded. CUDA launches are
asynchronous, so every timed call ends in a fence; a host clock without
it would measure the enqueue. The reference's cross-rank convention --
every rank stamps begin/end and the span is ``max(ends) - min(begins)``
(mpicuda3.cu:315-325) -- is ``span_max_min``.
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


def span_max_min(begins: Sequence[float], ends: Sequence[float]) -> float:
    """Cross-rank wall time: ``max(ends) - min(begins)`` (a copy of
    ``tpuscratch.obs.metrics``'s)."""
    if not begins or not ends:
        raise ValueError("empty timestamp lists")
    return max(ends) - min(begins)


@dataclasses.dataclass(frozen=True)
class BenchResult:
    name: str
    times_s: tuple[float, ...]
    bytes_moved: int = 0
    items: int = 0

    @property
    def p50(self) -> float:
        return percentile(self.times_s, 50)

    @property
    def best(self) -> float:
        return min(self.times_s)

    @property
    def gbps(self) -> float:
        """GB/s at the median."""
        return self.bytes_moved / self.p50 / 1e9 if self.bytes_moved else 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.p50 if self.items else 0.0

    def summary(self) -> str:
        parts = [f"{self.name}: p50 {self.p50 * 1e3:.3f} ms"]
        if self.bytes_moved:
            parts.append(f"{self.gbps:.2f} GB/s")
        if self.items:
            parts.append(f"{self.items_per_s:.3e} items/s")
        return ", ".join(parts)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)


def _fence(out, mode: str = "block"):
    """Wait until ``out`` is computed. ``"block"`` synchronizes every card
    an output lives on; ``"readback"`` also copies one element of the
    first output tensor to the host, the fence a caller's own readback
    would be."""
    if mode not in ("block", "readback"):
        raise ValueError(f"unknown fence mode {mode!r}")
    leaves = list(_leaves(out))
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    if mode == "readback" and leaves and leaves[0].numel():
        leaves[0].reshape(-1)[:1].cpu()
    return out


def time_device(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    name: str = "bench",
    bytes_moved: int = 0,
    items: int = 0,
    fence: str = "block",
) -> BenchResult:
    """Fence-bracketed per-iteration wall times of ``fn(*args)``; the
    ``warmup`` runs are excluded. ``fence`` picks the barrier (``_fence``)."""
    for _ in range(warmup):
        _fence(fn(*args), fence)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args), fence)
        times.append(time.perf_counter() - t0)
    return BenchResult(name=name, times_s=tuple(times), bytes_moved=bytes_moved, items=items)
