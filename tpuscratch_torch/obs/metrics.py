"""Host-side metrics registry with mesh-aware cross-rank aggregation.

The host side of the observability loop: counters (monotonic),
gauges (last value, with min/max watermarks), and histograms (bounded
sample window + exact count/total) registered by name, snapshotted into
plain dicts a :class:`~tpuscratch_torch.obs.sink.Sink` can serialize.
Everything on the hot path is a Python attribute update — the cost
budget is "cheap enough to run every engine tick" (< 2% of a compiled
decode step, asserted in the train-bench overhead check).

Cross-rank aggregation keeps the reference's two conventions:

- the **max-min span merge** (mpicuda3.cu:315-325): a phase's wall time
  across ranks is ``max(end) - min(begin)``, absorbed here from
  ``runtime/profiling`` (which now delegates) as :func:`span_max_min`;
- **reduce-to-root of per-rank numbers** (mpicuda3.cu:176-179): here
  :func:`mesh_reduce` runs the reduction through ``comm.collectives``
  on the mesh itself — sum/max/min over every mesh axis in one compiled
  program — and :func:`merge_snapshots` is its host-side pure-function
  twin for snapshots already gathered to one process.

:class:`CompileCounter` counts builds of a step body: the port traces
nothing, so what the JAX package's trace count meant (one compile a
run, rollback replays included) is here one call of the ``wrap``ped
builder a run. The trainer's ``compiles`` field reads it.

The twin of ``tpuscratch.obs.metrics``; :func:`mesh_reduce` runs over
the port's stacked mesh through ``tpuscratch_torch.comm``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import random
import uuid
from typing import Iterable, Sequence

__all__ = [
    "CompileCounter",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MeshSpan",
    "Reservoir",
    "merge_snapshots",
    "mesh_reduce",
    "mesh_span",
    "percentile",
    "span_max_min",
]


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile — the ONE implementation (``bench.timing``
    and ``obs.report`` delegate here; ``Histogram.percentile`` uses it
    over its window)."""
    ys = sorted(xs)
    if not ys:
        raise ValueError("empty sample")
    idx = min(len(ys) - 1, max(0, round(q / 100 * (len(ys) - 1))))
    return ys[idx]


class CompileCounter:
    """Counts builds of a step body: ``wrap`` a builder (the function that
    makes a step from its config), and each call of it adds one. A run
    that builds its step once and reuses it for every chunk, replays
    included, reads 1 -- the JAX package's one compile a run."""

    def __init__(self) -> None:
        self.count = 0

    def wrap(self, fn):
        def counted(*args):
            self.count += 1
            return fn(*args)

        return counted


class Counter:
    """Monotonic event count (inserts, evictions, recompiles, ...)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-set value plus min/max watermarks (queue depth, free pages)."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value: float = math.nan
        self.min = math.inf
        self.max = -math.inf

    def set(self, v: float) -> None:
        self.value = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def snapshot(self) -> dict:
        return {
            "kind": self.kind, "value": self.value,
            "min": self.min, "max": self.max,
        }


class Histogram:
    """Observation distribution: exact count/total/min/max plus a bounded
    window of recent samples for percentiles (a continuously-serving
    engine must not grow one float per tick without bound — the same
    discipline as the engine's span-window trim)."""

    kind = "histogram"

    def __init__(self, window: int = 4096) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.window: collections.deque[float] = collections.deque(
            maxlen=window
        )

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.window.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """Percentile over the RECENT window, not engine lifetime."""
        return percentile(self.window, q)

    def snapshot(self) -> dict:
        out = {
            "kind": self.kind, "count": self.count, "total": self.total,
            "min": self.min, "max": self.max, "mean": self.mean,
        }
        if self.window:
            out["p50"] = self.percentile(50)
            out["p99"] = self.percentile(99)
        return out


class Reservoir:
    """Uniform reservoir sample (Algorithm R) with exact
    count/total/min/max — the bounded-memory tail for STREAM-scale
    populations.

    :class:`Histogram`'s deque window keeps the most RECENT samples, so
    over a 500k-request drain its p99 describes the last 4096 finishes,
    not the drain.  The reservoir instead keeps a uniform sample of the
    WHOLE stream in the same bounded memory: every observation has
    probability ``k/count`` of being in the sample, so the percentile
    estimate covers the full population — and whenever ``count <= k``
    the sample IS the population and the tails are exact (``.exact``),
    which keeps small-drain reports bit-equal to the old per-request
    lists.  Replacement draws come from a seeded generator: the same
    observation stream reports the same percentiles on every run (the
    chaos bit-identity discipline applied to metrics)."""

    kind = "reservoir"

    def __init__(self, k: int = 4096, seed: int = 0) -> None:
        if k < 1:
            raise ValueError(f"reservoir size must be >= 1, got {k}")
        self.k = k
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.sample: list[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.sample) < self.k:
            self.sample.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.k:
                self.sample[j] = v

    @property
    def exact(self) -> bool:
        """True while the sample still holds EVERY observation — the
        percentiles are exact, not estimates."""
        return self.count <= self.k

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """Percentile over the uniform sample (exact when ``.exact``)."""
        return percentile(self.sample, q)

    def snapshot(self) -> dict:
        out = {
            "kind": self.kind, "count": self.count, "total": self.total,
            "min": self.min, "max": self.max, "mean": self.mean,
            "exact": self.exact,
        }
        if self.sample:
            out["p50"] = self.percentile(50)
            out["p99"] = self.percentile(99)
        return out


#: registry id salt — snapshots of the SAME registry are cumulative (a
#: newer one supersedes), snapshots of DIFFERENT registries are disjoint
#: populations (they merge); the id is how a reader tells the two apart
#: (``sink.emit_metrics(..., scope=registry.id)``).  Globally unique,
#: not per-process-counted: appended runs share one JSONL file, so two
#: processes' first registries must not collide on "reg0".
_REG_SALT = uuid.uuid4().hex[:8]
_REG_IDS = itertools.count()


class MetricsRegistry:
    """Named metric store: ``counter``/``gauge``/``histogram`` get-or-create
    by name (a name is permanently one kind — mixing kinds under one name
    raises rather than silently shadowing)."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self.id = f"reg-{_REG_SALT}-{next(_REG_IDS)}"

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def reservoir(self, name: str) -> Reservoir:
        return self._get(name, Reservoir)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict[str, dict]:
        """{name: metric snapshot} — plain JSON-serializable dicts."""
        return {k: m.snapshot() for k, m in sorted(self._metrics.items())}


def span_max_min(begins: Sequence[float], ends: Sequence[float]) -> float:
    """Cross-rank wall time: ``max(ends) - min(begins)`` — the mpicuda3
    gather-to-rank-0 convention as a pure function over per-rank
    timestamp lists (absorbed from ``runtime/profiling``; ``bench.timing``
    and ``profiling.cross_rank_span`` both route here)."""
    if not begins or not ends:
        raise ValueError("empty timestamp lists")
    return max(ends) - min(begins)


def merge_snapshots(snapshots: Iterable[dict]) -> dict[str, dict]:
    """Merge per-rank ``MetricsRegistry.snapshot()`` dicts host-side:
    counters and histogram counts/totals sum; gauge/histogram watermarks
    take min-of-mins / max-of-maxes; a gauge's ``value`` becomes the
    cross-rank max (the conservative "worst rank" reading).  The pure
    twin of :func:`mesh_reduce` for snapshots already on one host."""
    out: dict[str, dict] = {}
    for snap in snapshots:
        for name, m in snap.items():
            if name not in out:
                out[name] = dict(m)
                continue
            o = out[name]
            if o["kind"] != m["kind"]:
                raise ValueError(
                    f"metric {name!r}: kind {o['kind']} vs {m['kind']}"
                )
            if m["kind"] == "counter":
                o["value"] += m["value"]
            elif m["kind"] == "gauge":
                o["value"] = max(o["value"], m["value"])
                o["min"] = min(o["min"], m["min"])
                o["max"] = max(o["max"], m["max"])
            else:  # histogram
                o["count"] += m["count"]
                o["total"] += m["total"]
                o["min"] = min(o["min"], m["min"])
                o["max"] = max(o["max"], m["max"])
                o["mean"] = o["total"] / o["count"] if o["count"] else 0.0
                # window percentiles are per-rank views; a merged exact
                # percentile would need the raw samples — drop them
                o.pop("p50", None)
                o.pop("p99", None)
    return out


def mesh_reduce(mesh, per_rank, ops: Sequence[str] = ("sum",)):
    """Reduce per-rank metric vectors ACROSS the mesh via
    ``comm.collectives`` — the device-side twin of :func:`merge_snapshots`.

    ``per_rank`` is (n_ranks, k) (or (n_ranks,)): row i is mesh position
    i's values (row-major over the mesh axes, the ``make_mesh`` device
    order contract).  One ``run_spmd`` program over the stacked mesh runs
    every requested reduction over ALL mesh axes at once, in f32 as the
    JAX package's does; returns {op: np.ndarray(k)}.  Every rank gets
    the answer the reference gathered to rank 0 with MPI_Reduce
    (mpicuda3.cu:176-179).
    """
    import numpy as np
    import torch

    from tpuscratch_torch.comm import P, run_spmd
    from tpuscratch_torch.comm import collectives as C

    arr = np.asarray(per_rank, np.float64)
    squeeze = arr.ndim == 1
    if squeeze:
        arr = arr[:, None]
    n = mesh.size
    if arr.shape[0] != n:
        raise ValueError(
            f"per_rank has {arr.shape[0]} rows, mesh has {n} positions"
        )
    axes = tuple(mesh.axis_names)
    reducers = {
        "sum": C.allreduce_sum, "max": C.allreduce_max,
        "min": C.allreduce_min,
    }
    for op in ops:
        if op not in reducers:
            raise ValueError(f"unknown reduce op {op!r}; choose {sorted(reducers)}")

    def body(v):  # v: every rank's (1, k) row, stacked
        return tuple(reducers[op](v, axes) for op in ops)

    prog = run_spmd(
        mesh, body,
        (P(axes if len(axes) > 1 else axes[0]),),
        tuple(P() for _ in ops),
    )
    results = prog(torch.from_numpy(arr.astype(np.float32)).to(mesh.device))
    out = {}
    for op, r in zip(ops, results):
        r = r.cpu().numpy()[0]
        out[op] = r[0] if squeeze else r
    return out


@dataclasses.dataclass(frozen=True)
class MeshSpan:
    """Cross-rank merged span: the max-min wall plus the per-rank spread
    (max begin skew / rank seconds) the pure merge throws away."""

    name: str
    seconds: float        # max(end) - min(begin)
    rank_seconds_max: float
    rank_seconds_min: float


def mesh_span(mesh, name: str, begins, ends,
              use_device: bool = True) -> MeshSpan:
    """max-min merge of one named span's per-rank (begin, end) stamps —
    through the mesh collectives when ``use_device`` (min(begin) via
    pmin, max(end) via pmax: the device-side mpicuda3 gather), or the
    pure host merge otherwise."""
    begins = list(begins)
    ends = list(ends)
    if use_device:
        # perf_counter stamps are O(1e4) s where f32 resolution is ~1 ms;
        # shifting to offsets from the earliest begin (pure relabeling —
        # spans are differences) keeps the device reduce at ~us precision
        t0 = min(begins)
        red = mesh_reduce(
            mesh,
            [[b - t0, e - t0, e - b] for b, e in zip(begins, ends)],
            ops=("min", "max"),
        )
        return MeshSpan(
            name,
            seconds=float(red["max"][1] - red["min"][0]),
            rank_seconds_max=float(red["max"][2]),
            rank_seconds_min=float(red["min"][2]),
        )
    durs = [e - b for b, e in zip(begins, ends)]
    return MeshSpan(name, span_max_min(begins, ends), max(durs), min(durs))
