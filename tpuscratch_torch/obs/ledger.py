"""Communication/compute ledger of a program run on the stacked mesh.

The twin of ``tpuscratch.obs.ledger``. The JAX package reads its ledger
off a compiled program: every ``all-reduce`` / ``all-gather`` /
``all-to-all`` / ``reduce-scatter`` / ``collective-permute`` in the
optimized HLO, with XLA's ``cost_analysis()`` for FLOPs and bytes
accessed. The port has no HLO, so ``parse_collectives`` (the HLO text
parser) has no counterpart here. :func:`analyze` RUNS the program once
instead and records every collective it calls
(``comm.collectives.record_collectives``: the named collectives, the p2p
hops and each halo-exchange transfer that the JAX package sends through a
``ppermute``), each with the payload and group size the JAX ledger would
read off that instruction.

The JAX ledger counts a ``lax.while_loop`` body once (``Ledger.count``);
this one counts every call the run makes. So a per-iteration figure here
is the count over one iteration: run the loop once (CG with
``max_iters=1`` gives one init plus one loop body, the JAX program's
static count).

Wire-byte accounting uses the standard analytic forms, copied from the
JAX package:

- ring all-reduce moves ``2*(n-1)/n * payload`` per device
  (reduce-scatter pass + all-gather pass);
- all-gather ``(n-1)/n * result`` (each device receives all shards but
  its own);
- reduce-scatter ``(n-1) * shard`` (each device sends all but its own
  share of its input);
- all-to-all ``(n-1)/n * payload`` (everything except the self-block);
- collective-permute ``payload`` (one hop, whole buffer).

``roofline`` diffs the ledger against a MEASURED span time into an
achieved-fraction report: what share of peak FLOP/s, HBM bandwidth, and
link bandwidth the measured run reached, and which bound binds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "CollectiveOp",
    "GradSyncBytes",
    "KVHostTraffic",
    "Ledger",
    "RooflineReport",
    "all_gather_wire_bytes",
    "all_to_all_wire_bytes",
    "analyze",
    "grad_sync_wire_bytes",
    "kv_cache_bytes",
    "kv_host_traffic_bytes",
    "kv_page_bytes",
    "reduce_scatter_wire_bytes",
    "ring_all_reduce_wire_bytes",
    "roofline",
]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective the program called."""

    kind: str          # all-reduce | all-gather | all-to-all |
    #                    reduce-scatter | collective-permute
    payload_bytes: int  # result payload a rank
    group_size: int    # ranks per group (pairs over the whole mesh for permute)

    @property
    def wire_bytes(self) -> float:
        """Analytic per-device wire traffic for this op (see module
        docstring for the formulas and what each payload refers to)."""
        n, b = self.group_size, self.payload_bytes
        if n <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return ring_all_reduce_wire_bytes(n, b)
        if self.kind == "all-gather":
            # result is the FULL gathered array: n shards of b/n each
            return all_gather_wire_bytes(n, b // n)
        if self.kind == "reduce-scatter":
            # result is one shard
            return reduce_scatter_wire_bytes(n, b)
        if self.kind == "all-to-all":
            return all_to_all_wire_bytes(n, b)
        return float(b)  # collective-permute: one hop, whole buffer


def ring_all_reduce_wire_bytes(n: int, payload: int) -> float:
    """Ring all-reduce per-device traffic: ``2*(n-1)/n * payload``
    (a reduce-scatter pass then an all-gather pass, each moving
    ``(n-1)/n`` of the buffer)."""
    return 2.0 * (n - 1) / n * payload


def all_gather_wire_bytes(n: int, shard_bytes: int) -> float:
    """All-gather per-device traffic: ``(n-1) * shard`` (receive every
    shard but your own)."""
    return float((n - 1) * shard_bytes)


def reduce_scatter_wire_bytes(n: int, shard_bytes: int) -> float:
    """Reduce-scatter per-device traffic: ``(n-1) * shard`` (send all
    but your own share)."""
    return float((n - 1) * shard_bytes)


def all_to_all_wire_bytes(n: int, payload: int) -> float:
    """All-to-all per-device traffic: ``(n-1)/n * payload`` (every block
    except the one staying home)."""
    return (n - 1) / n * payload


@dataclasses.dataclass(frozen=True)
class Ledger:
    """What one run of a program did: its collectives, in call order, its
    FLOPs (``torch.utils.flop_counter`` over the aten ops) and its bytes
    accessed (see :func:`analyze` for both definitions)."""

    collectives: tuple[CollectiveOp, ...]
    flops: float
    bytes_accessed: float

    def counts(self) -> dict[str, int]:
        """{collective kind: op count}."""
        out: dict[str, int] = {}
        for op in self.collectives:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out

    def count(self, kind: str) -> int:
        """Op count of ONE collective kind (0 when absent): the solver
        proofs' working form (pipelined CG's one allreduce an iteration,
        the s-step smoother's exchanges a sweep), over the calls the run
        made."""
        return self.counts().get(kind, 0)

    def payload_bytes(self) -> dict[str, int]:
        """{collective kind: summed result-payload bytes}."""
        out: dict[str, int] = {}
        for op in self.collectives:
            out[op.kind] = out.get(op.kind, 0) + op.payload_bytes
        return out

    def wire_bytes(self) -> dict[str, float]:
        """{collective kind: summed analytic per-device wire bytes}."""
        out: dict[str, float] = {}
        for op in self.collectives:
            out[op.kind] = out.get(op.kind, 0.0) + op.wire_bytes
        return out

    def total_wire_bytes(self) -> float:
        return sum(op.wire_bytes for op in self.collectives)

    def summary(self) -> str:
        lines = [
            f"flops/exec: {self.flops:.3e}   "
            f"bytes accessed: {self.bytes_accessed:.3e}"
        ]
        counts, wire = self.counts(), self.wire_bytes()
        for kind in sorted(counts):
            lines.append(
                f"{kind}: {counts[kind]} op(s), "
                f"payload {self.payload_bytes()[kind]} B, "
                f"wire ~{wire[kind]:.0f} B/device"
            )
        if not counts:
            lines.append("no collectives")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class GradSyncBytes:
    """Per-device wire bytes of one train step's parameter/gradient
    synchronization, split by collective kind (attention/MoE traffic —
    ppermute, all-to-all — is deliberately excluded; those move
    activations, not gradients):

    - ``all_reduce``: every reducing all-reduce — the replicated path's
      full gradient sync, plus the sp-copy psums and scalar loss pmeans
      both paths share (scalar ops contribute ~0);
    - ``reduce_scatter``: the ZeRO path's gradient sync — each rank
      receives only its ``1/|dp|`` shard;
    - ``all_gather``: the ZeRO path's trailing param gather (rebuilding
      replicated params from updated shards).

    ``grad`` (all_reduce + reduce_scatter) is the gradient-reduction
    leg; ``total`` adds the trailing all-gather — the whole sync cost of
    one update, which gradient accumulation (``accum_steps=k``) pays once
    per k microbatches instead of per microbatch."""

    all_reduce: float
    reduce_scatter: float
    all_gather: float

    @property
    def grad(self) -> float:
        return self.all_reduce + self.reduce_scatter

    @property
    def total(self) -> float:
        return self.grad + self.all_gather

    def per_microbatch(self, accum_steps: int = 1) -> float:
        """Sync bytes amortized per microbatch under deferred-sync
        accumulation: the one reduce-scatter + all-gather is paid once
        per ``accum_steps`` microbatches."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        return self.total / accum_steps


def grad_sync_wire_bytes(ledger: "Ledger") -> GradSyncBytes:
    """The gradient-synchronization slice of a train-step ledger: summed
    analytic wire bytes of its all-reduce, reduce-scatter, and
    all-gather ops (see :class:`GradSyncBytes` for what each leg means).
    The same legs as ``comm.count_wire_bytes``' ``WireBytes``."""
    wire = ledger.wire_bytes()
    return GradSyncBytes(
        all_reduce=wire.get("all-reduce", 0.0),
        reduce_scatter=wire.get("reduce-scatter", 0.0),
        all_gather=wire.get("all-gather", 0.0),
    )


def _leaves(cache):
    return cache.values() if hasattr(cache, "values") else cache


def kv_cache_bytes(cache) -> int:
    """Total buffer bytes of a serve KV-cache tree
    (``serve.kvcache.init_kv_cache`` output — page pools plus, for
    quantized pools, the per-page per-head scale planes): decode gathers
    the whole cached prefix a token, so cache bytes are its memory
    roofline, and int8 pages land at ``1/4 + 1/(page_size * d_head)`` of
    the fp32 bytes."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(cache)))


def kv_page_bytes(cache) -> float:
    """Exact bytes ONE logical page drags across the memory tiers: the
    K and V page blocks of every layer plus, on the quantized rungs,
    their per-page per-head scale rows — ``kv_cache_bytes`` divided
    down the pages axis (every cache leaf carries pages on axis 1, so
    the division is exact). Analytic form at geometry (L layers, page
    ``p`` tokens, H heads, d_head D, element size ``e``): ``L *
    (2*p*H*D*e + 2*H*4[quantized])``."""
    total = 0.0
    for t in _leaves(cache):
        total += (t.numel() // t.shape[1]) * t.element_size()
    return total


@dataclasses.dataclass(frozen=True)
class KVHostTraffic:
    """Static host↔device paging traffic of a tiered-KV engine: page-move
    COUNTS are exact engine counters (every payload copy increments
    exactly one), per-page bytes are exact pool geometry, so the byte
    totals are exact — only wall time is ever measured.

    ``spilled_pages`` counts payload D2H copies (reserved-but-unwritten
    pages spill as pure bookkeeping and move zero bytes);
    ``prefetched_pages`` counts payload H2D copies including
    warm-prefix restores."""

    spilled_pages: int
    prefetched_pages: int
    page_bytes: float

    @property
    def spill_bytes(self) -> float:
        return self.spilled_pages * self.page_bytes

    @property
    def prefetch_bytes(self) -> float:
        return self.prefetched_pages * self.page_bytes

    @property
    def total_bytes(self) -> float:
        return self.spill_bytes + self.prefetch_bytes

    def per_token(self, tokens: int) -> float:
        """Host↔device bytes per emitted token."""
        if tokens < 1:
            raise ValueError(f"tokens must be >= 1, got {tokens}")
        return self.total_bytes / tokens


def kv_host_traffic_bytes(cache, spilled_pages: int,
                          prefetched_pages: int) -> KVHostTraffic:
    """The tiered-KV traffic ledger for one pool: exact page-move counts
    priced at the pool's exact per-page bytes."""
    return KVHostTraffic(
        spilled_pages=int(spilled_pages),
        prefetched_pages=int(prefetched_pages),
        page_bytes=kv_page_bytes(cache),
    )


def _tensor_bytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def analyze(fn, *args, **kwargs) -> Ledger:
    """Ledger of ONE run of ``fn(*args, **kwargs)`` (it runs, on the
    arguments' device).

    - ``collectives``: every op recorded while it ran, in call order.
    - ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total over
      the aten ops (matrix products, convolutions, attention). It leaves
      out the hand-written kernels' work: they launch through ``ctypes``
      (``ops.common``), which no dispatch mode sees. The JAX ledger leaves
      out the same work, since no ``pl.pallas_call`` of the JAX package
      passes a ``cost_estimate``.
    - ``bytes_accessed``: the bytes of every tensor in the arguments, read
      once, plus every tensor in the result, written once (nests of
      dicts, lists and tuples walked). It is the least traffic the call
      could make, not XLA's per-instruction sum, and is never compared
      with XLA's number.
    """
    from torch.utils.flop_counter import FlopCounterMode

    from tpuscratch_torch.comm.collectives import record_collectives

    with record_collectives() as ops, FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    return Ledger(
        collectives=tuple(CollectiveOp(k, b, g) for k, b, g in ops),
        flops=float(fc.get_total_flops()),
        bytes_accessed=float(_tensor_bytes(list(args) + list(kwargs.values()))
                             + _tensor_bytes(out)),
    )


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """A ledger diffed against one MEASURED span: achieved rates and
    their fraction of the stated peaks.  Fractions are None when the
    corresponding peak was not given."""

    measured_s: float
    flops_per_s: float
    hbm_bytes_per_s: float
    wire_bytes_per_s: float
    flops_fraction: Optional[float]
    hbm_fraction: Optional[float]
    wire_fraction: Optional[float]

    @property
    def bound(self) -> str:
        """Which stated peak the run came closest to saturating."""
        cands = {
            "compute": self.flops_fraction,
            "memory": self.hbm_fraction,
            "network": self.wire_fraction,
        }
        cands = {k: v for k, v in cands.items() if v is not None}
        if not cands:
            return "unknown"
        return max(cands, key=cands.get)

    def summary(self) -> str:
        def pct(f):
            return "n/a" if f is None else f"{100 * f:.1f}%"

        return (
            f"measured {self.measured_s * 1e3:.3f} ms: "
            f"{self.flops_per_s / 1e12:.3f} TFLOP/s "
            f"({pct(self.flops_fraction)} of peak), "
            f"HBM {self.hbm_bytes_per_s / 1e9:.2f} GB/s "
            f"({pct(self.hbm_fraction)}), "
            f"wire {self.wire_bytes_per_s / 1e9:.2f} GB/s "
            f"({pct(self.wire_fraction)}) -> {self.bound}-bound"
        )


def roofline(
    ledger: Ledger,
    measured_s: float,
    executions: int = 1,
    peak_flops_per_s: Optional[float] = None,
    peak_hbm_bytes_per_s: Optional[float] = None,
    peak_wire_bytes_per_s: Optional[float] = None,
) -> RooflineReport:
    """Diff the ledger against a measured wall time (one span covering
    ``executions`` runs of the program): achieved FLOP/s, HBM GB/s, and
    wire GB/s, each as a fraction of the given peak."""
    if measured_s <= 0:
        raise ValueError(f"measured_s must be > 0, got {measured_s}")
    flops_rate = ledger.flops * executions / measured_s
    hbm_rate = ledger.bytes_accessed * executions / measured_s
    wire_rate = ledger.total_wire_bytes() * executions / measured_s

    def frac(rate, peak):
        return None if peak is None else rate / peak

    return RooflineReport(
        measured_s=measured_s,
        flops_per_s=flops_rate,
        hbm_bytes_per_s=hbm_rate,
        wire_bytes_per_s=wire_rate,
        flops_fraction=frac(flops_rate, peak_flops_per_s),
        hbm_fraction=frac(hbm_rate, peak_hbm_bytes_per_s),
        wire_fraction=frac(wire_rate, peak_wire_bytes_per_s),
    )
