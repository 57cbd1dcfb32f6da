"""Serving-side decode throughput and per-token latency (BASELINE row 12).

The twin of ``tpuscratch.bench.decode_bench``'s default path: it drives
the real engine (host scheduling included: that loop is part of serving
latency) in steady state, every slot busy, one engine tick one token per
slot. Submit ``n_slots`` requests with budgets that keep every slot busy
through the window, warm up past prefill and the first decode, then time
each tick alone: per-token latency is the tick time, tokens/s is
``n_slots / p50``. Each tick pulls its sampled tokens to the host, so each
time is fenced.

Every row also carries the decode sweep's roofline: the bytes the
measured sweeps read (each live slot's page footprint, ``cached_pages``,
times the pool's exact bytes per page, pages plus scale planes) over the
measured wall, as a rate and as a fraction of the card's memory rate
(:func:`peak_hbm_bytes_per_s`). Speculative, macro, chunked, tiered and
router benches wait for their engine levers (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from tpuscratch_torch.bench.timing import BenchResult, percentile

#: stated peak memory rate of the roofline row, overridable with
#: TPUSCRATCH_PEAK_HBM_GBPS: the H100 SXM's 3.35 TB/s (NVIDIA data sheet)
#: on the card; on the CPU the JAX package's dual-channel DDR4-3200 proxy
#: (51.2 GB/s), a number to compare a CPU run with itself only
_PEAK_HBM_ENV = "TPUSCRATCH_PEAK_HBM_GBPS"
_DEFAULT_PEAK_HBM_GBPS = {"cuda": 3350.0, "cpu": 51.2}


def peak_hbm_bytes_per_s(device) -> float:
    """The roofline denominator for the decode sweep (bytes/s)."""
    env = os.environ.get(_PEAK_HBM_ENV, "").strip()
    if env:
        return float(env) * 1e9
    return _DEFAULT_PEAK_HBM_GBPS[torch.device(device).type] * 1e9


@dataclasses.dataclass(frozen=True)
class DecodeBenchResult:
    """BenchResult plus the latency percentiles a serving SLO reads and the
    sweep's roofline: the static bytes the measured sweeps read (page
    counts x exact bytes per page) over the measured wall."""

    result: BenchResult
    n_slots: int
    achieved_bytes_per_s: float = 0.0
    achieved_frac: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.result.items_per_s

    @property
    def p50_s(self) -> float:
        return percentile(self.result.times_s, 50)

    @property
    def p99_s(self) -> float:
        return percentile(self.result.times_s, 99)

    def summary(self) -> str:
        return (f"{self.result.name}: {self.tokens_per_s:.3e} tok/s, per-token p50 "
                f"{self.p50_s * 1e3:.3f} ms / p99 {self.p99_s * 1e3:.3f} ms, sweep "
                f"{self.achieved_bytes_per_s / 1e9:.2f} GB/s "
                f"({100 * self.achieved_frac:.2f}% of peak)")


def bench_budget(measure_steps: int = 32, warmup_steps: int = 4) -> int:
    """Per-slot generation budget of one :func:`bench_decode` window:
    warmup + measure + 2 ticks of one token each (the +2 keeps every slot
    alive through the last measured tick, so no eviction lands in it)."""
    return warmup_steps + measure_steps + 2


def fitting_batches(scfg, batches, prompt_len: int = 8, measure_steps: int = 32,
                    warmup_steps: int = 4) -> tuple[int, tuple[int, ...]]:
    """(pages one slot reserves, the ``batches`` whose full bank fits one
    group's pool) for a :func:`bench_decode` window."""
    budget = bench_budget(measure_steps, warmup_steps)
    need = -(-(prompt_len + budget) // scfg.page_size)
    return need, tuple(b for b in batches if b * need <= scfg.n_pages)


def bench_decode(mesh, cfg, scfg, prompt_len: int = 8, measure_steps: int = 32,
                 warmup_steps: int = 4, params=None, embed=None) -> DecodeBenchResult:
    """Steady-state decode: all ``scfg.n_slots`` slots busy, one time per
    tick over ``measure_steps`` ticks after ``warmup_steps`` warm ones
    (prefill and the first decode, with the kernel build, land in warmup).
    Raises when the warmup leaves a slot empty, when a program is built
    inside the window, or when the dispatch identities fail."""
    from tpuscratch_torch.serve import Request, ServeEngine

    budget = bench_budget(measure_steps, warmup_steps)
    scfg = dataclasses.replace(scfg, max_seq=max(scfg.max_seq, prompt_len + budget))
    engine = ServeEngine(mesh, cfg, scfg, params=params, embed=embed)
    prompt = tuple(t % scfg.vocab for t in range(1, prompt_len + 1))
    for i in range(scfg.n_slots):
        engine.submit(Request(rid=i, prompt=prompt, max_new=budget))
    for _ in range(warmup_steps):
        engine.step()
    if engine.n_active != scfg.n_slots:
        raise RuntimeError(f"warmup left {engine.n_active}/{scfg.n_slots} slots busy: "
                           "raise the page pool or lower the batch")
    built0 = engine.decode_compiles + engine.prefill_compiles
    tokens0, slots0 = engine.tokens_generated, engine.slot_steps
    disp0, sync0 = engine.dispatches, engine.host_syncs
    page_bytes = scfg.page_size * engine.kv_bytes_per_token
    times = []
    swept = 0.0
    for _ in range(measure_steps):
        # the footprint grows inside the tick as frontiers advance: the
        # trapezoid of the tick-boundary samples
        before = engine.cached_pages * page_bytes
        t0 = time.perf_counter()
        engine.step()  # pulls sampled tokens to host: fenced
        times.append(time.perf_counter() - t0)
        swept += 0.5 * (before + engine.cached_pages * page_bytes)
    if engine.decode_compiles + engine.prefill_compiles != built0:
        raise RuntimeError("a program was built inside the measured window")
    tokens = engine.tokens_generated - tokens0
    sweeps = engine.slot_steps - slots0
    disp = engine.dispatches - disp0
    if engine.host_syncs - sync0 != disp or disp != measure_steps:
        raise RuntimeError(f"{disp} dispatches and {engine.host_syncs - sync0} host syncs "
                           f"in {measure_steps} ticks")
    if sweeps != measure_steps * scfg.n_slots or tokens != sweeps:
        raise RuntimeError(f"{sweeps} slot steps and {tokens} tokens in {measure_steps} ticks "
                           f"of {scfg.n_slots} slots")
    res = BenchResult(
        name=f"decode b={scfg.n_slots} prompt={prompt_len} page={scfg.page_size} "
             f"kv={scfg.kv_dtype} fused={scfg.fused_attention}",
        times_s=tuple(times), items=tokens / measure_steps)
    wall = sum(times)
    achieved = swept / wall if wall else 0.0
    return DecodeBenchResult(res, scfg.n_slots, achieved_bytes_per_s=achieved,
                             achieved_frac=achieved / peak_hbm_bytes_per_s(mesh.device))


def _kind(name: str) -> str:
    """The group a CUDA kernel's name falls in, for :func:`profile_ticks`."""
    low = name.lower()
    if "paged_attention" in low:
        return "paged attention"
    if "flash_" in low:
        return "flash attention"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere", "dot_kernel")):
        return "matmul"
    if "index" in low or "gather" in low or "scatter" in low:
        return "index/gather/scatter"
    if "reduce" in low or "argmax" in low or "sort" in low or "scan" in low:
        return "reduce/sort/scan"
    if "copy" in low or "memcpy" in low or "memset" in low or "fill" in low:
        return "copy/fill"
    return "elementwise"


def profile_ticks(mesh, cfg, scfg, prompt_len: int = 64, ticks: int = 16, warmup_steps: int = 4,
                  params=None, embed=None) -> dict:
    """Where a steady-state decode tick's time goes: ``ticks`` engine
    ticks with every slot busy under ``torch.profiler`` (CPU and CUDA
    activity), after as many unprofiled ones. Returns the unprofiled and
    the profiled wall per tick, the device's kernel time per tick (one
    stream, so kernels do not overlap), its idle share against each wall
    (the profiler's own host cost lengthens the profiled tick, so
    ``idle_share`` is the unprofiled one), kernel launches per tick, and
    kernel time per tick by group and by name (the ten largest)."""
    from torch.profiler import ProfilerActivity, profile

    from tpuscratch_torch.serve import Request, ServeEngine

    budget = warmup_steps + 2 * ticks + 2
    scfg = dataclasses.replace(scfg, max_seq=max(scfg.max_seq, prompt_len + budget))
    engine = ServeEngine(mesh, cfg, scfg, params=params, embed=embed)
    prompt = tuple(t % scfg.vocab for t in range(1, prompt_len + 1))
    for i in range(scfg.n_slots):
        engine.submit(Request(rid=i, prompt=prompt, max_new=budget))
    for _ in range(warmup_steps):
        engine.step()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        wall = time.perf_counter() - t0
    split = device_time_split(prof, ticks)
    tick_ms, profiled_ms = plain_wall / ticks * 1e3, wall / ticks * 1e3
    return {"batch": scfg.n_slots, "tick_ms": tick_ms, "profiled_tick_ms": profiled_ms,
            "device_ms": split["device_ms"], "idle_share": 1.0 - split["device_ms"] / tick_ms,
            "idle_share_profiled": 1.0 - split["device_ms"] / profiled_ms,
            "launches_per_tick": split["launches"], "groups_ms": split["groups_ms"],
            "top_ms": split["top_ms"]}


def device_time_split(prof, per: int) -> dict:
    """A ``torch.profiler`` window's CUDA kernel time, divided by ``per``
    (the ticks or steps it covered): ``device_ms`` in all (one stream, so
    kernels do not overlap), ``launches``, ms by group (``_kind``) and the
    ten largest kernels by name."""
    kernels: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + us
            launches += e.count
    groups: dict[str, float] = {}
    for name, us in kernels.items():
        groups[_kind(name)] = groups.get(_kind(name), 0.0) + us / 1e3 / per
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": sum(kernels.values()) / 1e3 / per, "launches": launches / per,
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_ms": [(name[:60], us / 1e3 / per) for name, us in top]}


def sweep(mesh, cfg, scfg, batch_sizes, **kw) -> list[DecodeBenchResult]:
    """``bench_decode`` across batch (slot-count) sizes: the
    throughput/latency trade curve."""
    out = []
    for b in batch_sizes:
        r = bench_decode(mesh, cfg, dataclasses.replace(scfg, n_slots=b), **kw)
        print(f"# {r.summary()}", file=sys.stderr)
        out.append(r)
    return out


def default_decode_setup(on_card: bool):
    """The BASELINE row-12 workload: (model cfg, serve cfg, batch sizes,
    bench kwargs). On the card the JAX package's TPU shapes (d_model 1024,
    8 heads, 4 experts, d_ff 4096, 4 layers; 512 pages of 16 tokens,
    vocab 1024; batches 1, 8, 32; prompt 64; 64 measured ticks), on the
    CPU its CPU shapes."""
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.serve import ServeConfig

    cfg = (TransformerConfig(d_model=1024, n_heads=8, n_experts=4, d_ff=4096, n_layers=4,
                             capacity_factor=2.0)
           if on_card else
           TransformerConfig(d_model=32, n_heads=2, n_experts=2, d_ff=64, n_layers=1))
    scfg = ServeConfig(n_pages=512 if on_card else 64, page_size=16 if on_card else 4,
                       vocab=1024 if on_card else 32)
    batches = (1, 8, 32) if on_card else (1, 4)
    kwargs = dict(prompt_len=64 if on_card else 4, measure_steps=64 if on_card else 8)
    return cfg, scfg, batches, kwargs
