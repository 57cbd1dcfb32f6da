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
(:func:`peak_hbm_bytes_per_s`). Under speculation and macro steps a tick
emits more than one token a slot: tokens per tick come from the
engine's counter, per-token latency scales each tick by the tokens it
emitted, and the window carries the dispatches and host syncs per token.
``bench_serve_stream`` drains a request stream with admissions in the
window (prefix sharing), ``bench_chunk_longmix`` races chunked against
monolithic prefill under one long arrival. The tiered, disaggregated and
router benches wait for their engine parts (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
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
    counts x exact bytes per page x the tick's token rounds) over the
    measured wall. ``times_per_token_s`` scales each tick to one slot's
    per-token latency (``tick_s * n_slots / tokens_that_tick``): a
    speculative or macro tick emits more than ``n_slots`` tokens.
    ``dispatches_per_token`` and ``host_syncs_per_token`` are the
    engine's counters over the window's tokens."""

    result: BenchResult
    n_slots: int
    achieved_bytes_per_s: float = 0.0
    achieved_frac: float = 0.0
    kv_dtype: str = "float32"
    spec_k: int = 0
    accept_len_mean: float | None = None
    times_per_token_s: tuple[float, ...] = ()
    swept_bytes: float = 0.0
    macro_steps: int = 1
    dispatches_per_token: float = 0.0
    host_syncs_per_token: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.result.items_per_s

    @property
    def p50_s(self) -> float:
        return percentile(self.times_per_token_s or self.result.times_s, 50)

    @property
    def p99_s(self) -> float:
        return percentile(self.times_per_token_s or self.result.times_s, 99)

    def summary(self) -> str:
        out = (f"{self.result.name}: {self.tokens_per_s:.3e} tok/s, per-token p50 "
               f"{self.p50_s * 1e3:.3f} ms / p99 {self.p99_s * 1e3:.3f} ms, sweep "
               f"{self.achieved_bytes_per_s / 1e9:.2f} GB/s "
               f"({100 * self.achieved_frac:.2f}% of peak)")
        if self.accept_len_mean is not None:
            out += f", accept len {self.accept_len_mean:.2f}/{self.spec_k}"
        if self.macro_steps > 1:
            out += (f", macro T={self.macro_steps}: {self.dispatches_per_token:.4f} "
                    f"dispatches/token, {self.host_syncs_per_token:.4f} syncs/token")
        return out


def tick_tokens(scfg) -> int:
    """The most tokens one engine tick can emit a slot: ``(spec_k + 1) x
    macro_steps``."""
    from tpuscratch_torch.serve.engine import macro_clamp

    return (scfg.spec_k + 1) * macro_clamp(scfg)[0]


def bench_budget(measure_steps: int = 32, warmup_steps: int = 4,
                 tokens_per_tick: int = 1) -> int:
    """Per-slot generation budget of one :func:`bench_decode` window:
    (warmup + measure + 2) ticks of ``tokens_per_tick`` tokens (the +2
    keeps every slot alive through the last measured tick, so no eviction
    lands in it)."""
    return (warmup_steps + measure_steps + 2) * tokens_per_tick


def fitting_batches(scfg, batches, prompt_len: int = 8, measure_steps: int = 32,
                    warmup_steps: int = 4,
                    tokens_per_tick: int | None = None) -> tuple[int, tuple[int, ...]]:
    """(pages one slot reserves, the ``batches`` whose full bank fits one
    group's pool) for a :func:`bench_decode` window; ``tokens_per_tick``
    defaults to the config's own ceiling (:func:`tick_tokens`)."""
    if tokens_per_tick is None:
        tokens_per_tick = tick_tokens(scfg)
    budget = bench_budget(measure_steps, warmup_steps, tokens_per_tick)
    need = -(-(prompt_len + budget) // scfg.page_size)
    return need, tuple(b for b in batches if b * need <= scfg.n_pages)


def bench_decode(mesh, cfg, scfg, prompt_len: int = 8, measure_steps: int = 32,
                 warmup_steps: int = 4, params=None, embed=None,
                 prompt: tuple[int, ...] | None = None) -> DecodeBenchResult:
    """Steady-state decode: all ``scfg.n_slots`` slots busy, one time per
    tick over ``measure_steps`` ticks after ``warmup_steps`` warm ones
    (prefill and the first decode, with the kernel build, land in warmup).
    Under speculation a tick emits a variable count, so tokens per tick
    come from the engine's counter and the window carries the mean
    accepted length; pass an accept-friendly ``prompt`` to measure the
    amortization regime. Raises when the warmup leaves a slot empty,
    when a program is built inside the window, or when the dispatch
    identities fail (one sync a dispatch; rounds == dispatches x T;
    slot steps == rounds x bank)."""
    from tpuscratch_torch.serve import Request, ServeEngine

    if prompt is not None:
        prompt_len = len(prompt)
    budget = bench_budget(measure_steps, warmup_steps, tick_tokens(scfg))
    scfg = dataclasses.replace(scfg, max_seq=max(scfg.max_seq, prompt_len + budget))
    engine = ServeEngine(mesh, cfg, scfg, params=params, embed=embed)
    if prompt is None:
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
    accepted0 = engine.spec_accepted
    disp0, sync0, rounds0 = engine.dispatches, engine.host_syncs, engine.decode_rounds
    page_bytes = scfg.page_size * engine.kv_bytes_per_token
    times, tick_tok = [], []
    swept = 0.0
    tprev, rprev = engine.tokens_generated, engine.decode_rounds
    for _ in range(measure_steps):
        # the footprint grows inside the tick as frontiers advance: the
        # trapezoid of the tick-boundary samples, once a token round
        before = engine.cached_pages * page_bytes
        t0 = time.perf_counter()
        engine.step()  # pulls sampled tokens to host: fenced
        times.append(time.perf_counter() - t0)
        swept += 0.5 * (before + engine.cached_pages * page_bytes) * (engine.decode_rounds - rprev)
        rprev = engine.decode_rounds
        tick_tok.append(engine.tokens_generated - tprev)
        tprev = engine.tokens_generated
    if engine.decode_compiles + engine.prefill_compiles != built0:
        raise RuntimeError("a program was built inside the measured window")
    tokens = engine.tokens_generated - tokens0
    sweeps = engine.slot_steps - slots0
    disp, syncs = engine.dispatches - disp0, engine.host_syncs - sync0
    rounds = engine.decode_rounds - rounds0
    T = engine.macro_steps_effective
    if syncs != disp or rounds != disp * T or sweeps != rounds * scfg.n_slots:
        raise RuntimeError(f"{disp} dispatches, {syncs} host syncs, {rounds} rounds and "
                           f"{sweeps} slot steps at T={T} and bank {scfg.n_slots}")
    if disp != -(-sweeps // (T * scfg.n_slots)):
        raise RuntimeError(f"dispatches {disp} != ceil(slot_steps {sweeps} / (T={T} * bank "
                           f"{scfg.n_slots}))")
    res = BenchResult(
        name=f"decode b={scfg.n_slots} prompt={prompt_len} page={scfg.page_size} "
             f"kv={scfg.kv_dtype} fused={scfg.fused_attention}"
             + (f" spec={scfg.spec_k}" if scfg.spec_k else "")
             + (f" macro={T}" if T > 1 else ""),
        times_s=tuple(times), items=tokens / measure_steps)
    wall = sum(times)
    achieved = swept / wall if wall else 0.0
    return DecodeBenchResult(
        res, scfg.n_slots, achieved_bytes_per_s=achieved,
        achieved_frac=achieved / peak_hbm_bytes_per_s(mesh.device), kv_dtype=scfg.kv_dtype,
        spec_k=scfg.spec_k,
        accept_len_mean=((engine.spec_accepted - accepted0) / sweeps
                         if scfg.spec_k > 0 and sweeps else None),
        times_per_token_s=tuple(t * scfg.n_slots / max(tk, 1) for t, tk in zip(times, tick_tok)),
        swept_bytes=swept, macro_steps=T, dispatches_per_token=disp / max(1, tokens),
        host_syncs_per_token=syncs / max(1, tokens))


def accept_friendly_prompt(length: int, vocab: int, period: int = 4) -> tuple[int, ...]:
    """A periodic prompt, the workload speculation is for: the prompt-lookup
    proposer finds its suffix n-gram at once and drafts the pattern."""
    return tuple((t % period) + 1 for t in range(length))


def shared_prefix_prompts(n: int, length: int, share_ratio: float, vocab: int,
                          seed: int = 0) -> list[tuple[int, ...]]:
    """``n`` prompts of ``length`` tokens sharing their first
    ``round(share_ratio * length)`` tokens (the JAX package's seeded
    draws): the system-prompt workload of the prefix-sharing sweep."""
    if not 0.0 <= share_ratio <= 1.0:
        raise ValueError(f"share_ratio must be in [0, 1], got {share_ratio}")
    rng = np.random.default_rng(seed)
    shared_len = round(share_ratio * length)
    prefix = tuple(int(t) for t in rng.integers(0, vocab, shared_len))
    return [prefix + tuple(int(t) for t in rng.integers(0, vocab, length - shared_len))
            for _ in range(n)]


def bench_serve_stream(mesh, cfg, scfg, prompts, max_new: int = 8, disagg: bool = False,
                       warmup: bool = True, params=None, embed=None) -> dict:
    """Drain one request stream through a fresh engine, timing every tick
    (admissions included: where prefix sharing pays). Returns wall
    seconds, tokens/s, per-tick p50/p99 and the report's sharing counters
    (prefilled against shared prompt tokens, copy-on-write pages, fresh
    K/V bytes). ``warmup`` first drains a bank of throwaway requests so
    every program is built before the window; its pages all free back,
    so the stream's sharing starts cold. The disaggregated engine
    (``disagg=True``) is not ported yet (ROADMAP A14)."""
    from tpuscratch_torch.serve import Request, ServeEngine

    if disagg:
        raise NotImplementedError("bench_serve_stream(disagg=True): the disaggregated engine "
                                  "is not ported to tpuscratch_torch yet (ROADMAP A14)")
    eng = ServeEngine(mesh, cfg, scfg, params=params, embed=embed)
    if warmup:
        eng.run([Request(rid=900_000 + i, prompt=tuple(prompts[0]), max_new=2)
                 for i in range(scfg.n_slots)])
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=tuple(p), max_new=max_new))
    ptok0, stok0 = eng.prefill_tokens, eng.shared_tokens
    cow0, fresh0 = eng.cow_pages, eng.fresh_kv_bytes
    outputs, times = {}, []
    t0 = time.perf_counter()
    while eng.n_queued or eng.n_active:
        if len(times) >= 100_000:
            raise RuntimeError(f"stream did not drain ({eng.n_queued} queued, "
                               f"{eng.n_active} active)")
        t1 = time.perf_counter()
        for rid, toks in eng.step():
            outputs[rid] = toks
        times.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    tokens = sum(len(t) for t in outputs.values())
    prefill_tokens = eng.prefill_tokens - ptok0
    shared_tokens = eng.shared_tokens - stok0
    fresh = eng.fresh_kv_bytes - fresh0
    return {
        "requests": len(prompts), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall if wall else 0.0,
        "p50_tick_s": percentile(times, 50), "p99_tick_s": percentile(times, 99),
        "prefill_tokens": prefill_tokens, "shared_tokens": shared_tokens,
        "cow_pages": eng.cow_pages - cow0, "fresh_kv_bytes": fresh,
        "fresh_kv_bytes_per_token": fresh / tokens if tokens else 0.0,
        "prefill_frac": prefill_tokens / max(1, prefill_tokens + shared_tokens),
        "outputs": tuple(sorted(outputs.items())),
    }


def bench_chunk_longmix(mesh, cfg, scfg, chunk: int, long_len: int = 32,
                        n_resident: int | None = None, max_new: int = 24, params=None,
                        embed=None, against: str = "monolithic") -> dict:
    """The chunked-prefill p99 claim: resident short-prompt streams decode
    while one long prompt arrives mid-stream; per-tick latency is
    compared between the monolithic engine (the long prefill lands in
    one tick) and ``chunk_prefill=chunk``.

    ``against`` names what the chunked run's greedy outputs must equal:
    the monolithic run's (the JAX bench's assertion), which holds where
    the MoE drops no token (``capacity_factor >= n_experts``: routing does
    not depend on the batch), or (``"plain"``) the same chunked stream
    run with the plain attention, the check that holds at any capacity
    (a monolithic and a chunked prefill batch the tokens differently,
    and a dropping MoE routes them differently); it is refused where the
    chunked run takes the plain attention itself (off the card, or
    ``fused_attention="off"``), which would hold a run to itself. The
    chunked run's context-prefill sweeps are returned as ``ctx_sweeps``, the tokens
    where the two runs differ as ``mono_diff``, and ``sweeps_total``
    counts every decode round and context sweep of the monolithic and
    chunked engines (warmup included), each of which runs every layer's
    attention once."""
    from tpuscratch_torch.serve import Request, ServeEngine

    if against not in ("monolithic", "plain"):
        raise ValueError(f"against must be 'monolithic' or 'plain', got {against!r}")
    if against == "plain" and (mesh.device.type != "cuda" or scfg.fused_attention == "off"):
        raise ValueError("against='plain' holds the paged kernel to the plain attention: it "
                         "needs the card and fused_attention 'auto' or 'on'")
    n_res = (scfg.n_slots - 1) if n_resident is None else n_resident
    long_prompt = tuple(1 + t % (scfg.vocab - 1) for t in range(long_len))
    sweeps, total = [], []

    def drive(sc):
        eng = ServeEngine(mesh, cfg, sc, params=params, embed=embed)
        # every program the window touches is built first
        eng.run([Request(rid=900_000, prompt=(1, 2), max_new=2),
                 Request(rid=900_001, prompt=long_prompt, max_new=2)])
        ctx0 = eng.ctx_sweeps
        for i in range(n_res):
            eng.submit(Request(rid=i, prompt=(1 + i % 4, 2), max_new=max_new))
        outputs, times = {}, []
        arrived = False
        while eng.n_queued or eng.n_active:
            if len(times) >= 100_000:
                raise RuntimeError("long-mix stream did not drain")
            if not arrived and len(times) == 4:  # the residents are in steady decode
                eng.submit(Request(rid=10_000, prompt=long_prompt, max_new=4))
                arrived = True
            t0 = time.perf_counter()
            for rid, toks in eng.step():
                outputs[rid] = toks
            times.append(time.perf_counter() - t0)
        sweeps.append(eng.ctx_sweeps - ctx0)
        total.append(eng.decode_rounds + eng.ctx_sweeps)
        return outputs, times

    base_out, base_t = drive(scfg)
    chunked = dataclasses.replace(scfg, chunk_prefill=chunk)
    chunk_out, chunk_t = drive(chunked)
    mono_diff = sum(a != b for r in chunk_out for a, b in zip(chunk_out[r], base_out[r]))
    want = base_out
    if against == "plain":
        want, _ = drive(dataclasses.replace(chunked, fused_attention="off"))
    if want != chunk_out:
        raise RuntimeError(f"chunked long-mix outputs diverged from the {against} run: the "
                           "p99 comparison is void")
    return {"long_len": long_len, "chunk": chunk,
            "p99_s_mono": percentile(base_t, 99), "p99_s_chunked": percentile(chunk_t, 99),
            "p99_ratio": percentile(chunk_t, 99) / percentile(base_t, 99),
            "max_s_mono": max(base_t), "max_s_chunked": max(chunk_t),
            "ctx_sweeps": sweeps[1], "sweeps_total": total[0] + total[1],
            "mono_diff": mono_diff, "outputs": tuple(sorted(chunk_out.items()))}


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
