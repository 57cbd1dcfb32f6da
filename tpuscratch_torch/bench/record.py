"""BASELINE configs 2-6, 8-16 and 18 on the card (config 1 is ``bench.headline``).

``python -m tpuscratch_torch.bench.record [--configs 2,3,4,5,6,8,9,10,11,12,13,14,15,16,18]
[--json PATH] [--check BASE.json [--noise 0.1]]``
prints one JSON line per metric, with the JAX package's metric names
(``tpuscratch.bench.record``): config 2 the dot product, 3 pingpong, 4 the
2D stencil on a 4x4 mesh at 8192^2, 6 flash attention at S 4096, 8 the
pair-FFT round trip at 1024^2 and the direct against four-step race, 9 the 3D
7-point stencil at 256x512x512, 10 the DMA-halo stencil at 1024^2, 11 the
composed train step (the 4-layer MoE transformer at d_model 1024, batch 8,
seq 2048) and its pipelined step on a 1x1x1 mesh, 12 serving decode (the
same model behind the continuous-batching engine), 13 replicated against
ZeRO-sharded training of that model at dp 1, 2 and 4 stacked on the card,
and the accumulation sweep, 14 the plan-composed ZeRO step at pp x dp in
{1, 2}^2, serial against the overlap schedule, 16 the goodput of the three
chunked workloads (trainer, halo driver, solver runner) preempted once
under the supervisor, with blocking and with async checkpoints, 5 weak
scaling of the 2D stencil over 1-16 stacked ranks, 15 the 3D multigrid's
weak scaling and the s-step and pipelined-CG ablations with the ledger's
collective counts, 18 a trainer and a solver co-scheduled on one card.
``--json`` appends the rows to a file; ``--check`` diffs them against a
baseline file through ``obs.regress``.
Each line names the device it ran on. Unlike the JAX harness, nothing is
caught (a failing method, impl or re-measure fails the run), except in
config 8's race, which records a point's error in the line, as the JAX
harness does, and leaves that point's time out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import torch

from tpuscratch_torch.bench.decode_bench import (
    bench_decode,
    default_decode_setup,
    peak_hbm_bytes_per_s,
)
from tpuscratch_torch.bench.decode_bench import sweep as decode_sweep
from tpuscratch_torch.bench.dot_bench import bench_dot
from tpuscratch_torch.bench.headline import race, two_phase_stencil
from tpuscratch_torch.bench.pingpong import DEFAULT_SIZES, sweep, verify_echo
from tpuscratch_torch.bench.stencil_bench import bench_stencil3d
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh, make_mesh_1d, make_mesh_2d

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


#: Config 8's race sizes on the card (the JAX package's chip set) and
#: the FLOPs a timed call aims at (~1 s of products).
CONFIG8_SIZES = (512, 1024, 4096, 8192)
CONFIG8_TARGET_FLOPS = 2e13


def config8_dft(out: list, iters: int = 3, device=None, sizes=None,
                max_rounds: int = 1000) -> dict:
    """The pair-FFT round trip: the headline ``pair_dft_roundtrip_tflops``
    (1000 direct round trips at 1024^2 on the card), then the race of the
    direct DFT against the four-step split, seconds a fwd+inv round trip at
    each of ``sizes`` (the card's default 512, 1024, 4096 and 8192; 64 and
    128 on the CPU), the winner a size; FLOP rates of the two methods are
    not comparable. The JAX harness skips direct above 2e8 bytes of tables
    (its remote compile's limit); here 8192's two tables are 537 MB of the
    card's memory and race. A race point times round trips of about 2e13
    FLOPs on the card, at most ``max_rounds`` (the JAX harness's 1000). A
    point that raises is recorded under ``errors`` and has no time.
    Returns ``{"headline", "race"}``."""
    from tpuscratch_torch.bench.fft_bench import bench_dft, pair_fft_flops

    mesh = make_mesh_1d("x", device=device)
    on_card = mesh.device.type == "cuda"
    r = bench_dft(iters=iters, mesh=mesh)
    print(f"# {r.summary()}", file=sys.stderr)
    _emit(out, mesh, config=8, metric="pair_dft_roundtrip_tflops", value=r.items_per_s / 1e12,
          p50_s=r.p50, detail=f"{r.name} (float32 products)", n_devices=1)
    if sizes is None:
        sizes = CONFIG8_SIZES if on_card else (64, 128)
    target = CONFIG8_TARGET_FLOPS if on_card else 2e7
    race: dict[str, dict] = {}
    for n in sizes:
        per, errors = {}, {}
        for method in ("direct", "four-step"):
            rounds = max(1, min(max_rounds, int(target / pair_fft_flops(n, method, 1))))
            try:
                rm = bench_dft(n=n, rounds=rounds, iters=iters, mesh=mesh, method=method,
                               fence="readback" if on_card else "block")
            except Exception as e:  # noqa: BLE001 -- the point's error goes into the line
                errors[method] = f"{type(e).__name__}: {e}"
                print(f"# config 8 {method}@{n} failed: {errors[method]}", file=sys.stderr)
                continue
            per[method] = rm.p50 / rounds
            print(f"# {rm.summary()} -> {per[method] * 1e3:.4f} ms/round", file=sys.stderr)
        race[str(n)] = {"s_per_roundtrip": per, **({"errors": errors} if errors else {}),
                        **({"winner": min(per, key=per.get)} if per else {})}
    timed = {n: v for n, v in race.items() if "winner" in v}
    if timed:
        # the value is pinned to the 1024^2 winner, as in the JAX harness
        ref = timed.get("1024") or timed[max(timed, key=int)]
        _emit(out, mesh, config=8, metric="pair_fft_crossover",
              value=ref["s_per_roundtrip"][ref["winner"]], race=race,
              detail="s per fwd+inv 2D round trip at 1024^2 (winner); full race in 'race'",
              n_devices=1)
    return {"headline": r, "race": race}


#: Config 9's race: every one-step impl and the streamed kernel at two depths.
CONFIG9_IMPLS = ("compact", "compact-pallas", "compact-strips", "compact-asm",
                 "stream:2", "stream:4")


def config9_stencil3d(out: list, iters: int = 3, tile=(256, 512, 512), impls=CONFIG9_IMPLS,
                      screen_s: float = 0.1, final_s: float = 1.0, device=None) -> dict:
    """The 3D 7-point stencil, periodic, on a 1x1x1 mesh with a ``tile``
    world: every impl of the race sized to runs of at least ``screen_s``,
    the winner re-measured for ``final_s``. Returns ``{"final", "winner",
    "screen"}``."""
    mesh = make_mesh((1, 1, 1), ("z", "row", "col"), device)
    final, winner, screen = two_phase_stencil(impls, tuple(tile), mesh, iters, screen_s, final_s,
                                              bench=bench_stencil3d)
    cells = math.prod(tile)
    _emit(out, mesh, config=9, metric="stencil3d_cell_updates_per_s",
          value=final.items_per_s, p50_s=final.p50, steps=final.items // cells,
          us_per_step={i: r.p50 / (r.items // cells) * 1e6 for i, r in screen.items()},
          detail=final.name, n_devices=1)
    return {"final": final, "winner": winner, "screen": screen}


def config6_flash_attention(out: list, iters: int = 3, device=None) -> list:
    """Flash-attention TFLOP/s, causal and full: S 4096, H 8, D 128, f32 on
    the card (50 calls a timed run), the JAX package's CPU shapes on the
    CPU. Returns the two results."""
    from tpuscratch_torch.bench.attention_bench import bench_attention
    from tpuscratch_torch.runtime.mesh import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    mesh = make_mesh((1,), ("x",), dev)
    results = []
    for causal in (True, False):
        r = bench_attention(S=4096 if on_card else 64, H=8 if on_card else 2,
                            D=128 if on_card else 16, causal=causal,
                            rounds=50 if on_card else 2, iters=iters, device=dev)
        print(f"# {r.summary()}", file=sys.stderr)
        _emit(out, mesh, config=6,
              metric=f"flash_attention_{'causal' if causal else 'full'}_tflops",
              value=r.items_per_s / 1e12, p50_s=r.p50, detail=r.name)
        results.append(r)
    return results


def config11_train(out: list, iters: int = 3, device=None, pp_row: bool = True) -> list:
    """Composed-training throughput: tokens/s of the full dp x sp train
    step (ring attention through the flash kernels, expert MoE, gradients,
    SGD), f32 and bf16, on a 1x1 mesh, with the FLOP estimate; the card
    takes the JAX package's TPU shapes (the 4-layer model at d_model 1024,
    batch 8, seq 2048, 20 steps), the CPU its CPU shapes. Then, with
    ``pp_row``, the pipelined row (:func:`config11_pp_row`). A failing row
    fails the config. Returns the results."""
    from tpuscratch_torch.bench.train_bench import (
        bench_train,
        default_train_setup,
        train_flops_per_token,
    )
    from tpuscratch_torch.runtime.mesh import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    mesh = make_mesh((1, 1), ("dp", "sp"), dev)
    base, batch, seq, steps = default_train_setup(on_card)
    results = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        r = bench_train(mesh=mesh, cfg=cfg, batch=batch, seq=seq, steps=steps, iters=iters,
                        fence="readback" if on_card else "block")
        fpt = train_flops_per_token(cfg, seq)
        print(f"# {r.summary()} -> {r.items_per_s:.3e} tok/s, "
              f"~{r.items_per_s * fpt / 1e12:.1f} TFLOP/s model", file=sys.stderr)
        _emit(out, mesh, config=11, metric=f"train_tokens_per_s_{dtype}", value=r.items_per_s,
              p50_s=r.p50, flops_per_token=fpt, model_tflops=r.items_per_s * fpt / 1e12,
              detail=r.name)
        results.append(r)
    if pp_row:
        results.append(config11_pp_row(out, iters=iters, device=dev))
    return results


def config11_pp_row(out: list, iters: int = 3, steps: int | None = None, device=None):
    """Config 11's pipelined row, ``train_pp_tokens_per_s``: tokens/s of the
    3-axis step (``train_step_pp``, SGD) at config 11's model on the
    degenerate 1x1x1 ("dp", "sp", "stage") mesh with ``n_micro`` 4 (2 on the
    CPU): the schedule's overhead against the plain step. ``reduced`` lists
    any cut of the JAX row's steps (20 on the card) or repeats (3). Returns
    the result."""
    from tpuscratch_torch.bench.train_ablation import pp_row_bench
    from tpuscratch_torch.bench.train_bench import default_train_setup
    from tpuscratch_torch.runtime.mesh import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    base, batch, seq, full_steps = default_train_setup(on_card)
    steps = full_steps if steps is None else steps
    r = pp_row_bench(base, batch=batch, seq=seq, steps=steps, n_micro=4 if on_card else 2,
                     iters=iters, fence="readback" if on_card else "block", device=dev)
    print(f"# {r.summary()} -> {r.items_per_s:.3e} tok/s", file=sys.stderr)
    reduced = [f"{name} {got} (JAX row: {want})" for name, got, want in
               (("steps", steps, full_steps), ("iters", iters, 3)) if got != want]
    _emit(out, make_mesh((1, 1, 1), ("dp", "sp", "stage"), dev), config=11,
          metric="train_pp_tokens_per_s", value=r.items_per_s, p50_s=r.p50, detail=r.name,
          reduced=reduced)
    return r


def _median_of(runs, key):
    """The run whose ``key`` is the median (one coherent run's fields,
    never a field-wise median)."""
    runs = sorted(runs, key=key)
    return runs[len(runs) // 2]


def config12_decode(out: list, device=None) -> dict:
    """Serving decode: steady-state engine ticks (continuous batching,
    paged KV cache) across the batch sweep, tokens/s and the per-token
    latency tail, the median of three complete sweeps by their best
    tokens/s. Three rows: ``serve_decode_tokens_per_s``,
    ``serve_decode_roofline`` (the sweep's bytes over the wall against the
    memory rate; on the card the best batch re-run with
    ``fused_attention="on"`` and then ``"off"``, back to back, their ratio
    ``fused_speedup``), and the static ``serve_kv_cache_bytes`` (bytes per
    token of pool capacity on the fp32 / int8 / fp8 ladder). The card
    takes ``default_decode_setup``'s config-12 shapes, the CPU its CPU
    shapes. The model's weights are drawn once and shared by every engine.
    Returns ``{"sweep", "fused", "plain"}`` results."""
    from tpuscratch_torch.models.transformer import init_params
    from tpuscratch_torch.runtime.mesh import resolve_device
    from tpuscratch_torch.serve.engine import init_embed
    from tpuscratch_torch.serve.kvcache import CacheGeometry, init_kv_cache, kv_cache_bytes

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg, scfg, batches, kwargs = default_decode_setup(on_card)
    mesh = make_mesh((1, 1), ("dp", "sp"), dev)
    weights = dict(params=init_params(scfg.seed, cfg, dev),
                   embed=init_embed(scfg.seed, scfg.vocab, cfg.d_model, dev))
    results = _median_of(
        [decode_sweep(mesh, cfg, scfg, batches, **kwargs, **weights) for _ in range(3)],
        key=lambda rs: max(r.tokens_per_s for r in rs))
    best = max(results, key=lambda r: r.tokens_per_s)
    _emit(out, mesh, config=12, metric="serve_decode_tokens_per_s", value=best.tokens_per_s,
          p50_s=best.p50_s, p99_s=best.p99_s,
          sweep=[{"batch": r.n_slots, "tokens_per_s": r.tokens_per_s,
                  "p50_s_per_token": r.p50_s, "p99_s_per_token": r.p99_s} for r in results],
          detail=best.summary())
    row = dict(config=12, metric="serve_decode_roofline", value=best.achieved_frac,
               achieved_frac=best.achieved_frac,
               achieved_hbm_gbps=best.achieved_bytes_per_s / 1e9,
               peak_hbm_gbps=peak_hbm_bytes_per_s(dev) / 1e9,
               kernel="fused" if on_card else "dense")
    fused = plain = None
    if on_card:  # the host-bound tick drifts between windows: time both modes back to back
        one = dataclasses.replace(scfg, n_slots=best.n_slots)
        fused = bench_decode(mesh, cfg, dataclasses.replace(one, fused_attention="on"),
                             **kwargs, **weights)
        plain = bench_decode(mesh, cfg, dataclasses.replace(one, fused_attention="off"),
                             **kwargs, **weights)
        row.update(value=fused.achieved_frac, achieved_frac=fused.achieved_frac,
                   achieved_hbm_gbps=fused.achieved_bytes_per_s / 1e9,
                   fused_speedup=fused.tokens_per_s / plain.tokens_per_s)
    row["detail"] = (f"{row['achieved_hbm_gbps']:.3f} GB/s achieved "
                     f"({100 * row['achieved_frac']:.2f}% of {row['peak_hbm_gbps']:.0f} GB/s, "
                     f"{row['kernel']} kernel"
                     + (f", fused {row['fused_speedup']:.2f}x plain" if on_card else "") + ")")
    _emit(out, mesh, **row)
    geom = CacheGeometry(cfg.n_layers, scfg.n_pages, scfg.page_size, cfg.n_heads, cfg.d_head)
    per_tok = {name: kv_cache_bytes(init_kv_cache(geom, dtype=dt, device="meta")) / geom.max_tokens
               for name, dt in (("f32", torch.float32), ("int8", torch.int8),
                                ("fp8", torch.float8_e4m3fn))}
    _emit(out, mesh, config=12, metric="serve_kv_cache_bytes",
          bytes_per_token_f32=per_tok["f32"], bytes_per_token_int8=per_tok["int8"],
          bytes_per_token_fp8=per_tok["fp8"], int8_ratio=per_tok["int8"] / per_tok["f32"],
          detail=f"{per_tok['f32']:.0f} -> {per_tok['int8']:.0f} B/token "
                 f"({per_tok['int8'] / per_tok['f32']:.3f}x) at config-12 geometry")
    return {"sweep": results, "fused": fused, "plain": plain}


def _sync_bytes(step, *args):
    """Wire bytes of one call of ``step`` (a train step) by leg."""
    from tpuscratch_torch.comm.collectives import count_wire_bytes

    with count_wire_bytes() as wb:
        step(*args)
    return wb


def config13_zero_train(out: list, iters: int = 3, steps: int | None = None,
                        sweep_steps: int | None = None, device=None) -> dict:
    """Replicated against ZeRO-sharded training (Adam): tokens/s of both
    steps at dp 1, 2 and 4 (ranks stacked on the one device), beside the
    grad-sync wire bytes of one step of each, counted per collective call
    with the JAX package's ledger formulas (``comm.count_wire_bytes``; the
    JAX row reads them off the compiled program), then the deferred-sync
    sweep at k = 1, 2, 4 on the dp-4 mesh: sync bytes per microbatch and
    tokens/s. The card takes the JAX package's TPU shapes (the 4-layer model
    at d_model 1024, ``n_experts = max(4, dp)``, seq 2048, batch 8 a dp
    rank, 20 steps, 10 in the sweep), the CPU its CPU shapes (2 steps). Each
    row records the peak device memory of its runs (None on the CPU) and the
    per-rank optimizer bytes; ``reduced`` lists every cut of the JAX row's
    steps or repeats. Nothing is caught: a failing point fails the config.
    Returns ``{"rows": [...], "sweep": [...]}``."""
    from tpuscratch_torch.bench.train_bench import bench_train, train_data
    from tpuscratch_torch.models.transformer import (
        TransformerConfig,
        init_adam_state,
        init_params,
        train_step_adam,
    )
    from tpuscratch_torch.models.zero import (
        init_zero_adam_state,
        train_step_zero,
        zero_state_bytes_per_rank,
    )
    from tpuscratch_torch.runtime.mesh import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        base = TransformerConfig(d_model=1024, n_heads=8, n_experts=4, d_ff=4096, n_layers=4,
                                 capacity_factor=2.0, attn_impl="pallas")
        seq, batch_per_dp, full_steps, full_sweep = 2048, 8, 20, 10
    else:
        base = TransformerConfig(d_model=32, n_heads=2, n_experts=4, d_ff=64, n_layers=1)
        seq, batch_per_dp, full_steps, full_sweep = 16, 2, 2, 2
    steps = full_steps if steps is None else steps
    sweep_steps = full_sweep if sweep_steps is None else sweep_steps
    reduced = [f"{name} {got} (JAX row: {want})" for name, got, want in
               (("steps", steps, full_steps), ("sweep steps", sweep_steps, full_sweep),
                ("iters", iters, 3)) if got != want]
    fence = "readback" if on_card else "block"

    def peak_reset():
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else None

    def one_mesh(dp):
        cfg = dataclasses.replace(base, n_experts=max(base.n_experts, dp))
        return cfg, make_mesh((dp, 1), ("dp", "sp"), dev), init_params(0, cfg, dev)

    rows = []
    for dp in (1, 2, 4):
        cfg, mesh, params = one_mesh(dp)
        batch = dp * batch_per_dp
        peak_reset()
        x, y = train_data(0, batch, seq, cfg.d_model, dev)
        rep = _sync_bytes(train_step_adam(mesh, cfg), params, init_adam_state(params), x, y)
        zero = _sync_bytes(train_step_zero(mesh, cfg), params,
                           init_zero_adam_state(params, dp), x, y)
        del x, y
        row = {"dp": dp, "grad_sync_bytes_replicated": rep.grad,
               "grad_sync_bytes_zero": zero.grad,
               "grad_ratio": zero.grad / rep.grad if rep.grad else None,
               "zero_all_gather_bytes": zero.all_gather,
               "zero_state_bytes_per_rank": zero_state_bytes_per_rank(cfg, params, dp)}
        for z in (False, True):
            r = bench_train(mesh=mesh, cfg=cfg, batch=batch, seq=seq, steps=steps, iters=iters,
                            fence=fence, optimizer="adam", zero=z)
            print(f"# {r.summary()} -> {r.items_per_s:.3e} tok/s", file=sys.stderr)
            row["zero_tokens_per_s" if z else "repl_tokens_per_s"] = r.items_per_s
        row["peak_mem_bytes"] = peak()
        rows.append(_emit(out, mesh, config=13, metric=f"zero_vs_replicated_dp{dp}", **row,
                          reduced=reduced))
        del params

    dp = 4
    cfg, mesh, params = one_mesh(dp)
    batch = dp * batch_per_dp
    sweep = []
    peak_reset()
    for k in (1, 2, 4):
        x, y = train_data(0, batch, seq, cfg.d_model, dev, k)
        wb = _sync_bytes(train_step_zero(mesh, cfg, accum_steps=k), params,
                         init_zero_adam_state(params, dp), x, y)
        del x, y
        r = bench_train(mesh=mesh, cfg=cfg, batch=batch, seq=seq, steps=sweep_steps, iters=iters,
                        fence=fence, optimizer="adam", zero=True, accum_steps=k)
        print(f"# {r.summary()} -> {r.items_per_s:.3e} tok/s", file=sys.stderr)
        sweep.append({"accum": k, "sync_bytes_per_microbatch": wb.per_microbatch(k),
                      "tokens_per_s": r.items_per_s})
    _emit(out, mesh, config=13, metric="zero_accum_sweep", dp=dp, sweep=sweep,
          peak_mem_bytes=peak(), zero_state_bytes_per_rank=zero_state_bytes_per_rank(
              cfg, params, dp), reduced=reduced)
    return {"rows": rows, "sweep": sweep}


def config14_plan_overlap(out: list, iters: int = 2, steps: int | None = None, device=None,
                          cfg=None, seq: int | None = None,
                          batch_per_dp: int | None = None) -> list:
    """The overlap ablation of the plan-composed ZeRO step: tokens/s and
    step time of ``bench_train(plan=...)`` at pp x dp in {1, 2}^2 (ranks
    stacked on the one device; ``n_micro`` 2 with two stages, else 1),
    serial (one flat reduce-scatter -> update -> all-gather) against the
    overlap schedule (``prefetch_blocks`` block chains), each beside one
    step's wire bytes and reduce-scatter / all-gather calls, counted per
    collective call with the JAX package's ledger formulas
    (``comm.count_wire_bytes``: the all-reduce, reduce-scatter and
    all-gather legs; the JAX row reads every collective off the compiled
    program). The two schedules must move the same bytes, or the config
    fails. ``achieved_flops_per_s_*`` reckons FLOPs as
    ``train_flops_per_token`` times tokens/s; with ``TPUSCRATCH_PEAK_FLOPS``
    set (the card's peak, FLOP/s) each row also carries
    ``achieved_fraction_*``. On the stacked mesh the chains run in order on
    one stream, so ``overlap_speedup`` measures the cost of the
    decomposition, not an overlap. The card takes the JAX package's TPU
    shapes (config 11's model, batch 8 a dp rank, seq 2048, 10 steps), the
    CPU its CPU shapes; ``cfg``, ``seq`` and ``batch_per_dp`` replace them.
    ``reduced`` lists every cut or replacement. Nothing is caught: a failing
    point fails the config. Returns the rows."""
    import os

    from tpuscratch_torch.bench.train_bench import (bench_train, default_train_setup,
                                                    train_flops_per_token)
    from tpuscratch_torch.models.transformer import (TransformerConfig, init_params,
                                                     stack_layers)
    from tpuscratch_torch.models.zero import (init_plan_zero_state, init_zero_adam_state,
                                              train_step_plan, train_step_zero)
    from tpuscratch_torch.parallel.plan import ShardingPlan
    from tpuscratch_torch.runtime.mesh import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        jcfg, jbatch, jseq, _ = default_train_setup(True)
        full_steps = 10
    else:
        jcfg = TransformerConfig(d_model=512, n_heads=4, n_experts=2, d_ff=1024, n_layers=2,
                                 capacity_factor=2.0)
        jseq, jbatch, full_steps = 64, 4, 3
    cfg = jcfg if cfg is None else cfg
    seq = jseq if seq is None else seq
    batch_per_dp = jbatch if batch_per_dp is None else batch_per_dp
    steps = full_steps if steps is None else steps
    def model(c):
        return f"d_model {c.d_model} d_ff {c.d_ff} L{c.n_layers} e{c.n_experts} {c.attn_impl}"

    reduced = [f"{name} {got} (JAX row: {want})" for name, got, want in
               (("steps", steps, full_steps), ("iters", iters, 2),
                ("model", model(cfg), model(jcfg)), ("seq", seq, jseq),
                ("batch a dp rank", batch_per_dp, jbatch)) if got != want]
    peak = float(os.environ.get("TPUSCRATCH_PEAK_FLOPS", "0"))
    fpt = train_flops_per_token(cfg, seq)
    fence = "readback" if on_card else "block"
    rows = []
    for pp in (1, 2):
        for dpn in (1, 2):
            mesh = make_mesh((dpn, 1, pp), ("dp", "sp", "pp"), dev)
            n_micro = 2 if pp > 1 else 1
            batch = dpn * batch_per_dp
            params = init_params(0, cfg, dev)
            x = torch.zeros(batch, seq, cfg.d_model, device=dev)
            row = {"pp": pp, "n_micro": n_micro}
            for ov in (False, True):
                tag = "overlap" if ov else "serial"
                plan = ShardingPlan(mesh, pp="pp", n_micro=n_micro, overlap=ov)
                if plan.pipelined:
                    st = stack_layers(params)
                    wb = _sync_bytes(train_step_plan(plan, cfg), st, init_plan_zero_state(st, plan),
                                     x, x)
                    del st
                else:
                    wb = _sync_bytes(train_step_zero(mesh, cfg, overlap_blocks=plan.overlap_blocks),
                                     params, init_zero_adam_state(params, dpn), x, x)
                row[f"wire_bytes_{tag}"] = wb.total
                row[f"rs_ops_{tag}"] = wb.ops.get("reduce_scatter", 0)
                row[f"ag_ops_{tag}"] = wb.ops.get("all_gather", 0)
                r = bench_train(plan=plan, cfg=cfg, batch=batch, seq=seq, steps=steps,
                                iters=iters, fence=fence, optimizer="adam", zero=True)
                print(f"# {r.summary()} -> {r.items_per_s:.3e} tok/s", file=sys.stderr)
                row[f"tokens_per_s_{tag}"] = r.items_per_s
                row[f"step_s_{tag}"] = r.p50 / steps
                row[f"achieved_flops_per_s_{tag}"] = fpt * r.items_per_s
                if peak > 0:
                    row[f"achieved_fraction_{tag}"] = fpt * r.items_per_s / peak
            del params, x
            if row["wire_bytes_overlap"] != row["wire_bytes_serial"]:
                raise AssertionError(f"config 14 pp={pp} dp={dpn}: wire bytes diverged "
                                     f"{row['wire_bytes_serial']} -> {row['wire_bytes_overlap']}")
            row["overlap_speedup"] = row["tokens_per_s_overlap"] / row["tokens_per_s_serial"]
            rows.append(_emit(
                out, mesh, config=14, metric=f"plan_overlap_pp{pp}_dp{dpn}_tokens_per_s",
                value=row["tokens_per_s_overlap"],
                detail=(f"overlap {row['overlap_speedup']:.2f}x serial; wire bytes EQUAL "
                        f"({row['rs_ops_serial']}+{row['ag_ops_serial']} -> "
                        f"{row['rs_ops_overlap']}+{row['ag_ops_overlap']} RS+AG calls); "
                        f"achieved FLOP/s = train_flops_per_token {fpt:.4g} x tokens/s"),
                **row, reduced=reduced))
    return rows


def config16_elastic_goodput(out: list, device=None, train_steps: int = 20,
                             halo_grid: int = 1024, solver_tile: int = 32) -> dict:
    """Elastic fault tolerance under chaos: a preempt-and-restart run of
    each chunked workload (trainer, halo driver, solver runner), once with
    blocking saves and once with async checkpointing, each accounted by
    ``obs.goodput`` from its own JSONL stream with ``GoodputReport.check``
    called live (the buckets must sum to the wall exactly). One row per
    workload: the checkpoint and restart badput shares, the goodput
    fraction, the walls, the overlapped background write seconds and the
    device seconds of the async snapshots' copies (the compute stream
    waits for them, so they land in the chunks, not in the checkpoint
    bucket). The
    JAX harness's sizes and fault positions on 4 stacked ranks:
    the trainer at d_model 256, 2 layers, Adam, ``train_steps`` steps, a
    save every 2, preempted at 10; the halo driver at ``halo_grid``^2, 40
    steps, a save every 5, preempted at 20; the solver at
    ``solver_tile``^3 a rank on (2, 2, 1), tol 1e-7, 4 cycles a chunk,
    preempted at cycle 8. Unlike the JAX harness, a failing workload
    raises. Returns ``{workload: {"row": ..., "reports": {mode:
    GoodputReport}}}``."""
    import shutil
    import tempfile

    import numpy as np

    from tpuscratch_torch.ft.chaos import ChaosPlan, Fault
    from tpuscratch_torch.ft.supervisor import RestartBudget, supervise, supervise_train
    from tpuscratch_torch.halo.driver import checkpointed_stencil
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.obs.goodput import goodput_report
    from tpuscratch_torch.obs.report import load_events
    from tpuscratch_torch.obs.sink import Sink
    from tpuscratch_torch.solvers.runner import checkpointed_mg3d_solve, supervised_mg3d_solve

    budget = RestartBudget(max_restarts=3, backoff_s=0.05, max_backoff_s=0.2)
    rng = np.random.default_rng(0)
    tmesh = make_mesh((4, 1), ("dp", "sp"), device)

    def run_train(ck, sink, async_on):
        # big enough that serialization is the cost: ~16 MB params+moments
        cfg = TransformerConfig(d_model=256, n_heads=2, n_experts=4, d_ff=512,
                                n_layers=2, capacity_factor=2.0)
        chaos = ChaosPlan(0, [Fault("train/preempt", at=(10,), kind="preempt")])
        supervise_train(tmesh, cfg, train_steps, ck, budget=budget, sink=sink, obs=sink,
                        chaos=chaos, save_every=2, batch=8, seq=32,
                        optimizer="adam", async_ckpt=async_on)

    hmesh = make_mesh_2d((2, 2), tmesh.device)
    world = rng.standard_normal((halo_grid, halo_grid)).astype(np.float32)

    def run_halo(ck, sink, async_on):
        chaos = ChaosPlan(0, [Fault("halo/preempt", at=(20,), kind="preempt")])
        supervise(lambda: checkpointed_stencil(world, 40, ck, save_every=5, mesh=hmesh,
                                               sink=sink, chaos=chaos, async_ckpt=async_on),
                  budget=budget, sink=sink)

    dims = (2, 2, 1)
    b = rng.standard_normal(tuple(d * solver_tile for d in dims)).astype(np.float32)
    b -= b.mean()
    solve_kw = dict(mesh=make_mesh(dims, ("z", "row", "col"), tmesh.device), tol=1e-7,
                    max_cycles=24, chunk_cycles=4)

    def run_solver(ck, sink, async_on):
        chaos = ChaosPlan(0, [Fault("solver/preempt", at=(8,), kind="preempt")])
        supervised_mg3d_solve(b, ck, sink=sink, chaos=chaos, budget=budget,
                              async_ckpt=async_on, **solve_kw)

    # a solve before any mode's sink exists, as the JAX harness warms its
    # compiled program: one-time set-up must not land in the first mode
    warm = tempfile.mkdtemp(prefix="tpuscratch_c16_warm_")
    try:
        checkpointed_mg3d_solve(b, f"{warm}/ck", **solve_kw)
    finally:
        shutil.rmtree(warm, ignore_errors=True)

    def share(rep, bucket):
        return rep.buckets.get(bucket, 0.0) / rep.wall_s if rep.wall_s else 0.0

    results = {}
    for name, body in (("train", run_train), ("halo", run_halo), ("solver", run_solver)):
        reports, write_s, copy_s = {}, 0.0, 0.0
        for mode, async_on in (("blocking", False), ("async", True)):
            wd = tempfile.mkdtemp(prefix=f"tpuscratch_c16_{name}_")
            try:
                path = f"{wd}/obs.jsonl"
                sink = Sink(path, run={"bench": f"record/config16/{name}", "mode": mode,
                                       "platform": tmesh.device.type})
                body(f"{wd}/ck", sink, async_on)
                sink.close()
                events = load_events([path])
                rep = goodput_report(events)
                rep.check()  # buckets sum to wall EXACTLY, or raise
                reports[mode] = rep
                if async_on:
                    # the overlapped background write wall: not badput (it
                    # ran beside the loop), shown for scale
                    writes = [e for e in events if e.get("event") == "ckpt/write"]
                    write_s = sum(e.get("wall_s", 0.0) for e in writes)
                    # the snapshot copies' device time, which the compute
                    # stream waits for: it lands in the chunks after each
                    # snapshot, not in the checkpoint bucket
                    copy_s = sum(e.get("copy_device_s", 0.0) for e in writes)
            finally:
                shutil.rmtree(wd, ignore_errors=True)
        blk, asy = reports["blocking"], reports["async"]
        row = {
            "checkpoint_share_blocking": share(blk, "checkpoint"),
            "checkpoint_share_async": share(asy, "checkpoint"),
            "restart_share_blocking": share(blk, "restart"),
            "restart_share_async": share(asy, "restart"),
            "goodput_fraction_blocking": blk.goodput_fraction,
            "goodput_fraction_async": asy.goodput_fraction,
            "wall_s_blocking": blk.wall_s,
            "wall_s_async": asy.wall_s,
            "overlapped_write_s": write_s,
            "copy_device_s_async": copy_s,
        }
        _emit(out, tmesh, config=16, metric=f"elastic_goodput_{name}",
              value=row["goodput_fraction_async"], **row,
              detail=(f"checkpoint badput share {100 * row['checkpoint_share_blocking']:.1f}% "
                      f"-> {100 * row['checkpoint_share_async']:.1f}% (blocking -> async), "
                      f"goodput {100 * row['goodput_fraction_blocking']:.1f}% -> "
                      f"{100 * row['goodput_fraction_async']:.1f}%, one injected preemption "
                      f"+ supervised restart, buckets sum-checked; 4 ranks stacked"))
        results[name] = {"row": row, "reports": reports}
    return results


def config5_weak_scaling(out: list, per_chip: int = 1024, iters: int = 3, steps: int = 10,
                         device=None) -> list:
    """Weak scaling: a ``per_chip``^2 tile a rank, ``steps`` steps of the
    ``xla`` impl, on 1, 2, 4, 8 and 16 ranks stacked on the card, through
    ``bench.weak_scaling``. The JAX harness refuses fewer than 2 devices;
    stacked ranks need none. The row: the per-rank rate at the largest
    mesh over the 1-rank rate, each point's efficiency and its analytic
    halo bytes a cell. Returns the points."""
    from tpuscratch_torch.bench.weak_scaling import (
        DEVICE_COUNTS,
        bench_weak_scaling,
        efficiency,
        report,
    )

    pts = bench_weak_scaling(per_chip=(per_chip, per_chip), steps=steps, iters=iters,
                             device=device)
    print(f"# {report(pts)}", file=sys.stderr)
    eff = efficiency(pts)
    mesh = make_mesh_2d(device=device)
    _emit(out, mesh, config=5, metric="weak_scaling_efficiency", value=eff[DEVICE_COUNTS[-1]],
          per_chip_tile=per_chip, points={str(n): e for n, e in eff.items()},
          halo_bytes_per_cell={str(p.n_devices): p.comm_ratio for p in pts},
          detail=(f"per-chip rate at N vs N=1, tile {per_chip}^2 x{steps} steps; "
                  f"{_where(mesh)}, ranks stacked, no link"))
    return pts


def config15_solver(out: list, iters: int = 2, per_chip: int = 32, n2: int = 256,
                    device=None) -> dict:
    """Solver weak scaling and the communication-avoiding ablation, the
    JAX harness's three row families at its chip sizes, the ranks stacked
    on the card:

    - ``solver_weak_mg3d_<n>dev``: ``per_chip``^3 a rank on 1x1x1,
      2x1x1, 2x2x1 and 2x2x2 through ``checkpointed_mg3d_solve`` (64
      cycles a chunk, tol 1e-6):
      cells/s, V-cycles, the analytic ``comm_ratio`` (halo bytes a
      computed cell a sweep, ``halo3d_traffic_per_chip``) and the per-rank
      efficiency against the 1-rank point.
    - ``solver_ca_smoothing``: damped Jacobi at s_step 1 against 2 on the
      largest mesh — cells/s, cycles, and the ledger's
      ``collective-permute`` count and bytes a sweep (s 1: one sweep's
      program; s 2: 16 sweeps, 8 state exchanges and one rhs fill).
    - ``solver_ca_cg``: classic against pipelined CG at ``n2``^2 on 2x2,
      tol 1e-5: seconds to tolerance, iterations, and the ledger's
      all-reduces: ``psums_total`` counts one init plus one loop body (a
      run with ``max_iters=1``), the JAX program's static count (3 and
      2); ``psums_per_iter`` is that less the init.

    Each solve is timed ``iters`` times (best kept). Unlike the JAX
    harness, a failing point raises. Returns ``{metric: row}``."""
    import shutil
    import tempfile
    import time

    import numpy as np

    from tpuscratch_torch.bench.weak_scaling import halo3d_traffic_per_chip
    from tpuscratch_torch.halo.driver import _setup, decompose
    from tpuscratch_torch.halo.halo3d import HaloSpec3D, TileLayout3D
    from tpuscratch_torch.halo.layout import TileLayout
    from tpuscratch_torch.obs import ledger as obs_ledger
    from tpuscratch_torch.runtime.mesh import topology_of
    from tpuscratch_torch.runtime.topology import factor2d
    from tpuscratch_torch.solvers.cg import _poisson_program, poisson_solve
    from tpuscratch_torch.solvers.multigrid3d import jacobi_smooth3, jacobi_smooth3_deep
    from tpuscratch_torch.solvers.runner import checkpointed_mg3d_solve

    tol, cg_tol, sweeps = 1e-6, 1e-5, 16
    rng = np.random.default_rng(0)
    rows = {}

    def solve_timed(b, mesh, **kw):
        best = None
        for _ in range(iters):
            wd = tempfile.mkdtemp(prefix="tpuscratch_c15_")
            try:
                t0 = time.perf_counter()
                _, rep = checkpointed_mg3d_solve(b, f"{wd}/ck", mesh=mesh, tol=tol,
                                                 chunk_cycles=64, **kw)
                wall = time.perf_counter() - t0
            finally:
                shutil.rmtree(wd, ignore_errors=True)
            if best is None or wall < best[0]:
                best = (wall, rep)
        return best

    # --- weak scaling through the checkpointed runner ------------------
    points = []
    for dims in ((1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2)):
        world = tuple(d * per_chip for d in dims)
        b = rng.standard_normal(world).astype(np.float32)
        b -= b.mean()
        mesh = make_mesh(dims, ("z", "row", "col"), device)
        wall, rep = solve_timed(b, mesh)
        cells = float(np.prod(world))
        halo_b, cells_chip = halo3d_traffic_per_chip(dims, (per_chip,) * 3)
        points.append({"dims": dims, "n": math.prod(dims), "rate": cells * rep.cycles / wall,
                       "cycles": rep.cycles, "comm_ratio": halo_b / cells_chip, "wall": wall,
                       "mesh": mesh})
    base_rate = points[0]["rate"] / points[0]["n"]
    for p in points:
        d = p["dims"]
        rows[f"solver_weak_mg3d_{p['n']}dev"] = _emit(
            out, p["mesh"], config=15, metric=f"solver_weak_mg3d_{p['n']}dev",
            value=p["rate"], cells_per_s=p["rate"], cycles=p["cycles"],
            comm_ratio=p["comm_ratio"], efficiency=p["rate"] / p["n"] / base_rate,
            solve_s=p["wall"], n_devices=p["n"],
            detail=(f"{d[0]}x{d[1]}x{d[2]} mesh, {per_chip}^3/chip, {p['cycles']} cycles, "
                    f"{p['comm_ratio']:.3f} B/cell analytic; ranks stacked"))

    # --- CA smoothing ablation on the largest mesh ---------------------
    big = points[-1]
    dims, mesh = big["dims"], big["mesh"]
    world = tuple(d * per_chip for d in dims)
    b = rng.standard_normal(world).astype(np.float32)
    b -= b.mean()
    cells = float(np.prod(world))
    spec15 = HaloSpec3D(layout=TileLayout3D((per_chip,) * 3, (1, 1, 1)),
                        topology=topology_of(mesh, periodic=True),
                        axes=tuple(mesh.axis_names), neighbors=6)
    smooth_arg = torch.zeros(dims + (per_chip,) * 3, dtype=torch.float32, device=mesh.device)

    def smoother_ledger(fn, sweeps_in_program):
        # the program runs once: its ops are the dynamic count of
        # sweeps_in_program sweeps, normalized to one sweep
        led = obs_ledger.analyze(fn, smooth_arg, smooth_arg)
        return (led.count("collective-permute") / sweeps_in_program,
                led.wire_bytes().get("collective-permute", 0.0) / sweeps_in_program)

    row = {}
    for s_step in (1, 2):
        wall, rep = solve_timed(b, mesh, s_step=s_step, smoother="jacobi")
        tag = f"s{s_step}"
        row[f"cells_per_s_{tag}"] = cells * rep.cycles / wall
        row[f"cycles_{tag}"] = rep.cycles
        row[f"solve_s_{tag}"] = wall
        if s_step == 1:
            ppermutes, wire = smoother_ledger(
                lambda u, f: jacobi_smooth3(u, f, spec15, 6 / 7, 1), 1)
        else:
            ppermutes, wire = smoother_ledger(
                lambda u, f: jacobi_smooth3_deep(u, f, spec15, 6 / 7, sweeps, s_step), sweeps)
        row[f"ppermutes_per_sweep_{tag}"] = ppermutes
        row[f"halo_bytes_per_sweep_{tag}"] = wire
    row["deep_speedup"] = row["cells_per_s_s2"] / row["cells_per_s_s1"]
    rows["solver_ca_smoothing"] = _emit(
        out, mesh, config=15, metric="solver_ca_smoothing", value=row["deep_speedup"], **row,
        detail=(f"s-step smoothing {row['deep_speedup']:.3f}x cells/s, ppermutes/sweep "
                f"{row['ppermutes_per_sweep_s1']:.0f} -> {row['ppermutes_per_sweep_s2']:.4g} "
                f"(ledger), cycles {row['cycles_s1']} == {row['cycles_s2']}"))

    # --- CG ablation: classic vs pipelined ------------------------------
    b2 = rng.standard_normal((n2, n2)).astype(np.float32)
    mesh2 = make_mesh_2d(factor2d(4), device)
    mesh_s, topo_s, layout_s, spec_s = _setup((n2, n2), mesh2, (1, 1), periodic=False,
                                              neighbors=4)
    flat = TileLayout(layout_s.core_h, layout_s.core_w, 0, 0)
    b2_tiles = torch.from_numpy(decompose(b2, topo_s, flat)).to(mesh_s.device)
    cg_row = {}
    for method in ("cg", "pipelined"):
        poisson_solve(b2, mesh2, tol=cg_tol, max_iters=4 * n2, method=method)  # warm
        best = math.inf
        for _ in range(iters):
            t0 = time.perf_counter()
            _, k, _ = poisson_solve(b2, mesh2, tol=cg_tol, max_iters=4 * n2, method=method)
            best = min(best, time.perf_counter() - t0)
        tag = "classic" if method == "cg" else "pipelined"
        cg_row[f"solve_s_{tag}"] = best
        cg_row[f"iterations_{tag}"] = int(k)
        # one init plus ONE loop body: the JAX program's static count
        led = obs_ledger.analyze(_poisson_program(mesh_s, spec_s, cg_tol, 1, method), b2_tiles)
        cg_row[f"psums_total_{tag}"] = led.count("all-reduce")
        cg_row[f"psums_per_iter_{tag}"] = led.count("all-reduce") - 1
    cg_row["pipelined_speedup"] = cg_row["solve_s_classic"] / cg_row["solve_s_pipelined"]
    rows["solver_ca_cg"] = _emit(
        out, mesh2, config=15, metric="solver_ca_cg", value=cg_row["psums_per_iter_pipelined"],
        **cg_row,
        detail=(f"psums/iter {cg_row['psums_per_iter_classic']} -> "
                f"{cg_row['psums_per_iter_pipelined']} (ledger), iters "
                f"{cg_row['iterations_classic']} -> {cg_row['iterations_pipelined']}, "
                f"time-to-tol {cg_row['pipelined_speedup']:.3f}x; {_where(mesh2)}, 4 ranks "
                f"stacked: an allreduce is a sum over a tensor's leading dims, no link"))
    return rows


def config18_cosched(out: list, device=None, steps: int = 16, d_model: int = 128,
                     solver_tile: int = 32, max_cycles: int = 24) -> dict:
    """Mesh co-scheduling: a training run and an MG3D solve time-slicing
    ONE card under ``runtime.scheduler.MeshScheduler``'s goodput-share
    policy (targets 0.7 / 0.3), against the same two jobs run
    back-to-back solo. The JAX harness's sizes on 4 stacked ranks: the
    trainer at ``d_model`` 128, 2 heads, 4 experts, d_ff 2 x d_model, 2
    layers, Adam, batch 8 x 32, ``steps`` steps, a save every 2; the
    solver at ``solver_tile``^3 a rank on (2, 2, 1),
    tol 1e-7, ``max_cycles`` cycles at most, 4 a chunk. Both programs run
    once before the accounted arms. The co-scheduled results must be
    bit-identical to solo, and ``by_workload(...).check()`` must hold
    for both arms, or it raises. Returns ``{"row": ..., "solo": (train
    result, solve result), "cosched": (...)}``."""
    import shutil
    import tempfile

    import numpy as np

    from tpuscratch_torch.models.trainer import train_program
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.obs.goodput import by_workload
    from tpuscratch_torch.obs.report import load_events
    from tpuscratch_torch.obs.sink import Sink
    from tpuscratch_torch.runtime.checkpoint import tree_flatten
    from tpuscratch_torch.runtime.scheduler import GoodputShare, MeshScheduler
    from tpuscratch_torch.solvers.runner import mg3d_solve_program

    n = 4
    rng = np.random.default_rng(0)
    mesh = make_mesh((n, 1), ("dp", "sp"), device)
    cfg = TransformerConfig(d_model=d_model, n_heads=2, n_experts=n, d_ff=2 * d_model,
                            n_layers=2)
    sdims = (2, 2, 1)
    b = rng.standard_normal(tuple(d * solver_tile for d in sdims)).astype(np.float32)
    b -= b.mean()
    smesh = make_mesh(sdims, ("z", "row", "col"), mesh.device)
    solve_kw = dict(mesh=smesh, tol=1e-7, max_cycles=max_cycles, chunk_cycles=4)
    targets = {"train": 0.7, "solver": 0.3}

    def tprog(ck, sink):
        return train_program(mesh, cfg, steps, ck, save_every=2, batch=2 * n, seq=32,
                             optimizer="adam", obs=sink)

    def sprog(ck, sink):
        return mg3d_solve_program(b, ck, sink=sink, **solve_kw)

    # both programs once OUTSIDE any accounting window, as the JAX harness
    # warms its compiled programs: one-time set-up must not land in an arm
    wwd = tempfile.mkdtemp(prefix="tpuscratch_c18_warm_")
    try:
        tprog(f"{wwd}/t", None).run()
        sprog(f"{wwd}/s", None).run()
    finally:
        shutil.rmtree(wwd, ignore_errors=True)

    arms = {}
    for mode in ("solo", "cosched"):
        wd = tempfile.mkdtemp(prefix=f"tpuscratch_c18_{mode}_")
        try:
            path = f"{wd}/obs.jsonl"
            sink = Sink(path, run={"bench": f"record/config18/{mode}",
                                   "platform": mesh.device.type})
            sched_ev = None
            if mode == "solo":
                r_train = tprog(f"{wd}/ckt", sink).run()
                r_solve = sprog(f"{wd}/cks", sink).run()
            else:
                sched = MeshScheduler(policy=GoodputShare(targets), sink=sink)
                sched.add(tprog(f"{wd}/ckt", sink))
                sched.add(sprog(f"{wd}/cks", sink))
                res = sched.run()
                r_train, r_solve = res["train"], res["solver"]
            sink.close()
            events = load_events([path])
            wg = by_workload(events, targets=targets)
            wg.check()  # both partition invariants, live, or raise
            if mode == "cosched":
                sched_ev = next(e for e in events if e.get("event") == "sched/run")
            arms[mode] = (r_train, r_solve, wg, sched_ev)
        finally:
            shutil.rmtree(wd, ignore_errors=True)

    (p_solo, rep_solo), (x_solo, _), wg_solo, _ = arms["solo"]
    (p_co, rep_co), (x_co, srep_co), wg_co, sched_ev = arms["cosched"]
    la, lb = tree_flatten(p_solo)[0], tree_flatten(p_co)[0]
    same_params = len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    if not (same_params and rep_solo.losses == rep_co.losses and np.array_equal(x_solo, x_co)):
        raise RuntimeError("co-scheduled results differ from solo — the chunk-boundary "
                           "preemption contract is broken")

    def agg_goodput(wg):
        step = sum(r.buckets.get("step", 0.0) for r in wg.reports.values())
        return step / wg.wall_s if wg.wall_s else 0.0

    shares = wg_co.shares
    share_err = max(abs(shares[k] - targets[k]) for k in targets)
    switches = int(sched_ev.get("switches") or 0)
    switch_s = float(sched_ev.get("overhead_s") or 0.0) / max(switches, 1)
    row = {
        "goodput_fraction_cosched": agg_goodput(wg_co),
        "goodput_fraction_solo": agg_goodput(wg_solo),
        "share_train": shares.get("train", 0.0),
        "share_solver": shares.get("solver", 0.0),
        "target_train": targets["train"],
        "target_solver": targets["solver"],
        "share_err": share_err,
        "switches": switches,
        "switch_s": switch_s,
        "wall_s_cosched": wg_co.wall_s,
        "wall_s_solo": wg_solo.wall_s,
        "solver_cycles": srep_co.cycles,
    }
    _emit(out, mesh, config=18, metric="cosched_goodput_train_solver",
          value=row["goodput_fraction_cosched"], **row,
          detail=(f"train+solver on one card, GoodputShare targets "
                  f"{targets['train']:.0%}/{targets['solver']:.0%}, achieved "
                  f"{row['share_train']:.1%}/{row['share_solver']:.1%} (err {share_err:.1%}), "
                  f"{switches} switches at {1e3 * switch_s:.2f} ms/switch, results "
                  f"bit-identical to solo, both partition checks live; 4 ranks stacked"))
    return {"row": row, "solo": (arms["solo"][0], arms["solo"][1]),
            "cosched": (arms["cosched"][0], arms["cosched"][1])}


CONFIGS = {2: config2_dot, 3: config3_pingpong, 4: config4_stencil_mesh,
           5: config5_weak_scaling, 6: config6_flash_attention, 8: config8_dft,
           9: config9_stencil3d, 10: config10_dma_halo,
           11: config11_train, 12: config12_decode, 13: config13_zero_train,
           14: config14_plan_overlap, 15: config15_solver, 16: config16_elastic_goodput,
           18: config18_cosched}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="2,3,4,5,6,8,9,10,11,12,13,14,15,16,18",
                    help="comma-separated config numbers")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="append this run's rows to PATH, one JSON object a line")
    ap.add_argument("--check", default=None, metavar="BASE.json",
                    help="after measuring, diff this run's rows against BASE.json through "
                         "tpuscratch_torch.obs.regress; a regression beyond the noise band "
                         "makes the exit code nonzero")
    ap.add_argument("--noise", type=float, default=0.1,
                    help="fractional noise band for --check (default 0.1)")
    args = ap.parse_args(argv)
    out: list = []
    for c in (int(s) for s in args.configs.split(",")):
        if c not in CONFIGS:
            raise SystemExit(f"config {c} is not ported (have {sorted(CONFIGS)})")
        CONFIGS[c](out)
    if args.json:
        with open(args.json, "a") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
    rc = 0
    if args.check:
        from tpuscratch_torch.obs.regress import (
            compare,
            format_findings,
            has_regression,
            index_rows,
            load_rows,
        )

        findings = compare(load_rows(args.check), index_rows(out), noise=args.noise)
        print(format_findings(findings, args.noise), file=sys.stderr)
        rc = 1 if has_regression(findings) else 0
    return rc


if __name__ == "__main__":
    sys.exit(main())
