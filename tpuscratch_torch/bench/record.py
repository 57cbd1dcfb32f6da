"""BASELINE configs 2, 3, 4, 6, 9, 10, 11, 12, 13 and 14 on the card.

``python -m tpuscratch_torch.bench.record [--configs 2,3,4,6,9,10,11,12,13,14]``
prints one JSON line per metric, with the JAX package's metric names
(``tpuscratch.bench.record``): config 2 the dot product, 3 pingpong, 4 the
2D stencil on a 4x4 mesh at 8192^2, 6 flash attention at S 4096, 9 the 3D
7-point stencil at 256x512x512, 10 the DMA-halo stencil at 1024^2, 11 the
composed train step (the 4-layer MoE transformer at d_model 1024, batch 8,
seq 2048) and its pipelined step on a 1x1x1 mesh, 12 serving decode (the
same model behind the continuous-batching engine), 13 replicated against
ZeRO-sharded training of that model at dp 1, 2 and 4 stacked on the card,
and the accumulation sweep, 14 the plan-composed ZeRO step at pp x dp in
{1, 2}^2, serial against the overlap schedule.
Each line names the device it ran on. Unlike the JAX harness, nothing is
caught: a failing method, impl or re-measure fails the run.
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


CONFIGS = {2: config2_dot, 3: config3_pingpong, 4: config4_stencil_mesh,
           6: config6_flash_attention, 9: config9_stencil3d, 10: config10_dma_halo,
           11: config11_train, 12: config12_decode, 13: config13_zero_train,
           14: config14_plan_overlap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="2,3,4,6,9,10,11,12,13,14",
                    help="comma-separated config numbers")
    args = ap.parse_args(argv)
    out: list = []
    for c in (int(s) for s in args.configs.split(",")):
        if c not in CONFIGS:
            raise SystemExit(f"config {c} is not ported (have {sorted(CONFIGS)})")
        CONFIGS[c](out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
