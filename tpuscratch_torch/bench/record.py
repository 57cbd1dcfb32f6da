"""BASELINE configs 2, 3, 4, 6, 9, 10, 11 and 12 on the card.

``python -m tpuscratch_torch.bench.record [--configs 2,3,4,6,9,10,11,12]``
prints one JSON line per metric, with the JAX package's metric names
(``tpuscratch.bench.record``): config 2 the dot product, 3 pingpong, 4 the
2D stencil on a 4x4 mesh at 8192^2, 6 flash attention at S 4096, 9 the 3D
7-point stencil at 256x512x512, 10 the DMA-halo stencil at 1024^2, 11 the
composed train step (the 4-layer MoE transformer at d_model 1024, batch 8,
seq 2048), 12 serving decode (the same model behind the
continuous-batching engine).
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


def config11_train(out: list, iters: int = 3, device=None) -> list:
    """Composed-training throughput: tokens/s of the full dp x sp train
    step (ring attention through the flash kernels, expert MoE, gradients,
    SGD), f32 and bf16, on a 1x1 mesh, with the FLOP estimate; the card
    takes the JAX package's TPU shapes (the 4-layer model at d_model 1024,
    batch 8, seq 2048, 20 steps), the CPU its CPU shapes. A failing dtype
    fails the config. The pipelined row waits for ROADMAP A13d. Returns the
    two results."""
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
    return results


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


CONFIGS = {2: config2_dot, 3: config3_pingpong, 4: config4_stencil_mesh,
           6: config6_flash_attention, 9: config9_stencil3d, 10: config10_dma_halo,
           11: config11_train, 12: config12_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="2,3,4,6,9,10,11,12",
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
