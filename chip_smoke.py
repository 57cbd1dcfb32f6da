#!/usr/bin/env python3
"""Start-up proof of ``tpuscratch_torch`` on one CUDA card.

``python3 chip_smoke.py`` (no arguments, one card) builds the hand-written
kernels from ``tpuscratch_torch/csrc/`` with nvcc for sm_90a and runs:

1. card and toolchain: the card's name and power limit, nvcc, torch,
   whether ``import triton`` works, and the kernels' build;
2. every kernel against its plain torch version on the card, at a ragged
   small shape, at the 1024^2 headline shape and at the 8192^2 world
   (``resident`` at the largest grid its L2 rule admits, and its refusal
   past that), plus each kernel's time beside its bound;
3. the main path: ``distributed_stencil`` on a 1x1 mesh at 1024^2 for every
   impl of ``bench.py``'s ladder plus ``pallas`` and ``blocked``, each held
   against the ``xla`` impl, which is held against a float64 numpy oracle;
   the kernels' launch counts are zeroed just before and read just after;
4. the headline race (``bench.py``'s JSON line, measured on this card) and
   every impl's cell-updates/s at 1024^2 and 8192^2;
5. the dot-product and fill kernels against their plain versions: a
   ragged 3000-vector, bf16 operands, an 8-rank stacked batch, 1e8 f32
   with a loop-carried offset, ``fill`` at 1e8 f32 and at 37x53 in every
   dtype, ``iota2d`` at 37x53 and 8192^2 (bit-equal); each kernel's time
   beside its bound and its one-call library time;
6. the dot path: BASELINE config 2 (``bench.record.config2_dot``) at 1e8
   f32 on a 1-rank mesh -- call latency, the race of ``full`` /
   ``partials`` / ``xla``, the winner re-measured for about a second --
   with no method above 105% of 3.35 TB/s, and ``iota2d`` through its
   entry point; the launch counts are zeroed just before and read just
   after;
7. pingpong: the echo check and config 3's sweep, 8 B - 128 MiB, on a
   2-rank mesh stacked on the card, and pinned vs pageable host staging
   at 1 MiB and 128 MiB;
8. the streamed and DMA-halo kernels against their plain versions: a 2x3
   stacked mesh of ragged 37x53 tiles, 5- and 9-point coefficients,
   depths 1, 3 and 8 with step counts that leave a remainder, the
   streamed kernel in wrap mode on 1x1 and in ghost mode on 2x2, periodic
   and open, and the full shapes (8192^2 on 4x4, 1024^2 on 1x1); each
   kernel's time beside its bound, its plain time and a convolution's;
9. their path: ``distributed_stencil`` with ``stream:16``, ``dma``,
   ``dma-deep:8`` and ``dma-hbm`` at 1024^2 on 1x1 and 8192^2 on a 4x4
   mesh stacked on the card, each held against ``xla``; the launch counts
   are zeroed just before and read just after;
10. BASELINE configs 4 (8192^2 on 4x4) and 10 (the DMA halo at 1024^2)
   through ``bench.record``;
11. one ``{"kernels": [...]}`` line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA card, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerance of a kernel against its plain torch version on the same card.
# Both round every product and sum on its own in the same order (the
# kernels use __fmul_rn/__fadd_rn, which are never contracted into FMAs),
# so 0 is expected; 1e-5 would still cover a few ulps of reordering on
# unit-normal data, whose magnitude the Jacobi average only shrinks.
KERNEL_ATOL = 1e-5
# Main path: impls whose op order matches `xla` must agree bit for bit;
# `resident` uses the symmetric cn*((N+S)+(W+E)) form of the reference,
# which rounds differently: ulps per step, far below this over 64 steps.
PATH_ATOL = 1e-5
# `xla` against a float64 numpy oracle: float32 rounding over 64 steps.
ORACLE_ATOL = 1e-5
# A dot kernel against its plain version: both sum float32 products, in
# other orders (the kernels with fmaf), so a few ulps of the running sums,
# which are bounded by sum|(x+o)*y|; all-ones inputs are bit-equal (every
# partial is an integer below 2^24). Relative to sum|(x+o)*y|:
DOT_RTOL = 1e-5
# config 2: no method may beat the card's memory rate by more than 5%
DOT_MAX_GBPS = 1.05 * 3350.0
# The conv2d yardstick of deep_trapezoid against its plain version: the same
# function, but one sum of (2k+1)^2 products in cuDNN's order instead of k
# rounded steps; a wrong weight would be off by a tenth or more.
LIBRARY_ATOL = 1e-3

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
STEPS = 64                  # multiple of every ladder depth (16, 32)
SEED = 0
JACOBI = (0.25, 0.25, 0.25, 0.25, 0.0)
C9 = (0.15, 0.15, 0.1, 0.1, 0.05, 0.05, 0.08, 0.07, 0.25)  # inexact 9-point products
NINE = (0.125,) * 4 + (0.0625,) * 4 + (0.0,)               # exact 9-point products
# The 5- and 9-point paths against `xla`, per the order of their terms:
# dma, dma-deep and dma-hbm (5-point) sum in xla's order and must agree
# bit for bit; stream sums its weight grid row by row and dma-hbm puts the
# 9-point centre before the diagonals, so those are held to the JAX
# tests' tolerance, |got - want| <= 1e-6 + 1e-5 |want|.
PATH_RTOL, PATH_ATOL9 = 1e-5, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def randn(shape, gen) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite values")
    return float((a.double() - b.double()).abs().max())


def device_ms(fn, n: int = 20) -> float:
    """Device time of one ``fn()``: CUDA events around ``n`` calls queued
    behind a sleep kernel, so the host's launch cost is hidden and the
    events bracket back-to-back device work only."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning: the host queues all n calls meanwhile
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase1_card() -> dict:
    from tpuscratch_torch.ops.common import build_all, build_log, nvcc_path

    log(f"card: {smi_line()}")
    props = torch.cuda.get_device_properties(0)
    log(f"device: {torch.cuda.get_device_name(0)}, {props.multi_processor_count} SMs, "
        f"L2 {getattr(props, 'L2_cache_size', 'unknown')} B, count {torch.cuda.device_count()}")
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    try:
        import triton

        log(f"triton: {triton.__version__}")
    except ImportError as e:
        log(f"triton: not importable ({e})")
    t0 = time.perf_counter()
    libs = build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(p.name for p in libs.values())})")
    for name in libs:
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return {"nvcc": nvcc}


def phase2_kernels(gen) -> tuple[dict, list]:
    """Each kernel against its plain version; returns the per-kernel worst
    error and the timing rows."""
    from tpuscratch_torch.halo.layout import TileLayout
    from tpuscratch_torch.halo.stencil import rebuild
    from tpuscratch_torch.ops import stencil_kernel as sk

    errs = {w.__name__: 0.0 for w in sk.WRAPPERS}
    rows = []

    def check(name, got, want, what):
        err = max_err(got, want)
        log(f"  {name:26s} {what:34s} max_abs_err {err:.3e} (atol {KERNEL_ATOL:g})")
        if err > KERNEL_ATOL:
            raise AssertionError(f"{name} {what}: {err} > {KERNEL_ATOL}")
        errs[name] = max(errs[name], err)

    odd = (0.3, 0.15, 0.2, 0.25, 0.1)
    # five_point, both wrappers: ragged single tile, a stacked 2x4 batch,
    # the 1024^2 headline tile and the 8192^2 world
    for lead, (h, w), coeffs in [((), (37, 53), odd), ((2, 4), (19, 23), sk.JACOBI),
                                 ((), (1024, 1024), sk.JACOBI), ((), (8192, 8192), sk.JACOBI)]:
        lay = TileLayout(h, w, 1, 1)
        tile = randn(lead + lay.padded_shape, gen)
        want = rebuild(tile, sk.five_point_plain(tile, lay, coeffs), lay)
        for fn in (sk.five_point_pallas, sk.five_point_blocked):
            check(fn.__name__, fn(tile, lay, coeffs), want, f"{lead}+{h}x{w}")
        del tile, want
    # deep_trapezoid: ragged + partial substeps, stacked batch, a pyramid
    # deeper than one launch holds, the ladder's k=16/32 at 1024^2 and 8192^2
    for lead, (h, w), k, sub, coeffs in [
        ((), (37, 53), 4, 3, odd), ((2, 4), (19, 23), 3, 3, sk.JACOBI),
        ((), (150, 130), 70, 70, sk.JACOBI),
        ((), (1024, 1024), 16, 16, sk.JACOBI), ((), (1024, 1024), 32, 32, sk.JACOBI),
        ((), (8192, 8192), 16, 16, sk.JACOBI), ((), (8192, 8192), 32, 32, sk.JACOBI),
    ]:
        lay = TileLayout(h, w, k, k)
        tile = randn(lead + lay.padded_shape, gen)
        got = sk.deep_trapezoid_pallas(tile, lay, sub, coeffs)
        check("deep_trapezoid_pallas", got, sk.deep_trapezoid_plain(tile, lay, sub, coeffs),
              f"{lead}+{h}x{w} k={k} sub={sub}")
        del tile, got
    # resident: ragged (symmetric and general coefficients), 1024^2, and the
    # largest grid the L2 rule admits (2560^2: both buffers = 50 MiB)
    for (h, w), coeffs in [((37, 53), sk.JACOBI), ((37, 53), odd), ((1024, 1024), sk.JACOBI),
                           ((2560, 2560), sk.JACOBI)]:
        core = randn((h, w), gen)
        got = sk.resident_periodic_pallas(core, STEPS, coeffs)
        check("resident_periodic_pallas", got, sk.resident_periodic_plain(core, STEPS, coeffs),
              f"{h}x{w} steps={STEPS}{' sym' if coeffs == sk.JACOBI else ' general'}")
    for shape in ((2560, 2561), (8192, 8192)):
        try:
            sk.resident_periodic_pallas(torch.empty(shape, device="cuda"), 1)
        except ValueError:
            log(f"  resident_periodic_pallas   {shape[0]}x{shape[1]} refused, as its L2 rule says")
        else:
            raise AssertionError(f"resident accepted {shape}, past its L2 rule")

    # times beside bounds, at the main path's shapes and at 8192^2
    torch.backends.cudnn.allow_tf32 = False  # the yardstick convolutions in full f32
    conv = torch.nn.functional.conv2d
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25], [0.0, 0.25, 0.0]],
                          device="cuda").reshape(1, 1, 3, 3)
    # k valid Jacobi steps are one valid convolution with the k-fold
    # self-convolution of the cross, a (2k+1)^2 weight (built in float64)
    deep_weight = {1: weight.double()}
    for k in range(2, 33):
        deep_weight[k] = conv(deep_weight[k - 1], deep_weight[1], padding=2)
    deep_weight = {k: deep_weight[k].float() for k in (16, 32)}
    for n in (1024, 8192):
        lay = TileLayout(n, n, 1, 1)
        tile = randn(lay.padded_shape, gen)
        b, by = bound((tile.numel() + n * n) * 4, 9 * n * n)
        ms = device_ms(lambda: sk._five_point_core(tile, lay, sk.JACOBI, "time"))
        plain = device_ms(lambda: sk.five_point_plain(tile, lay))
        lib = device_ms(lambda: conv(tile[None, None], weight))
        for name in ("five_point_pallas", "five_point_blocked"):
            rows.append(dict(name=name, shape=f"{n + 2}^2 -> {n}^2", ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b, bound_by=by))
        del tile
        for k in (16, 32):
            lay = TileLayout(n, n, k, k)
            tile = randn(lay.padded_shape, gen)
            pyramid = sum((n + 2 * k - 2 * j) ** 2 for j in range(1, k + 1))
            b, by = bound((tile.numel() + n * n) * 4, 9 * pyramid)
            lib_call = lambda: conv(tile[None, None], deep_weight[k])[0, 0]  # noqa: E731
            err = max_err(lib_call(), sk.deep_trapezoid_plain(tile, lay, k))
            log(f"  library conv2d {2 * k + 1}^2 vs deep_trapezoid_plain {n}^2 k={k}: "
                f"max_abs_err {err:.3e} (atol {LIBRARY_ATOL:g})")
            if err > LIBRARY_ATOL:
                raise AssertionError(f"conv2d yardstick k={k} {n}^2: {err} > {LIBRARY_ATOL}")
            rows.append(dict(
                name="deep_trapezoid_pallas", shape=f"{n + 2 * k}^2 -> {n}^2, k={k}",
                ms=device_ms(lambda: sk.deep_trapezoid_pallas(tile, lay, k), n=10),
                plain_ms=device_ms(lambda: sk.deep_trapezoid_plain(tile, lay, k), n=3),
                library_ms=device_ms(lib_call, n=3), bound_ms=b, bound_by=by))
            del tile
    for n, steps in ((1024, 1000), (2560, 1000)):
        core = randn((n, n), gen)
        b, by = bound(2 * n * n * 4, 4 * n * n * steps)
        rows.append(dict(
            name="resident_periodic_pallas", shape=f"{n}^2, {steps} steps",
            ms=device_ms(lambda: sk.resident_periodic_pallas(core, steps), n=3),
            plain_ms=device_ms(lambda: sk.resident_periodic_plain(core, steps), n=1),
            library_ms=None, bound_ms=b, bound_by=by))
    for r in rows:
        log(f"  time {r['name']:26s} {r['shape']:28s} {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)})")
    return errs, rows


LADDER = [("xla", 1), ("deep", 16), ("deep-pallas", 16), ("deep-pallas", 32),
          ("resident", 1), ("pallas", 1), ("blocked", 1)]


def _oracle(world: np.ndarray, steps: int) -> np.ndarray:
    a = world.astype(np.float64)
    for _ in range(steps):
        a = 0.25 * (np.roll(a, 1, 0) + np.roll(a, -1, 0) + np.roll(a, 1, 1) + np.roll(a, -1, 1))
    return a


def phase3_main_path() -> dict:
    from tpuscratch_torch.halo.driver import distributed_stencil
    from tpuscratch_torch.ops import stencil_kernel as sk

    world = np.random.default_rng(SEED).standard_normal((1024, 1024)).astype(np.float32)
    sk.reset_launches()
    outs = {}
    for impl, halo in LADDER:
        label = f"{impl}:{halo}" if impl.startswith("deep") else impl
        t0 = time.perf_counter()
        outs[label] = distributed_stencil(world, STEPS, halo=(halo, halo), impl=impl)
        log(f"  {label:16s} 1024^2 x{STEPS} on 1x1: {time.perf_counter() - t0:.3f} s wall")
    counts = sk.launch_counts()
    log(f"  launches on the main path: {counts}")
    ref = outs["xla"]
    err = float(np.abs(ref.astype(np.float64) - _oracle(world, STEPS)).max())
    log(f"  xla vs float64 oracle: max_abs_err {err:.3e} (atol {ORACLE_ATOL:g})")
    if not np.isfinite(ref).all() or err > ORACLE_ATOL:
        raise AssertionError(f"xla impl disagrees with the oracle: {err}")
    for label, out in outs.items():
        err = float(np.abs(out.astype(np.float64) - ref).max())
        exact = label != "resident"
        log(f"  {label:16s} vs xla: max_abs_err {err:.3e} "
            f"({'bit-equal expected' if exact else f'atol {PATH_ATOL:g}'})")
        if out.shape != ref.shape or (err != 0.0 if exact else err > PATH_ATOL):
            raise AssertionError(f"main path impl {label} disagrees with xla: {err}")
    missing = [name for name, n in counts.items() if n < 1]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return counts


def phase4_headline() -> dict:
    from tpuscratch_torch.bench.headline import GRID, IMPLS, headline_line, race, two_phase_stencil
    from tpuscratch_torch.bench.stencil_bench import bench_stencil
    from tpuscratch_torch.runtime.mesh import make_mesh_2d

    mesh = make_mesh_2d((1, 1))
    final, winner, screen = two_phase_stencil(IMPLS, GRID, mesh, iters=3)
    line = headline_line(final)
    log(f"  headline winner {winner}: {final.summary()}")
    log(json.dumps(line))
    rates = {"1024": {i: r.items_per_s for i, r in screen.items()}}
    extra = race(("pallas", "blocked"), GRID, mesh, iters=3)
    rates["1024"].update({i: r.items_per_s for i, r in extra.items()})
    big = [i for i in IMPLS if not i.startswith("resident")] + ["pallas", "blocked"]
    rates["8192"] = {i: r.items_per_s for i, r in race(big, (8192, 8192), mesh, iters=3).items()}
    try:
        bench_stencil((8192, 8192), 8, mesh=mesh, impl="resident:8", iters=1)
    except ValueError as e:
        rates["8192"]["resident:8"] = f"refused: {e}"
    else:
        raise AssertionError("resident accepted an 8192^2 grid")
    log("rates " + json.dumps(rates))
    return rates


def _dot_check(name, got, want, x, y, offset, errs, what):
    """A dot kernel's result against its plain version, within DOT_RTOL of
    sum|(x+o)*y| (per batch entry); the error is recorded relative to it."""
    scale = ((x.double() + offset) * y.double()).abs().sum(-1)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} or non-finite")
    err = float(((got.double() - want.double()).abs() / scale).max())
    log(f"  {name:26s} {what:34s} rel_err {err:.3e} (of sum|(x+o)y|, rtol {DOT_RTOL:g})")
    if err > DOT_RTOL:
        raise AssertionError(f"{name} {what}: {err} > {DOT_RTOL}")
    errs[name] = max(errs[name], float((got.double() - want.double()).abs().max()))


def phase5_dot_fill_kernels(gen) -> tuple[dict, list]:
    """The four kernels of rows 12-13 against their plain versions, and
    their times; returns the worst absolute error per wrapper and the rows."""
    import importlib

    from tpuscratch_torch.ops import reduction as tr

    tf = importlib.import_module("tpuscratch_torch.ops.fill")  # ops.fill is the function
    names = [w.__name__ for w in tr.WRAPPERS + tf.WRAPPERS]
    errs = {n: 0.0 for n in names}
    rows = []
    kernel = {"full": (tr.dot_full_prepped, "dot_full_prepped"),
              "partials": (tr.dot_partials_prepped, "dot_partials_prepped")}

    def plain(method, x, y, chunk, off):
        if method == "full":
            return tr.dot_full_plain(x, y, off)
        return tr.dot_partials_plain(x, y, chunk, off).sum(-1)

    # ragged, bf16, 8 stacked ranks with per-rank offsets
    cases = [((), 3000, 8, torch.float32, 0.5), ((), 1 << 20, 512, torch.bfloat16, 0.0),
             ((8,), 2048, 2, torch.float32, "per-rank")]
    for lead, n, block_rows, dtype, off in cases:
        x, y = randn(lead + (n,), gen).to(dtype), randn(lead + (n,), gen).to(dtype)
        o = torch.linspace(-1, 1, 8, device="cuda") if off == "per-rank" else off
        x2, y2, _, block = tr.prep(x, y, block_rows)
        for method, (fn, name) in kernel.items():
            got = fn(x2, y2, block, offset=o)
            want = plain(method, x, y, block * 128, o)
            oo = o[..., None] if isinstance(o, torch.Tensor) else o
            _dot_check(name, got, want, x.float(), y.float(), oo, errs,
                       f"{lead}+{n} {str(dtype)[6:]} block {block}")
            ones = torch.ones_like(x)
            o2, p2, _, _ = tr.prep(ones, ones.clone(), block_rows)  # zero padding
            if not torch.equal(fn(o2, p2, block), torch.full(lead, float(n), device="cuda")):
                raise AssertionError(f"{name} {lead}+{n}: all-ones sum is not exactly {n}")
    # 1e8 f32, the offset loop-carried on the device as dot_program carries it
    n = 100_000_000
    x, y = randn((n,), gen), randn((n,), gen)
    x2, y2, _, block = tr.prep(x, y, 512)
    for method, (fn, name) in kernel.items():
        acc = torch.zeros((), device="cuda")
        for _ in range(3):
            o = acc * 1e-3  # large enough to change the result
            got = fn(x2, y2, block, offset=o)
            _dot_check(name, got, plain(method, x, y, block * 128, o), x, y, o, errs,
                       f"1e8 f32 offset {float(o):.3g}")
            acc = got
    first = tr.dot_full_prepped(x2, y2, block)
    if not all(torch.equal(tr.dot_full_prepped(x2, y2, block), first) for _ in range(3)):
        raise AssertionError("dot_full_prepped is not bit-identical across runs")
    log("  dot_full_prepped           1e8 f32: bit-identical over 4 runs")

    def bit_check(name, got, want, what):
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: not bit-equal to its plain version")
        log(f"  {name:26s} {what:34s} bit-equal")

    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64):
        value = 0.1 if dtype.is_floating_point else -7
        bit_check("fill", tf.fill((37, 53), value, dtype), tf.fill_plain((37, 53), value, dtype, "cuda"),
                  f"37x53 {str(dtype)[6:]}")
        bit_check("iota2d", tf.iota2d((37, 53), dtype), tf.iota2d_plain((37, 53), dtype, "cuda"),
                  f"37x53 {str(dtype)[6:]}")
    bit_check("fill", tf.fill((n,), 1.0), tf.fill_plain((n,), 1.0, device="cuda"), "1e8 f32")
    bit_check("iota2d", tf.iota2d((8192, 8192)), tf.iota2d_plain((8192, 8192), device="cuda"),
              "8192^2 f32")

    # times beside bounds: the main shapes (1e8, 8192^2) and a small one each
    for n, block_rows in ((100_000_000, 512), (3000, 8)):
        x, y = randn((n,), gen), randn((n,), gen)
        x2, y2, _, block = tr.prep(x, y, block_rows)
        o = torch.zeros((), device="cuda")
        b, by = bound(2 * 4 * n + 4 + 4, 3 * n)
        lib = device_ms(lambda: torch.dot(x, y))
        for method, (fn, name) in kernel.items():
            rows.append(dict(
                name=name, shape=f"{n:.0e} f32" if n > 10**6 else f"{n} f32",
                ms=device_ms(lambda: fn(x2, y2, block, offset=o)),
                plain_ms=device_ms(lambda: plain(method, x, y, block * 128, o), n=5),
                library_ms=lib, bound_ms=b, bound_by=by))
        del x, y, x2, y2
    for shape, label in (((100_000_000,), "1e8 f32"), ((37, 53), "37x53 f32")):
        b, by = bound(4 * math.prod(shape), 0)
        rows.append(dict(
            name="fill", shape=label, ms=device_ms(lambda: tf.fill(shape, 1.0)),
            plain_ms=device_ms(lambda: tf.fill_plain(shape, 1.0, device="cuda"), n=5),
            library_ms=device_ms(lambda: torch.full(shape, 1.0, device="cuda")),
            bound_ms=b, bound_by=by))
    for (h, w) in ((8192, 8192), (37, 53)):
        b, by = bound(4 * h * w, 2 * h * w)
        rows.append(dict(
            name="iota2d", shape=f"{h}x{w} f32", ms=device_ms(lambda: tf.iota2d((h, w))),
            plain_ms=device_ms(lambda: tf.iota2d_plain((h, w), device="cuda"), n=5),
            library_ms=device_ms(lambda: torch.arange(h * w, dtype=torch.float32,
                                                      device="cuda").view(h, w)),
            bound_ms=b, bound_by=by))
    for r in rows:
        log(f"  time {r['name']:26s} {r['shape']:28s} {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms)")
    return errs, rows


def phase6_dot_path() -> dict:
    """BASELINE config 2 through the port's entry points, and iota2d through
    its own; launch counts zeroed just before and read just after."""
    import importlib

    from tpuscratch_torch.bench.record import config2_dot
    from tpuscratch_torch.ops import reduction as tr

    tf = importlib.import_module("tpuscratch_torch.ops.fill")
    out: list = []
    tr.reset_launches()
    tf.reset_launches()
    res = config2_dot(out, iters=10)
    pattern = tf.iota2d((8192, 8192))  # the InitKernel test pattern of the reference
    counts = {**tr.launch_counts(), **tf.launch_counts()}
    log(f"  launches on the dot path: {counts}")
    want = torch.arange(8192 * 8192, device="cuda", dtype=torch.int64).view(8192, 8192)
    # r * 8192 is exact in f32, so r * 8192 + c rounds once, as int64 -> f32 does
    if not torch.equal(pattern, want.float()):
        raise AssertionError("iota2d 8192^2 differs from the exact linear index")
    for label, r in [("latency", res["latency"]), *res["screen"].items(), ("final", res["final"])]:
        log(f"  {label:9s} {r.summary()}")
        if r.gbps > DOT_MAX_GBPS:
            raise AssertionError(f"config 2 {label}: {r.gbps:.0f} GB/s > {DOT_MAX_GBPS:.0f}")
    log(f"  winner {res['winner']}; config 2 lines: {json.dumps(out)}")
    missing = [name for name, k in counts.items() if k < 1]
    if missing:
        raise AssertionError(f"dot path never launched {missing}")
    return counts


def phase7_pingpong() -> dict:
    from tpuscratch_torch.bench.pingpong import pinned_staging_roundtrip
    from tpuscratch_torch.bench.record import config3_pingpong

    out: list = []
    line = config3_pingpong(out, iters=10)
    if "echo PASSED" not in line["detail"]:
        raise AssertionError("pingpong echo did not pass")
    for n in (1 << 18, 1 << 25):  # 1 MiB and 128 MiB of f32
        for pinned in (True, False):
            log(f"  {pinned_staging_roundtrip(n, pinned=pinned).summary()}")
    return line


def _kfold(k: int, coeffs) -> torch.Tensor:
    """The (2k+1)^2 weight of k valid 5/9-point steps (k-fold
    self-convolution of the 3x3 stencil, in float64), for conv2d."""
    from tpuscratch_torch.ops.halo_dma import as_nine

    cn, cs, cw, ce, cnw, cne, csw, cse, cc = as_nine(coeffs)
    w3 = torch.tensor([[cnw, cn, cne], [cw, cc, ce], [csw, cs, cse]],
                      dtype=torch.float64, device="cuda").reshape(1, 1, 3, 3)
    w = w3
    for _ in range(k - 1):
        w = torch.nn.functional.conv2d(w, w3.flip(-1, -2), padding=2)
    return w.float()


def phase8_stream_dma_kernels(gen) -> tuple[dict, list]:
    """The four kernels of rows 8, 10a, 10b and 11 against their plain
    versions; returns the worst error per wrapper and the timing rows."""
    from tpuscratch_torch.ops import halo_dma as hd
    from tpuscratch_torch.ops import stencil_stream as ss

    odd = (0.3, 0.15, 0.2, 0.25, 0.1)
    errs = {w.__name__: 0.0 for w in ss.WRAPPERS + hd.WRAPPERS}
    rows = []

    def check(name, got, want, what):
        err = max_err(got, want)
        log(f"  {name:26s} {what:40s} max_abs_err {err:.3e} (atol {KERNEL_ATOL:g})")
        if err > KERNEL_ATOL:
            raise AssertionError(f"{name} {what}: {err} > {KERNEL_ATOL}")
        errs[name] = max(errs[name], err)

    def stream_inputs(lead, H, W, k, ghost, open_):
        core = randn(lead + (H, W), gen)
        top, bot = randn(lead + (k, W), gen), randn(lead + (k, W), gen)
        gl = randn(lead + (H + 2 * k, k), gen) if ghost else None
        gr = randn(lead + (H + 2 * k, k), gen) if ghost else None
        flags = (torch.randint(0, 2, lead + (4,), generator=gen, device="cuda", dtype=torch.int32)
                 if open_ else torch.zeros(lead + (4,), dtype=torch.int32, device="cuda"))
        return core, top, bot, gl, gr, flags

    # ragged: 37x53 tiles, wrap mode on 1x1, ghost mode on 2x2 and 2x3,
    # periodic and open, 5 and 9 points, depths 1, 3, 8
    for lead, ghost in (((1, 1), False), ((2, 2), True), ((2, 3), True)):
        for open_ in (False, True):
            for k in (1, 3, 8):
                for coeffs in (odd, C9):
                    core, top, bot, gl, gr, flags = stream_inputs(lead, 37, 53, k, ghost, open_)
                    got = ss.nine_point_streamed_2d(core, top, bot, (37, 53), coeffs, k,
                                                    open_flags=flags, gl=gl, gr=gr)
                    want = ss.nine_point_streamed_2d_plain(core, top, bot, coeffs, k, flags, gl, gr)
                    check("nine_point_streamed_2d", got, want,
                          f"{lead}+37x53 k={k} {'ghost' if ghost else 'wrap'}"
                          f"{' open' if open_ else ''} {len(coeffs)}pt")
    cores = randn((2, 3, 37, 53), gen)
    for steps, coeffs in ((7, odd), (8, JACOBI)):
        check("dma_ring", hd.dma_ring(cores, steps, coeffs),
              hd.dma_ring_plain(cores, steps, coeffs), f"(2, 3)+37x53 steps={steps}")
    for depth, steps in ((1, 7), (3, 7), (8, 19)):
        for coeffs in (odd, C9):
            check("dma_deep", hd.dma_deep(cores, steps, coeffs, depth),
                  hd.dma_deep_plain(cores, steps, coeffs, depth),
                  f"(2, 3)+37x53 k={depth} steps={steps} {len(coeffs)}pt")
    for coeffs in (odd, C9, NINE):
        check("dma_hbm_step", hd.dma_hbm_step(cores, coeffs), hd.dma_hbm_step_plain(cores, coeffs),
              f"(2, 3)+37x53 {len(coeffs)}pt")

    # the full shapes: 8192^2 on a 4x4 mesh (2048^2 tiles), 1024^2 on 1x1;
    # correctness, then times beside bounds (Jacobi, the main path's)
    torch.backends.cudnn.allow_tf32 = False  # the yardstick convolutions in full f32
    conv = torch.nn.functional.conv2d
    ring_steps, deep_k, stream_k = 64, 8, 16
    for lead, n in (((4, 4), 2048), ((1, 1), 1024)):
        label = f"{lead[0] * n}^2 on {lead[0]}x{lead[1]}"
        cells = lead[0] * lead[1] * n * n
        ghost = lead != (1, 1)
        core, top, bot, gl, gr, flags = stream_inputs(lead, n, n, stream_k, ghost, False)
        stream = lambda: ss.nine_point_streamed_2d(  # noqa: E731
            core, top, bot, (n, n), JACOBI, stream_k, open_flags=flags, gl=gl, gr=gr)
        stream_plain = lambda: ss.nine_point_streamed_2d_plain(  # noqa: E731
            core, top, bot, JACOBI, stream_k, flags, gl, gr)
        check("nine_point_streamed_2d", stream(), stream_plain(),
              f"{label} k={stream_k} {'ghost' if ghost else 'wrap'}")
        if ghost:
            _, o_top, o_bot, o_gl, o_gr, o_flags = stream_inputs(lead, n, n, 3, True, True)
            check("nine_point_streamed_2d",
                  ss.nine_point_streamed_2d(core, o_top, o_bot, (n, n), C9, 3, open_flags=o_flags,
                                            gl=o_gl, gr=o_gr),
                  ss.nine_point_streamed_2d_plain(core, o_top, o_bot, C9, 3, o_flags, o_gl, o_gr),
                  f"{label} k=3 ghost open 9pt")
        ext = torch.cat([top, core, bot], dim=-2)  # the extended grid the kernel reads
        ext = torch.cat([gl, ext, gr], dim=-1) if ghost else ext[
            ..., torch.arange(-stream_k, n + stream_k, device="cuda") % n]
        ext = ext.reshape(-1, 1, n + 2 * stream_k, n + 2 * stream_k).contiguous()
        w_stream = _kfold(stream_k, JACOBI)
        s_lib = lambda: conv(ext, w_stream)  # noqa: E731
        err = max_err(s_lib().reshape(core.shape), stream_plain())
        log(f"  library conv2d {2 * stream_k + 1}^2 vs stream plain {label}: max_abs_err "
            f"{err:.3e} (atol {LIBRARY_ATOL:g})")
        if err > LIBRARY_ATOL:
            raise AssertionError(f"conv2d yardstick of the stream {label}: {err} > {LIBRARY_ATOL}")
        slab = top.numel() + bot.numel() + (gl.numel() + gr.numel() if ghost else 0)
        b, by = bound((2 * cells + slab) * 4, 7 * cells * stream_k)
        rows.append(dict(name="nine_point_streamed_2d", shape=f"{label}, k={stream_k}",
                         ms=device_ms(stream, n=5), plain_ms=device_ms(stream_plain, n=1),
                         library_ms=device_ms(s_lib, n=2), bound_ms=b, bound_by=by))
        del core, top, bot, gl, gr, ext

        cores = randn(lead + (n, n), gen)
        check("dma_ring", hd.dma_ring(cores, 16, JACOBI), hd.dma_ring_plain(cores, 16, JACOBI),
              f"{label} steps=16")
        check("dma_deep", hd.dma_deep(cores, 19, JACOBI, deep_k),
              hd.dma_deep_plain(cores, 19, JACOBI, deep_k), f"{label} k={deep_k} steps=19")
        check("dma_deep", hd.dma_deep(cores, 5, NINE, 3), hd.dma_deep_plain(cores, 5, NINE, 3),
              f"{label} k=3 steps=5 9pt")
        check("dma_hbm_step", hd.dma_hbm_step(cores, JACOBI), hd.dma_hbm_step_plain(cores, JACOBI),
              f"{label} 5pt")
        check("dma_hbm_step", hd.dma_hbm_step(cores, C9), hd.dma_hbm_step_plain(cores, C9),
              f"{label} 9pt")
        world = cores.permute(0, 2, 1, 3).reshape(lead[0] * n, lead[1] * n)
        torus = {k: torch.nn.functional.pad(world[None, None], (k, k, k, k), mode="circular")
                 for k in (1, deep_k)}
        w_deep, w_one = _kfold(deep_k, JACOBI), _kfold(1, JACOBI)
        d_lib = lambda: conv(torus[deep_k], w_deep)  # noqa: E731
        h_lib = lambda: conv(torus[1], w_one)  # noqa: E731
        for lib_call, want, what in (
                (d_lib, hd.dma_deep_plain(cores, deep_k, JACOBI, deep_k), "deep"),
                (h_lib, hd.dma_hbm_step_plain(cores, JACOBI), "hbm step")):
            got = lib_call()[0, 0].reshape(lead[0], n, lead[1], n).permute(0, 2, 1, 3)
            err = max_err(got, want)
            log(f"  library conv2d vs {what} plain {label}: max_abs_err {err:.3e} "
                f"(atol {LIBRARY_ATOL:g})")
            if err > LIBRARY_ATOL:
                raise AssertionError(f"conv2d yardstick of {what} {label}: {err} > {LIBRARY_ATOL}")
        b, by = bound(2 * cells * 4, 9 * cells * ring_steps)
        rows.append(dict(name="dma_ring", shape=f"{label}, {ring_steps} steps",
                         ms=device_ms(lambda: hd.dma_ring(cores, ring_steps, JACOBI), n=3),
                         plain_ms=device_ms(
                             lambda: hd.dma_ring_plain(cores, ring_steps, JACOBI), n=1),
                         library_ms=None, bound_ms=b, bound_by=by))
        b, by = bound(2 * cells * 4, 7 * cells * deep_k)
        rows.append(dict(name="dma_deep", shape=f"{label}, k={deep_k}",
                         ms=device_ms(lambda: hd.dma_deep(cores, deep_k, JACOBI, deep_k), n=5),
                         plain_ms=device_ms(
                             lambda: hd.dma_deep_plain(cores, deep_k, JACOBI, deep_k), n=1),
                         library_ms=device_ms(d_lib, n=2), bound_ms=b, bound_by=by))
        b, by = bound(2 * cells * 4, 9 * cells)
        rows.append(dict(name="dma_hbm_step", shape=f"{label}, 1 step",
                         ms=device_ms(lambda: hd.dma_hbm_step(cores, JACOBI)),
                         plain_ms=device_ms(lambda: hd.dma_hbm_step_plain(cores, JACOBI), n=3),
                         library_ms=device_ms(h_lib, n=5), bound_ms=b, bound_by=by))
        del cores, world, torus
    for r in rows:
        log(f"  time {r['name']:26s} {r['shape']:28s} {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)})")
    return errs, rows


NEW_IMPLS = ("stream:16", "dma", "dma-deep:8", "dma-hbm")


def phase9_stream_dma_path() -> dict:
    """``distributed_stencil`` with every new impl at 1024^2 on 1x1 and
    8192^2 on 4x4, each held against ``xla``; launch counts zeroed just
    before and read just after."""
    from tpuscratch_torch.halo.driver import distributed_stencil
    from tpuscratch_torch.ops import halo_dma as hd
    from tpuscratch_torch.ops import stencil_stream as ss
    from tpuscratch_torch.runtime.mesh import make_mesh_2d

    rng = np.random.default_rng(SEED)
    cases = [((1, 1), rng.standard_normal((1024, 1024)).astype(np.float32)),
             ((4, 4), rng.standard_normal((8192, 8192)).astype(np.float32))]
    ss.reset_launches()
    hd.reset_launches()
    outs = {}
    for dims, world in cases:
        mesh = make_mesh_2d(dims)
        for impl in ("xla",) + NEW_IMPLS:
            for coeffs in (JACOBI,) + ((NINE,) if dims == (1, 1) else ()):
                t0 = time.perf_counter()
                outs[dims, impl, len(coeffs)] = distributed_stencil(
                    world, STEPS, mesh=mesh, impl=impl, coeffs=coeffs)
                log(f"  {impl:12s} {world.shape[0]}^2 x{STEPS} on {dims[0]}x{dims[1]} "
                    f"{len(coeffs)}pt: {time.perf_counter() - t0:.3f} s wall")
    counts = {**ss.launch_counts(), **hd.launch_counts()}
    log(f"  launches on the stream/dma path: {counts}")
    for (dims, impl, npt), out in outs.items():
        if impl == "xla":
            continue
        ref = outs[dims, "xla", npt]
        exact = not impl.startswith("stream") and not (impl == "dma-hbm" and npt == 9)
        err = float(np.abs(out.astype(np.float64) - ref).max())
        worst = float((np.abs(out.astype(np.float64) - ref)
                       - PATH_RTOL * np.abs(ref)).max())
        log(f"  {impl:12s} {dims[0]}x{dims[1]} {npt}pt vs xla: max_abs_err {err:.3e} "
            f"({'bit-equal expected' if exact else f'atol {PATH_ATOL9:g} + rtol {PATH_RTOL:g}'})")
        if out.shape != ref.shape or not np.isfinite(out).all() or (
                err != 0.0 if exact else worst > PATH_ATOL9):
            raise AssertionError(f"{impl} {dims} {npt}pt disagrees with xla: {err}")
    missing = [name for name, k in counts.items() if k < 1]
    if missing:
        raise AssertionError(f"the stream/dma path never launched {missing}")
    return counts


def phase10_configs() -> list:
    from tpuscratch_torch.bench.record import config4_stencil_mesh, config10_dma_halo

    out: list = []
    res4 = config4_stencil_mesh(out, iters=3)
    log(f"  config 4 winner {res4['winner']}: {res4['final'].summary()}")
    rows10 = config10_dma_halo(out, iters=3)
    for impl, r in rows10.items():
        log(f"  config 10 {impl:12s} {r.summary()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tpuscratch_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    log("== phase 1: card and toolchain")
    phase1_card()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("== phase 2: kernels against their plain versions")
    errs, rows = phase2_kernels(gen)
    log("== phase 3: main path (distributed_stencil, 1x1, 1024^2)")
    counts = phase3_main_path()
    log("== phase 4: headline and rates")
    phase4_headline()
    log("== phase 5: dot-product and fill kernels against their plain versions")
    errs2, rows2 = phase5_dot_fill_kernels(gen)
    log("== phase 6: dot path (config 2, 1-rank mesh, 1e8 f32) and iota2d")
    counts2 = phase6_dot_path()
    log("== phase 7: pingpong (config 3, 2 ranks stacked on the card) and host staging")
    phase7_pingpong()
    log("== phase 8: streamed and DMA-halo kernels against their plain versions")
    errs3, rows3 = phase8_stream_dma_kernels(gen)
    log("== phase 9: stream/dma path (distributed_stencil, 1024^2 on 1x1, 8192^2 on 4x4)")
    counts3 = phase9_stream_dma_path()
    log("== phase 10: configs 4 (8192^2 on 4x4) and 10 (DMA halo, 1024^2)")
    phase10_configs()

    from tpuscratch_torch.ops import halo_dma as hd
    from tpuscratch_torch.ops import reduction as tr
    from tpuscratch_torch.ops import stencil_kernel as sk
    from tpuscratch_torch.ops import stencil_stream as ss

    fill_mod = importlib.import_module("tpuscratch_torch.ops.fill")

    # name -> (source, TPU kernel it replaces, the main shape's row)
    table = {
        "five_point_pallas": ("stencil2d", "stencil_kernel.py:65", "1026^2"),
        "five_point_blocked": ("stencil2d", "stencil_kernel.py:658", "1026^2"),
        "deep_trapezoid_pallas": ("stencil2d", "stencil_kernel.py:136", "k=16"),
        "resident_periodic_pallas": ("stencil2d", "stencil_kernel.py:236", "1024^2"),
        "dot_partials_prepped": ("reduction", "reduction.py:132", "1e+08"),
        "dot_full_prepped": ("reduction", "reduction.py:163", "1e+08"),
        "fill": ("fill", "fill.py:27", "1e8"),
        "iota2d": ("fill", "fill.py:46", "8192x8192"),
        "nine_point_streamed_2d": ("stencil_stream2d", "stencil_stream.py:1067", "8192^2"),
        "dma_ring": ("halo_dma", "halo_dma.py:1099", "8192^2"),
        "dma_deep": ("halo_dma", "halo_dma.py:534", "8192^2"),
        "dma_hbm_step": ("halo_dma", "halo_dma.py:951", "8192^2"),
    }
    counts.update(counts2)
    counts.update(counts3)
    errs.update(errs2)
    errs.update(errs3)
    rows += rows2 + rows3
    kernels = []
    for name, (src, tpu, main_shape) in table.items():
        row = next(r for r in rows if r["name"] == name and main_shape in r["shape"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"tpuscratch_torch/csrc/{src}.cu",
            "replaces": f"tpuscratch/ops/{tpu}", "launches": counts[name], "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
        })
    wrappers = sk.WRAPPERS + tr.WRAPPERS + fill_mod.WRAPPERS + ss.WRAPPERS + hd.WRAPPERS
    if sorted(k["name"] for k in kernels) != sorted(w.__name__ for w in wrappers):
        raise AssertionError("the kernels line misses a wrapper")
    log(f"== done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
