#!/usr/bin/env python3
"""Start-up proof of ``tpuscratch_torch`` on one CUDA card.

``python3 chip_smoke.py`` (no arguments, one card) builds the hand-written
kernels from ``tpuscratch_torch/csrc/`` with nvcc for sm_90a and runs:

1. card and toolchain: the card's name and power limit, nvcc, torch,
   whether ``import triton`` works, and the kernels' build, with no spill
   store in a tensor-core flash, paged-attention, ``dma_hbm_step``,
   ``dma_ring``, ``dma_deep``, ``stream2d``, ``stream3d``, ``five_point``,
   ``deep_trapezoid`` or ``resident_periodic`` instantiation beyond
   ``SPILL_ALLOWED``;
2. every kernel against its plain torch version on the card, at a ragged
   small shape, at the 1024^2 headline shape and at the 8192^2 world
   (``five_point`` also at halo (2, 3), an odd pitch, a batch and a base
   off 16-byte alignment, bit for bit, its input unchanged; the deep
   trapezoid bit for bit on a tile holding an inf and -0.0 cells, where a
   dropped zero term would show; ``resident`` at the largest grid its L2
   rule admits, and its refusal past that; at 64 steps and at 17, a
   remainder of its fold), plus each kernel's time beside its bound;
3. the main path: ``distributed_stencil`` on a 1x1 mesh at 1024^2 for every
   impl of ``bench.py``'s ladder plus ``pallas`` and ``blocked``, each held
   against the ``xla`` impl, which is held against a float64 numpy oracle;
   the kernels' launch counts are zeroed just before and read just after;
4. the headline race (``bench.py``'s JSON line, measured on this card) and
   every impl's cell-updates/s at 1024^2 and 8192^2;
5. the dot-product and fill kernels against their plain versions: a
   ragged 3000-vector, bf16 operands, an 8-rank stacked batch, 1e8 f32
   with a loop-carried offset, ``fill`` at 1e8 f32 and at 37x53 in every
   dtype, ``iota2d`` in every dtype at 37x53, 8192^2 and shapes whose
   width and size are not multiples of 4 (bit-equal); each kernel's time
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
   and open, and the full shapes (8192^2 on 4x4, 1024^2 on 1x1), the
   route ``dma_hbm_step`` took logged; each kernel's time beside its bound,
   its plain time and a convolution's;
9. their path: ``distributed_stencil`` with ``stream:16``, ``dma``,
   ``dma-deep:8`` and ``dma-hbm`` at 1024^2 on 1x1 and 8192^2 on a 4x4
   mesh stacked on the card, each held against ``xla``; the launch counts
   are zeroed just before and read just after;
10. BASELINE configs 4 (8192^2 on 4x4) and 10 (the DMA halo at 1024^2)
   through ``bench.record``;
11. the four 3D kernels against their plain versions: a 2x1x2 stacked
   batch of ragged 11x13x17 tiles, the one-step 7-point functions with
   Jacobi and general coefficients (the assembled one with strips, without
   them on y, on x, on both, and with its pointwise term), the streamed
   kernel at depths 1, 2, 3 and 11 (chained launches) in z-slab mode and
   with ``gy``, ``gx`` and all three strips, each open flag in turn, 27
   points and the rhs term; then each kernel at 256x512x512, its time
   beside its bound, its plain time and a ``conv3d``'s;
12. their path: ``distributed_stencil3d`` at 256x512x512 on 1x1x1 and at
   512^3 on a 2x2x2 mesh stacked on the card, 64 steps, every impl held to
   ``compact``, ``compact`` on one rank to a float64 numpy oracle and
   ``compact`` on 2x2x2 to ``compact`` on one rank, plus an open-boundary
   and a 27-point case; the launch counts are zeroed just
   before and read just after;
13. BASELINE config 9 (the 3D stencil at 256x512x512) through
   ``bench.record``;
14. the paged-attention kernels against their plain version: f32, int8 and
   fp8 pools, K = 1, 4 and 20 (past page + 1), ragged lengths, sentinel
   table entries and an idle slot, at a small ragged geometry and at config
   12's (8 heads, d_head 128, 16-token pages); K = 65 and 128 (several
   query groups), d_head 384 and a bf16 q; d_head 16384 at K = 1 and 8 on
   f32 and int8 pools (512-column units through the ring), two calls
   bit-equal; each case's load route and split count logged; then their
   time at config 12's decode shape (32 sequences of 128 cached tokens),
   warm and L2-cold (8 tables over disjoint pages of
   a 2048-page pool, rotated), and at 4 sequences of 4096 (split over the
   positions, two calls bit-equal, beside the same kernels unsplit), each
   beside its bound, its plain time and SDPA's over the pre-gathered view;
   and a planted fault the unchanged limit must catch: the split model's
   combine with one split's rescale factor dropped;
15. the serving path: ``ServeEngine`` at config 12's model (d_model 1024,
   4 layers, 4 experts) on a 1x1 mesh, 8 requests of prompt 64 and 32 new
   tokens, greedy, with the kernel and with the plain attention: equal
   tokens, and the kernel launched once per layer per decode tick (the
   count zeroed just before and read just after);
16. BASELINE config 12 (serving decode, batches 1, 8 and 32) through
   ``bench.record``, then a profile of 16 batch-32 ticks with the kernel and
   with the plain attention (kernel time by group, the device's idle share);
17. the flash-attention kernels through their four wrappers against their
   plain versions: f32 (split TF32 on the tensor cores up to D 128, the FMA
   kernels above) and bf16 (tensor-core kernels), every tensor-core kernel's
   SASS holding HGMMA instructions, causal and full, int and per-entry
   offsets (one entry fully masked), ragged S and T, D 18 and 20 (rows TMA
   cannot address) to 320 (column chunks), S = T = 1000 off the tile grid,
   the state outputs, the backward at dense and compact offsets, each call's
   route by the shape rule; the planted faults (p or ds unrounded, dv x 0.9),
   each of which the bf16 limits must catch, and one-pass TF32 products,
   which the f32 limit must catch; then each wrapper at config 6's shape (S
   4096, H 8, D 128) and config 11's attention shape (batch 8 of S 2048) in
   f32 and bf16, its time beside its bound, its plain time and SDPA's
   (forward, or its autograd backward), and at config 11 two backward calls
   a wrapper, bit-equal;
18. the training path: ``train_step`` at config 11's model (d_model 1024,
   4 layers, 4 experts, batch 8, seq 2048, f32) on a 1x1 mesh, 3 SGD steps
   each with the plain ring ("xla"), the ring through the flash kernels
   ("pallas") and Ulysses through them ("ulysses-pallas"), from the same
   weights: equal losses, and one forward and one backward launch per layer
   per step (the counts zeroed just before each kernel run, read just after);
19. BASELINE configs 6 (flash attention TFLOP/s, causal and full) and 11
   (train tokens/s, f32 and bf16) through ``bench.record``, then a profile
   of a config-11 step (kernel time by group, the device's idle share);
20. the fused Adam kernel against its plain version: lengths 1, 3, 1023,
   1025 and 3001 and a stacked (4, 3001) with four step sizes, f32 and bf16
   moments, donated and not, bit-equal; then its time at adam_bench's tree
   (253,921,280 elements, a launch a leaf) and at config 13's dp-4 shard
   beside its bound, its plain time and ``torch._fused_adam_``'s, and the
   experts' elementwise update at dp 4;
21. the ZeRO path at config 13's model: on 1x1 the elementwise and the
   fused ZeRO step against ``train_step_adam``, bit-identical over 3 steps,
   with one fused Adam launch and n_layers flash launches each way a step
   (the counts zeroed just before and read just after); on dp 2 and dp 4
   stacked, ZeRO against replicated within ZERO_TOL, a planted fault (alpha
   x 0.9) outside it, two identical microbatches against one, the overlap
   schedule against the serial one (bit-identical, a launch a block), the
   grad-sync bytes and the optimizer bytes a rank, the peak device memory;
22. BASELINE config 13 (replicated against ZeRO at dp 1, 2, 4 and the
   accumulation sweep) through ``bench.record`` with its steps cut, a
   profile of a dp-4 ZeRO step, and the adam_bench race;
23. the four copy probes against clone / x * c (bit-equal), each probe's
   marginal GB/s at 256x512x512 f32 beside ``copy_``'s, and the measured
   copy rate;
24. one ``{"kernels": [...]}`` line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Phases 25 and 26 run after 23, before 24's lines:

25. the pipelined training path at config 11's model: ``train_step_pp`` on a
   1x1x1 ("dp", "sp", "stage") mesh at n_micro 1 against ``train_step``, at
   n_micro 4 with the plain ring and with the flash kernels, 1x1x2 against
   1x1x1 at n_micro 2 (then, logged, which of a block's ops round
   otherwise with two stages in a call than with one); ``train_step_plan``
   on pp2 x dp2 stacked: ZeRO
   overlap against serial (bit-identical), ZeRO against the stacked Adam
   step and a planted fault (alpha x 0.9) outside ZERO_TOL; the flash and
   fused Adam launches of every run counted (zeroed just before, read just
   after) and held to the schedule's; the flash kernels at the tick's shape
   and the fused Adam kernel at the plan's (pp, dp)-split shards against
   their plain versions; ``ssm_block`` on 4 stacked sequence ranks against
   the local scan at T 65,536, d_model 1024, d_state 128, with the
   cross-shard carry dropped as a planted fault;
26. config 11's pp row and config 14 (the plan's ZeRO step at pp x dp in
   {1, 2}^2, serial against overlap) through ``bench.record`` with steps and
   repeats cut, and the bubble bench at M = 4, 8 and 32 on 4 stacked stages.

Phase 27 runs after 26, before 24's lines:

27. the solvers: the streamed 3D kernel against its plain version as the
   3D multigrid's ``jacobi-stream`` smoother calls it (rhs mode, depth 2,
   z-slab cores of 256^3 on 1x1x1 and 2x1x1 and of 128^3), bit-equal;
   ``poisson_solve`` (CG and pipelined CG) at 1024^2 on 1x1 and 256^2 on
   1x1 and 2x2; ``mg_poisson_solve`` and ``pcg_poisson_solve`` at 1024^2
   on 1x1 and 2x2; ``mg_poisson3d_solve`` at 256^3 with ``rbgs``,
   ``jacobi``, ``jacobi-stream`` and ``rbgs`` at s_step 2 (bit-identical to
   s_step 1), at 512x256x256
   with ``jacobi-stream`` on 2x1x1 stacked and 1x1x1, and
   ``pcg_poisson3d_solve``; the spectral solvers at 4096^2 on 1 and 4
   stacked ranks and at 256^3, both impls. Every solution is held to a
   float64 numpy residual (ORACLE_C, SPECTRAL_C; in 2D multigrid plus the
   f32 floor, which a solve stopped short must break), the solvers to each other
   (SOLVER_XTOL, iterations), and the streamed kernel's launches in each
   ``jacobi-stream`` solve (zeroed just before, read just after) to the
   rule's count (``multigrid3d.stream_launches`` x cycles). Then the pair
   transforms, direct and four-step, at 1024^2 and 8192^2 against
   complex128 ``torch.fft`` (PAIR_FFT_TOL); with TF32 on, the transform
   must refuse to run, and with that refusal taken out its TF32 products
   must break the limit; config 8 through ``bench.record`` (one timed call a
   point, at most 100 round trips a race point) and ``bench.mg3d_chip``'s
   race at 256^3, with a profile of a V-cycle for each smoother (device
   time by kernel, idle share).

Phase 28 runs after 27, before 24's lines:

28. the fault-tolerant chunked path: ``checkpointed_stencil`` at 1024^2 on
   1x1, 1024 steps, a save every 256, with ``resident:8`` (row 4) and
   ``deep-pallas:16`` (row 3): a child process ends itself with ``os._exit``
   after its second save and the run resumes here, bit-identical to the
   uninterrupted run and to ``distributed_stencil``; the async run's
   checkpoints byte-identical to the blocking run's; rows 3 and 4 held to
   16 launches and 1 launch a chunk. The trainer at config 11's width
   (batch cut to 2; ``attn_impl="pallas"``, rows 15 and 16): SGD on 1x1, 6
   steps, a save every 3, clean; a NaN at step 4 rolled back by the guard;
   a preemption under ``supervise_train``; ZeRO Adam on 2 stacked dp ranks
   (row 14) with async saves, preempted once — each bit-identical to its
   clean run, the launches held to layers x steps run. The solver runner at
   256^3 with ``jacobi-stream`` (row 9), 3 cycles a chunk, preempted after
   chunk 2, bit-identical to the unfaulted chunked solve, row 9 held to
   ``stream_launches`` x cycles. Config 16 through ``bench.record``: each
   workload's goodput, checkpoint and restart shares, blocking and async,
   ``GoodputReport.check`` live. Each save's bytes and seconds are logged.

Phase 29 runs after 28, before 24's lines:

29. the co-scheduler, the ledger, profiling and weak scaling: (a) config 18
   through ``bench.record`` (a trainer and a 3D multigrid solve on 4
   stacked ranks under ``MeshScheduler``'s GoodputShare, bit-identical to
   solo, ``by_workload(...).check()`` live): goodput, shares,
   ``share_err``, ms a switch; (b) the ZeRO trainer at config 11's width
   (flash kernels, fused Adam, async saves; batch 2, 6 steps) and the 256^3
   ``jacobi-stream`` solve, solo and co-scheduled: bit-identical, rows 9,
   14, 15 and 16 launched as often as solo and as the rules say; (c) the
   first tick of each workload under ``runtime.profiling.trace``, whose
   file must name ``stream3d_kernel``, ``adam_kernel`` and the flash
   forward and backward kernels; (d) config 15, its ledger columns held to
   ``C15_LEDGER`` (the JAX ledger's numbers at these sizes); (e) config 5
   (``xla``, 1-16 stacked ranks) and the same sweep with ``deep-pallas:16``
   at 32 steps, row 3 held to 2 launches a run; (f) ``python -m
   tpuscratch_torch.obs.regress`` on this phase's rows (exit 0 on the same
   file, 1 with a rate halved) and ``python -m tpuscratch_torch.obs.report``
   on (b)'s JSONL stream. Each step's seconds are printed
   (``Timeline.report``).

Any failure raises and exits non-zero; without a CUDA card, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import functools
import importlib
import itertools
import json
import math
import pathlib
import re
import subprocess
import sys
import time
import warnings

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
# The stencil kernels round every product and sum on its own (never an
# FMA), so each operation is one f32 instruction: half the FMA rate.
F32_SEPARATE_OPS_PER_S = F32_FLOP_PER_S / 2
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
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


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


def bound(nbytes: int, flops: int, ops_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the paged kernel's instantiations: 3 pool dtypes x (16-byte or narrower
# loads) x (nj 1, 2, 4 or a wide head), and the combine kernel
PAGED_INSTANTIATIONS = 3 * 2 * 4 + 1
# the row march's instantiations: 1 or 4 levels a stage x 3 tap masks (2
# of their own and the runtime mask), in the depth-k DMA kernel and, with
# and without the open ends' zeroing, in the streamed 2D kernel; the deep
# trapezoid's: 1 or 4 levels a stage, of its one tap set (all five taps)
MARCH_INSTANTIATIONS = 2 * 3
TRAPEZOID_INSTANTIATIONS = 2
# the one-step kernel's: 3 load widths x 2 index widths
FIVE_INSTANTIATIONS = 3 * 2
# the resident kernel's: 2 load widths x 3 sums (symmetric Jacobi, n s w e
# without and with the centre)
RESIDENT_INSTANTIATIONS = 2 * 3


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
    # kernels that hold their working set in registers, where a spill is a
    # design fault, not a slowdown: the tensor-core flash kernels (bf16
    # wgmma and split TF32: accumulators), the paged-attention kernels (q,
    # the accumulator and a warp's tokens), the stencil steps (their register
    # windows of rows), the DMA ring and the resident kernel (their levels'
    # rows), the row march of the depth-k DMA, streamed 2D and deep
    # trapezoid kernels (a stage's levels' rows) and the z-march (its
    # levels' planes)
    for lib, what, pick, want in (
            ("flash_attention", "tensor-core flash", lambda f: "wgmma" in f or "tf32" in f, 24),
            ("paged_attention", "paged-attention", lambda f: "paged_" in f, PAGED_INSTANTIATIONS),
            ("halo_dma", "dma_hbm_step", lambda f: "dma_hbm_step" in f, 4),
            ("halo_dma", "dma_ring", lambda f: "dma_ring_kernel" in f, 2),
            ("halo_dma", "dma_deep", lambda f: "dma_deep_kernel" in f, MARCH_INSTANTIATIONS),
            ("stencil_stream2d", "stream2d", lambda f: "stream2d_kernel" in f,
             2 * MARCH_INSTANTIATIONS),
            ("stencil_stream3d", "stream3d", lambda f: "stream3d_kernel" in f, 16),
            ("stencil2d", "five_point", lambda f: "five_point_kernel" in f, FIVE_INSTANTIATIONS),
            ("stencil2d", "deep_trapezoid", lambda f: "deep_trapezoid_kernel" in f,
             TRAPEZOID_INSTANTIATIONS),
            ("stencil2d", "resident_periodic", lambda f: "resident_periodic_kernel" in f,
             RESIDENT_INSTANTIATIONS)):
        spills = _spill_stores(build_log(lib), pick)
        log(f"  ptxas: {len(spills)} {what} kernels, spill stores "
            f"{sorted(set(spills.values()))} bytes")
        over = {f: b for f, b in spills.items() if b > _spill_allowed(f)}
        if len(spills) != want or over:
            raise AssertionError(f"a {what} kernel spills or is missing "
                                 f"(want {want}): {over or spills}")
    return {"nvcc": nvcc}


#: spill-store bytes two instantiations may take, by mangled-name part: the
#: 16-byte-row DMA ring (dma_ring_kernel<4>) and the 7-point z-march of 4
#: substeps (stream3d_kernel<7, 4>). Each variant of them measured without
#: that spill, or with less, was slower on the H100 (PERF.md: the ring
#: 4.17 against 3.93 ms at 8192^2); every other kernel checked above may
#: spill nothing.
SPILL_ALLOWED = {"dma_ring_kernelILi4E": 16, "stream3d_kernelILi7ELi4E": 8}


def _spill_allowed(fn: str) -> int:
    return next((b for part, b in SPILL_ALLOWED.items() if part in fn), 0)


def _spill_stores(log_text: str, pick) -> dict:
    """Spill-store bytes of every kernel of a ptxas report whose mangled
    name ``pick`` accepts."""
    spills, fn = {}, None
    for line in log_text.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
        elif fn and "spill stores" in line:
            if pick(fn):
                spills[fn] = int(line.split("bytes spill stores")[0].split(",")[-1])
            fn = None
    return spills


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two tensors of one dtype: -0 and +0 differ, and a
    NaN matches a NaN of any payload (NaN positions compared)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    if a.is_floating_point():
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    return torch.equal(a.view(ints), b.view(ints))


# A 5-point set with a zero side coefficient (s), for the deep trapezoid's
# zero terms beside Jacobi's zero centre
ZERO_SIDE = (0.25, 0.0, 0.25, 0.25, 0.25)


def signed_zero_tile(shape, gen) -> torch.Tensor:
    """Unit-normal data holding one inf and a 16 x 16 checkerboard of 1.0
    and -0.0: a step that drops a zero term gets an inf where the reference
    gets NaN (0 x inf), and -0.0 where it gets +0.0 (a sum of -0.0 terms
    plus +0.0)."""
    tile = randn(shape, gen)
    i = torch.arange(16, device=tile.device)
    board = torch.where((i[:, None] + i[None, :]) % 2 == 0, 1.0, -0.0)
    tile[..., 20:36, 20:36] = board
    tile[..., 44, 47] = float("inf")
    return tile


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

    def bits(name, got, want, what):
        if not same_bits(got, want):
            raise AssertionError(f"{name} {what}: not bit-equal to its plain version")
        log(f"  {name:26s} {what:34s} bit-equal")

    odd = (0.3, 0.15, 0.2, 0.25, 0.1)
    # five_point, both wrappers, bit for bit against the plain core and
    # rebuild, the input unchanged: ragged single tiles (halo (2, 3): an odd
    # pitch), stacked 2x4 batches, a base 4 bytes past 16-byte alignment, the
    # 1024^2 headline tile and the 8192^2 world
    for lead, (h, w), halo, coeffs, off in [
            ((), (37, 53), (1, 1), odd, 0), ((2, 4), (19, 23), (1, 1), sk.JACOBI, 0),
            ((), (37, 53), (2, 3), odd, 0), ((2, 4), (19, 24), (2, 3), odd, 0),
            ((), (64, 62), (1, 1), odd, 1), ((), (1024, 1024), (1, 1), sk.JACOBI, 0),
            ((), (8192, 8192), (1, 1), sk.JACOBI, 0)]:
        lay = TileLayout(h, w, *halo)
        shape = lead + lay.padded_shape
        tile = randn((math.prod(shape) + off,), gen)[off:].view(shape)
        before = tile.clone()
        want = rebuild(tile, sk.five_point_plain(tile, lay, coeffs), lay)
        vec = sk.five_plan(lay.padded_shape[1], tile.data_ptr())
        for fn in (sk.five_point_pallas, sk.five_point_blocked):
            bits(fn.__name__, fn(tile, lay, coeffs), want,
                 f"{lead}+{h}x{w} halo {halo} vec {vec}")
        if not same_bits(tile, before):
            raise AssertionError(f"five_point {lead}+{h}x{w}: the kernel wrote its input")
        del tile, want, before
    # the deep trapezoid adds every term, zero ones too (shrink_step's sum):
    # an inf and -0.0 cells, under Jacobi (centre 0) and a zero side
    for coeffs in (sk.JACOBI, ZERO_SIDE):
        lay = TileLayout(64, 64, 4, 4)
        tile = signed_zero_tile(lay.padded_shape, gen)
        bits("deep_trapezoid_pallas", sk.deep_trapezoid_pallas(tile, lay, 4, coeffs),
             sk.deep_trapezoid_plain(tile, lay, 4, coeffs), f"64x64 k=4 inf, -0.0 {coeffs}")
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
    # largest grid the L2 rule admits (2560^2: both buffers = 50 MiB), at
    # 64 steps (16 rounds of 4) and 17 (a last round of one step)
    for (h, w), coeffs, steps in [
            ((37, 53), sk.JACOBI, STEPS), ((37, 53), odd, STEPS), ((37, 53), odd, 17),
            ((1024, 1024), sk.JACOBI, STEPS), ((1024, 1024), sk.JACOBI, 17),
            ((2560, 2560), sk.JACOBI, STEPS)]:
        core = randn((h, w), gen)
        got = sk.resident_periodic_pallas(core, steps, coeffs)
        check("resident_periodic_pallas", got, sk.resident_periodic_plain(core, steps, coeffs),
              f"{h}x{w} steps={steps}{' sym' if coeffs == sk.JACOBI else ' general'}")
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
        # the padded tile read once and a fresh one written, 9 operations
        # (5 products, 4 sums) a core cell
        b, by = bound(2 * tile.numel() * 4, 9 * n * n, F32_SEPARATE_OPS_PER_S)
        plain = device_ms(lambda: rebuild(tile, sk.five_point_plain(tile, lay), lay))
        lib = device_ms(lambda: conv(tile[None, None], weight))
        lib_rebuild = device_ms(lambda: rebuild(tile, conv(tile[None, None], weight)[0, 0], lay))
        log(f"  library conv2d {n}^2: {lib:.5f} ms, with rebuild {lib_rebuild:.5f} ms")
        for fn in (sk.five_point_pallas, sk.five_point_blocked):
            rows.append(dict(name=fn.__name__, shape=f"{n + 2}^2 -> {n + 2}^2",
                             ms=device_ms(lambda: fn(tile, lay)), plain_ms=plain,
                             library_ms=lib, bound_ms=b, bound_by=by))
        del tile
        for k in (16, 32):
            lay = TileLayout(n, n, k, k)
            tile = randn(lay.padded_shape, gen)
            # the pyramid's cells, 9 operations each (all five terms: 5
            # products, 4 sums)
            pyramid = sum((n + 2 * k - 2 * j) ** 2 for j in range(1, k + 1))
            b, by = bound((tile.numel() + n * n) * 4, 9 * pyramid, F32_SEPARATE_OPS_PER_S)
            log(f"  bound deep_trapezoid_pallas {n}^2 k={k}: {b:.5f} ms by {by}")
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
        b, by = bound(2 * n * n * 4, 4 * n * n * steps, F32_SEPARATE_OPS_PER_S)
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
    counts = {n: c for n, c in sk.launch_counts().items() if not n.startswith("seven_point")}
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
    for fn, name in kernel.values():
        first = fn(x2, y2, block)
        if not all(torch.equal(fn(x2, y2, block), first) for _ in range(3)):
            raise AssertionError(f"{name} is not bit-identical across runs")
        log(f"  {name:26s} 1e8 f32: bit-identical over 4 runs")

    def bit_check(name, got, want, what):
        if not same_bits(got, want):
            raise AssertionError(f"{name} {what}: not bit-equal to its plain version")
        log(f"  {name:26s} {what:34s} bit-equal")

    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64):
        value = 0.1 if dtype.is_floating_point else -7
        bit_check("fill", tf.fill((37, 53), value, dtype), tf.fill_plain((37, 53), value, dtype, "cuda"),
                  f"37x53 {str(dtype)[6:]}")
        # widths and sizes off a multiple of 4 (units across row ends, a
        # tail), and f32 values past 2^24; (300, 70001) overflows f16 to inf
        for shape in ((37, 53), (8192, 8192), (1, 1), (3, 3), (7, 1), (5, 257), (300, 70001)):
            bit_check("iota2d", tf.iota2d(shape, dtype), tf.iota2d_plain(shape, dtype, "cuda"),
                      f"{shape[0]}x{shape[1]} {str(dtype)[6:]}")
    bit_check("fill", tf.fill((n,), 1.0), tf.fill_plain((n,), 1.0, device="cuda"), "1e8 f32")

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
    log(f"  winner {res['winner']} at {res['final'].items_per_s:.6e} elements/s; "
        f"config 2 lines: {json.dumps(out)}")
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
        # the row march's kernels round as their plain versions: bit-equal
        err = max_err(got, want)
        exact = name in ("nine_point_streamed_2d", "dma_deep")
        log(f"  {name:26s} {what:40s} max_abs_err {err:.3e} "
            f"({'bit-equal' if exact else f'atol {KERNEL_ATOL:g}'})")
        if (not torch.equal(got, want)) if exact else err > KERNEL_ATOL:
            raise AssertionError(f"{name} {what}: {err} > {0.0 if exact else KERNEL_ATOL}")
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
              f"(2, 3)+37x53 {len(coeffs)}pt {hd.dma_hbm_step.route}")

    # the full shapes: 8192^2 on a 4x4 mesh (2048^2 tiles), 1024^2 on 1x1;
    # correctness, then times beside bounds (Jacobi, the main path's)
    torch.backends.cudnn.allow_tf32 = False  # the yardstick convolutions in full f32
    conv = torch.nn.functional.conv2d
    ring_steps, deep_k, stream_k = 64, 8, 16
    for lead, n in (((4, 4), 2048), ((1, 1), 1024)):
        label = f"{lead[0] * n}^2 on {lead[0]}x{lead[1]}"
        cells = lead[0] * lead[1] * n * n
        ghost = lead != (1, 1)
        # periodic, as the path runs it: no open flags, the kernel without
        # the open ends' zeroing
        core, top, bot, gl, gr, flags = stream_inputs(lead, n, n, stream_k, ghost, False)
        stream = lambda: ss.nine_point_streamed_2d(  # noqa: E731
            core, top, bot, (n, n), JACOBI, stream_k, gl=gl, gr=gr)
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
        # Jacobi: 4 products and 3 sums a cell a substep, each rounded on its own
        b, by = bound((2 * cells + slab) * 4, 7 * cells * stream_k, F32_SEPARATE_OPS_PER_S)
        rows.append(dict(name="nine_point_streamed_2d", shape=f"{label}, k={stream_k}",
                         ms=device_ms(stream, n=5), plain_ms=device_ms(stream_plain, n=1),
                         library_ms=device_ms(s_lib, n=2), bound_ms=b, bound_by=by))
        del core, top, bot, gl, gr, ext
        if ghost:  # config 4's stream:32 pass
            k32 = 2 * stream_k
            core, top, bot, gl, gr, flags = stream_inputs(lead, n, n, k32, ghost, False)
            stream = lambda: ss.nine_point_streamed_2d(  # noqa: E731
                core, top, bot, (n, n), JACOBI, k32, gl=gl, gr=gr)
            stream_plain = lambda: ss.nine_point_streamed_2d_plain(  # noqa: E731
                core, top, bot, JACOBI, k32, flags, gl, gr)
            check("nine_point_streamed_2d", stream(), stream_plain(), f"{label} k={k32} ghost")
            ext = torch.cat([gl, torch.cat([top, core, bot], dim=-2), gr], dim=-1)
            ext = ext.reshape(-1, 1, n + 2 * k32, n + 2 * k32).contiguous()
            w_stream = _kfold(k32, JACOBI)
            s_lib = lambda: conv(ext, w_stream)  # noqa: E731
            err = max_err(s_lib().reshape(core.shape), stream_plain())
            log(f"  library conv2d {2 * k32 + 1}^2 vs stream plain {label} k={k32}: max_abs_err "
                f"{err:.3e} (atol {LIBRARY_ATOL:g})")
            if err > LIBRARY_ATOL:
                raise AssertionError(f"conv2d yardstick of the stream {label} k={k32}: "
                                     f"{err} > {LIBRARY_ATOL}")
            slab = top.numel() + bot.numel() + gl.numel() + gr.numel()
            b, by = bound((2 * cells + slab) * 4, 7 * cells * k32, F32_SEPARATE_OPS_PER_S)
            rows.append(dict(name="nine_point_streamed_2d", shape=f"{label}, k={k32}",
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
              f"{label} 5pt {hd.dma_hbm_step.route}")
        check("dma_hbm_step", hd.dma_hbm_step(cores, C9), hd.dma_hbm_step_plain(cores, C9),
              f"{label} 9pt {hd.dma_hbm_step.route}")
        world = cores.permute(0, 2, 1, 3).reshape(lead[0] * n, lead[1] * n)
        torus = {k: torch.nn.functional.pad(world[None, None], (k, k, k, k), mode="circular")
                 for k in (1, deep_k)}
        w_deep, w_one, w_nine = _kfold(deep_k, JACOBI), _kfold(1, JACOBI), _kfold(1, NINE)
        d_lib = lambda: conv(torus[deep_k], w_deep)  # noqa: E731
        h_lib = lambda: conv(torus[1], w_one)  # noqa: E731
        n_lib = lambda: conv(torus[1], w_nine)  # noqa: E731
        yardsticks = [(d_lib, hd.dma_deep_plain(cores, deep_k, JACOBI, deep_k), "deep"),
                      (h_lib, hd.dma_hbm_step_plain(cores, JACOBI), "hbm step")]
        if not ghost:  # the 9-point dma path's depth-1 rounds
            yardsticks.append((n_lib, hd.dma_deep_plain(cores, 1, NINE, 1), "deep k=1 9pt"))
        for lib_call, want, what in yardsticks:
            got = lib_call()[0, 0].reshape(lead[0], n, lead[1], n).permute(0, 2, 1, 3)
            err = max_err(got, want)
            log(f"  library conv2d vs {what} plain {label}: max_abs_err {err:.3e} "
                f"(atol {LIBRARY_ATOL:g})")
            if err > LIBRARY_ATOL:
                raise AssertionError(f"conv2d yardstick of {what} {label}: {err} > {LIBRARY_ATOL}")
        b, by = bound(2 * cells * 4, 9 * cells * ring_steps, F32_SEPARATE_OPS_PER_S)
        rows.append(dict(name="dma_ring", shape=f"{label}, {ring_steps} steps",
                         ms=device_ms(lambda: hd.dma_ring(cores, ring_steps, JACOBI), n=3),
                         plain_ms=device_ms(
                             lambda: hd.dma_ring_plain(cores, ring_steps, JACOBI), n=1),
                         library_ms=None, bound_ms=b, bound_by=by))
        log(f"  dma_ring {label}: {hd.dma_ring.route} loads, "
            f"{hd.dma_ring_plan(cores, ring_steps)}")
        b, by = bound(2 * cells * 4, 7 * cells * deep_k, F32_SEPARATE_OPS_PER_S)
        rows.append(dict(name="dma_deep", shape=f"{label}, k={deep_k}",
                         ms=device_ms(lambda: hd.dma_deep(cores, deep_k, JACOBI, deep_k), n=5),
                         plain_ms=device_ms(
                             lambda: hd.dma_deep_plain(cores, deep_k, JACOBI, deep_k), n=1),
                         library_ms=device_ms(d_lib, n=2), bound_ms=b, bound_by=by))
        if not ghost:  # the 9-point dma path's depth-1 rounds (8 taps, 15 operations)
            check("dma_deep", hd.dma_deep(cores, 1, NINE, 1), hd.dma_deep_plain(cores, 1, NINE, 1),
                  f"{label} k=1 9pt")
            b, by = bound(2 * cells * 4, 15 * cells, F32_SEPARATE_OPS_PER_S)
            rows.append(dict(name="dma_deep", shape=f"{label}, k=1 9pt",
                             ms=device_ms(lambda: hd.dma_deep(cores, 1, NINE, 1)),
                             plain_ms=device_ms(lambda: hd.dma_deep_plain(cores, 1, NINE, 1), n=3),
                             library_ms=device_ms(n_lib, n=5), bound_ms=b, bound_by=by))
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


def _launch_deltas(before: dict, after: dict) -> dict:
    """The launches each wrapper made between two readings of its count."""
    return {n: after[n] - before[n] for n in after}


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

    def launches():
        return {n: c for n, c in {**ss.launch_counts(), **hd.launch_counts()}.items()
                if not n.startswith("seven_point")}  # the 3D kernels are phase 12's

    for dims, world in cases:
        mesh = make_mesh_2d(dims)
        before = launches()
        for impl in ("xla",) + NEW_IMPLS:
            for coeffs in (JACOBI,) + ((NINE,) if dims == (1, 1) else ()):
                t0 = time.perf_counter()
                outs[dims, impl, len(coeffs)] = distributed_stencil(
                    world, STEPS, mesh=mesh, impl=impl, coeffs=coeffs)
                log(f"  {impl:12s} {world.shape[0]}^2 x{STEPS} on {dims[0]}x{dims[1]} "
                    f"{len(coeffs)}pt: {time.perf_counter() - t0:.3f} s wall")
        log(f"  launches at {world.shape[0]}^2 on {dims[0]}x{dims[1]}: "
            f"{_launch_deltas(before, launches())}")
    counts = launches()
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


JACOBI7 = (1 / 6,) * 6 + (0.0,)
ODD7 = (0.11, 0.13, 0.17, 0.19, 0.07, 0.05, 0.2)            # inexact products, a centre
C27 = tuple(np.linspace(0.01, 0.26, 26) / 4) + (0.05,)      # 27 points, weights sum to 0.93
SHAPE3D = (256, 512, 512)                                    # config 9's tile
STREAM3D_K = 4
WORLD222_TILE = (256, 256, 256)                              # a rank's tile of the 2x2x2 world
DEVICE = "cuda"


def _kfold3d(k: int, coeffs7) -> torch.Tensor:
    """The (2k+1)^3 weight of k valid 7-point steps (k-fold
    self-convolution of the 3x3x3 stencil, in float64), for conv3d."""
    w3 = torch.zeros((3, 3, 3), dtype=torch.float64, device=DEVICE)
    for (dz, dy, dx), c in zip(((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
                                (0, 0, 1), (0, 0, 0)), coeffs7):
        w3[1 + dz, 1 + dy, 1 + dx] = c
    w3 = w3.reshape(1, 1, 3, 3, 3)
    w = w3
    for _ in range(k - 1):
        w = torch.nn.functional.conv3d(w, w3.flip(-1, -2, -3), padding=2)
    return w.float()


def phase11_kernels3d(gen) -> tuple[dict, list]:
    """The four kernels of rows 5-7 and 9 against their plain versions;
    returns the worst error per wrapper and the timing rows."""
    from tpuscratch_torch.ops import stencil_kernel as sk
    from tpuscratch_torch.ops import stencil_stream as ss

    names = ("seven_point_banded_pallas", "seven_point_strips_pallas",
             "seven_point_assembled_pallas", "seven_point_streamed_pallas")
    errs = {n: 0.0 for n in names}
    rows = []

    def check(name, got, want, what):
        err = max_err(got, want)
        log(f"  {name:28s} {what:44s} max_abs_err {err:.3e} (atol {KERNEL_ATOL:g})")
        if err > KERNEL_ATOL:
            raise AssertionError(f"{name} {what}: {err} > {KERNEL_ATOL}")
        errs[name] = max(errs[name], err)

    def one_step_inputs(lead, shape):
        cz, cy, cx = shape
        core = randn(lead + shape, gen)
        planes = [randn(lead + (1, cy, cx), gen) for _ in range(2)]
        ys = [randn(lead + (cz, 1, cx), gen) for _ in range(2)]
        xs = [randn(lead + (cz, cy, 1), gen) for _ in range(2)]
        return core, planes, ys, xs

    def one_step_checks(lead, shape, coeffs, label, none_cases):
        core, (mz, pz), ys, xs = one_step_inputs(lead, shape)
        padded = randn(lead + tuple(n + 2 for n in shape), gen)
        check(names[0], sk.seven_point_banded_pallas(padded, shape, coeffs),
              sk.seven_point_banded_plain(padded, coeffs), label)
        del padded
        zpad = torch.cat([mz, core, pz], dim=-3)
        check(names[1], sk.seven_point_strips_pallas(zpad, *ys, *xs, shape, coeffs),
              sk.seven_point_strips_plain(zpad, *ys, *xs, coeffs), label)
        del zpad
        nn = [None, None]
        for what, y2, x2, f in none_cases:
            y2, x2 = (ys if y2 else nn), (xs if x2 else nn)
            fterm = randn(lead + shape, gen) if f else None
            check(names[2],
                  sk.seven_point_assembled_pallas(core, mz, pz, *y2, *x2, shape, coeffs,
                                                  fterm=fterm, fc=0.3),
                  sk.seven_point_assembled_plain(core, mz, pz, *y2, *x2, coeffs, fterm, 0.3),
                  f"{label} {what}")

    def stream_inputs(lead, shape, k, gy, gx, rhs=False, flags=None):
        cz, cy, cx = shape
        a = [randn(lead + shape, gen), randn(lead + (k, cy, cx), gen), randn(lead + (k, cy, cx), gen)]
        kw = {}
        if gy:
            kw["gy"] = randn(lead + (cz + 2 * k, 2 * k, cx), gen)
        if gx:
            kw["gx"] = randn(lead + (cz + 2 * k, cy, 2 * k), gen)
        if gy and gx:
            kw["gc"] = randn(lead + (cz + 2 * k, 2 * k, 2 * k), gen)
        if rhs:
            kw["rhs"] = randn(lead + (cz + 2 * k, cy, cx), gen)
        if flags is None:
            f = torch.randint(0, 2, lead + (6,), generator=gen, device=DEVICE, dtype=torch.int32)
        else:
            f = torch.tensor(flags, device=DEVICE, dtype=torch.int32).expand(lead + (6,)).contiguous()
        return a, kw, f

    def stream_check(lead, shape, k, coeffs, gy, gx, label, rhs=False, flags=None):
        a, kw, f = stream_inputs(lead, shape, k, gy, gx, rhs, flags)
        rc = 0.37 if rhs else 0.0
        before = ss.seven_point_streamed_pallas.launches
        got = ss.seven_point_streamed_pallas(*a, shape, coeffs, k, open_flags=f, rhs_coeff=rc,
                                             **kw)
        launches = ss.seven_point_streamed_pallas.launches - before
        want = ss.seven_point_streamed_plain(*a, coeffs, k, f, rhs_coeff=rc, **kw)
        check(names[3], got, want, f"{label} k={k} ({launches} launch{'es' if launches > 1 else ''})")
        return launches

    # ragged: a 2x1x2 stacked batch of 11x13x17 tiles
    lead, shape = (2, 1, 2), (11, 13, 17)
    asm_cases = [("strips", True, True, False), ("no y strips", False, True, False),
                 ("no x strips", True, False, False), ("no strips", False, False, False),
                 ("fterm", True, True, True)]
    for coeffs, cname in ((JACOBI7, "jacobi"), (ODD7, "general")):
        one_step_checks(lead, shape, coeffs, f"{lead}+11x13x17 {cname}", asm_cases)
    for mode, gy, gx in (("z-slab", False, False), ("gy", True, False), ("gx", False, True),
                         ("gy+gx+gc", True, True)):
        for k in (1, 2, 3, 11):
            n = stream_check(lead, shape, k, ODD7, gy, gx, f"{lead}+11x13x17 {mode}")
            if k == 11 and n < 2:
                raise AssertionError("depth 11 was expected to need chained launches")
    for i in range(6):
        flags = [int(j == i) for j in range(6)]
        stream_check(lead, shape, 2, ODD7, True, True, f"flag {i} of [z-,z+,y-,y+,x-,x+]",
                     flags=flags)
    for k in (1, 2, 11):
        stream_check(lead, shape, k, C27, False, False, "27 points z-slab")
    for k in (1, 3, 11):
        stream_check(lead, shape, k, ODD7, False, False, "rhs z-slab", rhs=True)

    # config 9's shape: correctness, then times beside bounds (Jacobi)
    cz, cy, cx = SHAPE3D
    cells = cz * cy * cx
    label = "x".join(map(str, SHAPE3D))
    one_step_checks((), SHAPE3D, JACOBI7, label, [("no strips", False, False, False),
                                                  ("strips", True, True, False)])
    k = STREAM3D_K
    stream_check((), SHAPE3D, k, JACOBI7, False, False, f"{label} z-slab", flags=[0] * 6)
    stream_check((1, 1, 1), SHAPE3D, 2, ODD7, True, True, f"{label} gy+gx+gc open")
    stream_check((), SHAPE3D, 2, C27, False, False, f"{label} 27 points", flags=[1, 0, 0, 0, 0, 0])
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = False  # the yardstick convolutions in full f32
    conv3 = torch.nn.functional.conv3d
    core, (mz, pz), ys, xs = one_step_inputs((), SHAPE3D)
    w1 = _kfold3d(1, JACOBI7)
    padded = randn(tuple(n + 2 for n in SHAPE3D), gen)
    lib = device_ms(lambda: conv3(padded[None, None], w1), n=3)
    err = max_err(conv3(padded[None, None], w1)[0, 0], sk.seven_point_banded_plain(padded, JACOBI7))
    log(f"  library conv3d 3^3 vs banded plain {label}: max_abs_err {err:.3e} (atol {LIBRARY_ATOL:g})")
    if err > LIBRARY_ATOL:
        raise AssertionError(f"conv3d yardstick of the one-step kernels: {err} > {LIBRARY_ATOL}")
    b, by = bound((padded.numel() + cells) * 4, 11 * cells)
    rows.append(dict(name=names[0], shape=f"{label} padded -> core", bound_ms=b, bound_by=by,
                     ms=device_ms(lambda: sk.seven_point_banded_pallas(padded, SHAPE3D, JACOBI7), n=10),
                     plain_ms=device_ms(lambda: sk.seven_point_banded_plain(padded, JACOBI7), n=3),
                     library_ms=lib))
    del padded
    zpad = torch.cat([mz, core, pz], dim=-3)
    strips = sum(t.numel() for t in ys + xs)
    b, by = bound((zpad.numel() + strips + cells) * 4, 11 * cells)
    rows.append(dict(name=names[1], shape=f"{label} zpad + 4 strips", bound_ms=b, bound_by=by,
                     ms=device_ms(lambda: sk.seven_point_strips_pallas(zpad, *ys, *xs, SHAPE3D, JACOBI7), n=10),
                     plain_ms=device_ms(lambda: sk.seven_point_strips_plain(zpad, *ys, *xs, JACOBI7), n=3),
                     library_ms=lib))
    del zpad
    b, by = bound((2 * cells + mz.numel() + pz.numel()) * 4, 13 * cells)
    none = [None] * 4
    rows.append(dict(name=names[2], shape=f"{label} core + 2 planes (y, x self-wrap)",
                     bound_ms=b, bound_by=by,
                     ms=device_ms(lambda: sk.seven_point_assembled_pallas(core, mz, pz, *none, SHAPE3D, JACOBI7), n=10),
                     plain_ms=device_ms(lambda: sk.seven_point_assembled_plain(core, mz, pz, *none, JACOBI7), n=3),
                     library_ms=lib))
    del ys, xs, mz, pz
    # the streamed kernel: z-slab at k = 4 and k = 2; the library call is
    # one (2k+1)^3 conv3d of the extended volume, checked and timed first
    # at 32 planes, and at the full shape only if that stays near a second
    for k in (STREAM3D_K, 2):
        a, kw, f = stream_inputs((), SHAPE3D, k, False, False, flags=[0] * 6)
        wk = _kfold3d(k, JACOBI7)

        def lib_call(planes):
            ext = ss.extended_volume(a[0][:planes], a[1], a[2], k)
            return conv3(ext[None, None], wk)[0, 0]

        small = 32
        want = ss.seven_point_streamed_plain(a[0][:small], a[1], a[2], JACOBI7, k, f)
        err = max_err(lib_call(small), want)
        log(f"  library conv3d {2 * k + 1}^3 vs stream plain {small}x{cy}x{cx} k={k}: "
            f"max_abs_err {err:.3e} (atol {LIBRARY_ATOL:g})")
        if err > LIBRARY_ATOL:
            raise AssertionError(f"conv3d yardstick of the stream k={k}: {err} > {LIBRARY_ATOL}")
        lib_small = device_ms(lambda: lib_call(small), n=1)
        if lib_small * cz / small < 1500:
            lib_ms, lib_shape = device_ms(lambda: lib_call(cz), n=1), label
        else:
            lib_ms, lib_shape = lib_small, f"{small}x{cy}x{cx}"
        b, by = bound((2 * cells + a[1].numel() + a[2].numel()) * 4, 13 * cells * k)
        rows.append(dict(name=names[3], shape=f"{label} z-slab, k={k}", bound_ms=b, bound_by=by,
                         ms=device_ms(lambda: ss.seven_point_streamed_pallas(
                             *a, SHAPE3D, JACOBI7, k, open_flags=f), n=5),
                         plain_ms=device_ms(lambda: ss.seven_point_streamed_plain(
                             *a, JACOBI7, k, f), n=1),
                         library_ms=lib_ms, library_shape=lib_shape))
        del a
        torch.cuda.empty_cache()
    for r in rows:
        at = f" at {r['library_shape']}" if "library_shape" in r else ""
        log(f"  time {r['name']:28s} {r['shape']:44s} {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
            f"library conv3d {r['library_ms']:.4f} ms{at})")
    return errs, rows


def _oracle3d(world: np.ndarray, steps: int, workers: int = 8) -> np.ndarray:
    """``steps`` periodic 7-point Jacobi steps in float64 numpy: the six
    rolls of the whole grid as shifted in-place adds, ``workers`` z slabs
    at a time (numpy releases the GIL)."""
    a = world.astype(np.float64)
    b = np.empty_like(a)
    Z = a.shape[0]
    cuts = np.linspace(0, Z, min(workers, Z) + 1).astype(int)

    def slab(i):
        z0, z1 = int(cuts[i]), int(cuts[i + 1])
        out, mid = b[z0:z1], a[z0:z1]
        out[1:] = a[z0:z1 - 1]          # the plane below, a[z - 1] ...
        out[0] = a[z0 - 1]              # ... across the torus seam at z0 = 0
        out[:-1] += a[z0 + 1:z1]        # the plane above, a[z + 1]
        out[-1] += a[z1 % Z]
        out[:, 1:] += mid[:, :-1]
        out[:, 0] += mid[:, -1]
        out[:, :-1] += mid[:, 1:]
        out[:, -1] += mid[:, 0]
        out[:, :, 1:] += mid[:, :, :-1]
        out[:, :, 0] += mid[:, :, -1]
        out[:, :, :-1] += mid[:, :, 1:]
        out[:, :, -1] += mid[:, :, 0]
        out /= 6.0

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for _ in range(steps):
            list(pool.map(slab, range(len(cuts) - 1)))
            a, b = b, a
    return a


IMPLS3D = ("compact", "compact-pallas", "compact-strips", "compact-asm", "padded",
           "stream:4", "stream:3")


def _worlds3d():
    rng = np.random.default_rng(SEED)
    return {(1, 1, 1): rng.standard_normal(SHAPE3D).astype(np.float32),
            (2, 2, 2): rng.standard_normal(tuple(2 * n for n in WORLD222_TILE)).astype(np.float32)}


def phase12_path3d(worlds, oracle) -> dict:
    """``distributed_stencil3d`` with every impl at 256x512x512 on 1x1x1
    and 512^3 on 2x2x2, each held to ``compact`` and ``compact`` to the
    float64 oracle (a future); an open-boundary and a 27-point case;
    launch counts zeroed just before and read just after."""
    from tpuscratch_torch.halo.halo3d import distributed_stencil3d
    from tpuscratch_torch.ops import stencil_kernel as sk
    from tpuscratch_torch.ops import stencil_stream as ss
    from tpuscratch_torch.runtime.mesh import make_mesh

    sk.reset_launches()
    ss.reset_launches()

    def launches():
        return {n: c for n, c in {**sk.launch_counts(), **ss.launch_counts()}.items()
                if n.startswith("seven_point")}

    def run(dims, world, steps, impl, **kw):
        t0 = time.perf_counter()
        out = distributed_stencil3d(world, steps, make_mesh(dims, ("z", "row", "col"), DEVICE),
                                    impl=impl, **kw)
        extra = "".join(f" {k}={'27pt' if k == 'coeffs' else v}" for k, v in kw.items())
        log(f"  {impl:15s} {'x'.join(map(str, world.shape))} x{steps} on "
            f"{'x'.join(map(str, dims))}{extra}: {time.perf_counter() - t0:.3f} s wall")
        return out

    def hold(label, out, ref, exact, against="compact"):
        if out.shape == ref.shape and np.array_equal(out, ref):
            err = worst = 0.0
        else:
            diff = np.abs(out.astype(np.float64) - ref)
            err = float(diff.max())
            worst = float((diff - PATH_RTOL * np.abs(ref)).max())
        log(f"  {label:28s} vs {against}: max_abs_err {err:.3e} "
            f"({'bit-equal expected' if exact else f'atol {PATH_ATOL9:g} + rtol {PATH_RTOL:g}'})")
        if out.shape != ref.shape or not np.isfinite(out).all() or (
                err != 0.0 if exact else worst > PATH_ATOL9):
            raise AssertionError(f"3D path {label} disagrees with {against}: {err}")

    # the 2x2x2 world first: the float64 oracle of the 1x1x1 world is still
    # running on the host. compact on 2x2x2 is held to compact of the same
    # world on one rank (the same sums in the same order: bit-equal), and
    # compact on one rank, at config 9's shape, to the oracle.
    for dims in ((2, 2, 2), (1, 1, 1)):
        world = worlds[dims]
        before = launches()
        outs = {impl: run(dims, world, STEPS, impl) for impl in IMPLS3D}
        tile = "x".join(str(n // d) for n, d in zip(world.shape, dims))
        log(f"  launches on {'x'.join(map(str, dims))} ({tile} a rank): "
            f"{_launch_deltas(before, launches())}")
        ref = outs["compact"]
        if dims == (1, 1, 1):
            err = float(np.abs(ref.astype(np.float64) - oracle.result()).max())
            log(f"  compact {dims} vs float64 numpy oracle: max_abs_err {err:.3e} "
                f"(atol {ORACLE_ATOL:g})")
            if not np.isfinite(ref).all() or err > ORACLE_ATOL:
                raise AssertionError(f"compact {dims} disagrees with the oracle: {err}")
        else:
            hold(f"compact {dims}", ref, run((1, 1, 1), world, STEPS, "compact"),
                 exact=True, against="compact on one rank")
        # Jacobi's centre term is 0 * c: wherever an impl adds it, the sum
        # of the six face terms runs in FACES order, so every impl must
        # agree with compact bit for bit
        for impl, out in outs.items():
            if impl != "compact":
                hold(f"{impl} {dims}", out, ref, exact=True)
        del outs
    world = worlds[(1, 1, 1)]
    open_x = (True, True, False)  # y self-wraps, x is open: a gx strip and its flags
    before = launches()
    ref = run((1, 1, 1), world, 8, "compact", periodic=open_x)
    for impl in ("padded", "compact-asm", "stream:4", "stream:3"):
        hold(f"{impl} open x", run((1, 1, 1), world, 8, impl, periodic=open_x), ref, exact=True)
    log(f"  launches on 1x1x1 open x: {_launch_deltas(before, launches())}")
    # 27 points: the stream sums the weight cube in (dz, dy, dx) order,
    # compact in OFFSETS26 order
    before = launches()
    ref = run((1, 1, 1), world, 4, "compact", coeffs=C27)
    hold("padded 27pt", run((1, 1, 1), world, 4, "padded", coeffs=C27), ref, exact=True)
    hold("stream:2 27pt", run((1, 1, 1), world, 4, "stream:2", coeffs=C27), ref, exact=False)
    log(f"  launches on 1x1x1 27 points: {_launch_deltas(before, launches())}")
    counts = launches()
    log(f"  launches on the 3D path: {counts}")
    missing = [name for name, k in counts.items() if k < 1]
    if missing:
        raise AssertionError(f"the 3D path never launched {missing}")
    return counts


def phase13_config9() -> list:
    from tpuscratch_torch.bench.record import config9_stencil3d

    out: list = []
    res = config9_stencil3d(out, iters=3, tile=SHAPE3D, device=DEVICE)
    log(f"  config 9 winner {res['winner']}: {res['final'].summary()}")
    for impl, us in out[-1]["us_per_step"].items():
        log(f"  config 9 {impl:15s} {us:10.1f} us a step")
    return out


# Phases 14-16: the serving path. The paged-attention kernel against its
# plain version: both f32, the kernel's dot products and softmax sums in
# another order and int8/fp8 pages dequantized before the product instead
# of folded in after, so a few ulps of the O(1) outputs.
PAGED_ATOL = 1e-5
# a bf16 q: kernel and plain version each round an f32 result to bf16 once,
# so one bf16 ulp of the O(1) outputs (2^-7 below magnitude 2)
PAGED_BF16_ATOL = 1e-2
# config 12's geometry (H 8, d_head 128, 16-token pages) and the timed case:
# 32 sequences of 128 cached tokens, one query each
PAGED_GEOM = dict(H=8, D=128, page=16)
PAGED_TIMED = dict(B=32, T=128)
# the split case (few sequences, a long cache) and the L2-cold setup: a
# 2048-page pool read through 8 tables over disjoint pages (a 32 x 128
# table reads 33.5 MB of f32 pages, 8.4 MB of int8 or fp8: 8 tables keep
# even those past the 50 MB L2 before a table comes back)
PAGED_LONG = dict(B=4, T=4096)
PAGED_COLD_POOL = 2048
PAGED_COLD_TABLES = 8


def _paged_ops(gen, B, K, H, D, page, P, max_pages, dtype, lens=None):
    """q, pools, table, lens and scales on the card: ragged lengths with an
    idle slot 0 (unless ``lens`` is given), shuffled page ids with sentinel
    tail entries, int8/fp8 pools quantized from f32 pages."""
    from tpuscratch_torch.serve.kvcache import quantize_pages

    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,), generator=gen, device=DEVICE)))
    if lens is None:
        lens = rng.integers(1, max_pages * page - K + 2, (B,))
        lens[0] = 0
    table = np.full((B, max_pages), P + 5, np.int32)
    for b in range(B):
        need = -(-(int(lens[b]) + K - 1) // page)
        table[b, :need] = rng.permutation(P)[:need]
    q = randn((B, K, H, D), gen)
    kf, vf = randn((P, page, H, D), gen), randn((P, page, H, D), gen)
    if dtype == torch.float32:
        k, v, ks, vs = kf, vf, None, None
    else:
        (k, ks), (v, vs) = quantize_pages(kf, dtype), quantize_pages(vf, dtype)
    return (q, k, v, torch.from_numpy(table).to(DEVICE),
            torch.from_numpy(np.asarray(lens, np.int32)).to(DEVICE), ks, vs)


def _paged_route() -> str:
    from tpuscratch_torch.ops import attention as ta

    return f"route {ta.paged_attention.route}, {ta.paged_attention.splits} split(s)"


def _paged_bytes(B, T, page, H, D, k, q, table, lens) -> int:
    """What a call must move: the pages it reads (K, V and their scales),
    q in, out, the table and the lengths."""
    n_pages_read = B * -(-T // page)
    scales = 2 * n_pages_read * H * 4 if k.dtype != torch.float32 else 0
    return (2 * n_pages_read * page * H * D * k.element_size() + scales
            + 2 * q.numel() * q.element_size() + table.numel() * 4 + lens.numel() * 4)


def _pregathered(k, v, table, T):
    """SDPA's operands: the pages a call reads, gathered once into
    (B, H, T, D) f32 views (the gather is not timed)."""
    from tpuscratch_torch.ops import attention as ta

    tc = table[:, :-(-T // PAGED_GEOM["page"])]
    return (ta._gather_pages(k, tc).float().transpose(1, 2).contiguous(),
            ta._gather_pages(v, tc).float().transpose(1, 2).contiguous())


def _rotating(fns):
    """One call of each of ``fns`` in turn, a call per invocation."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _cold_pool(gen, dtype, B, T):
    """An L2-cold setup at config 12's geometry: a PAGED_COLD_POOL-page
    pool and PAGED_COLD_TABLES tables over disjoint pages of it, so that a
    table comes back only after the others have read more than the L2."""
    from tpuscratch_torch.serve.kvcache import quantize_pages

    H, D, page = PAGED_GEOM["H"], PAGED_GEOM["D"], PAGED_GEOM["page"]
    P = PAGED_COLD_POOL
    per = B * -(-T // page)
    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,), generator=gen, device=DEVICE)))
    perm = rng.permutation(P)
    tables = [torch.from_numpy(perm[j * per:(j + 1) * per].reshape(B, -1).astype(np.int32))
              .to(DEVICE) for j in range(P // per)][:PAGED_COLD_TABLES]
    kf, vf = randn((P, page, H, D), gen), randn((P, page, H, D), gen)
    if dtype == torch.float32:
        k, v, ks, vs = kf, vf, None, None
    else:
        (k, ks), (v, vs) = quantize_pages(kf, dtype), quantize_pages(vf, dtype)
    del kf, vf
    q = randn((B, 1, H, D), gen)
    lens = torch.full((B,), T, dtype=torch.int32, device=DEVICE)
    return q, k, v, tables, lens, ks, vs


def phase14_paged_kernel(gen) -> tuple[dict, list]:
    """The paged-attention kernels against their plain version on the dtype
    ladder, K = 1, 4 and 20 (20 > page + 1), ragged lengths, sentinels and
    an idle slot, at a small ragged geometry and at config 12's, each
    case's route and split count logged; then their time at config 12's
    decode shape (warm, and L2-cold over rotating tables) and at B 4 x T
    4096 (the split case, beside the same kernels unsplit) beside the
    bound, the plain time and SDPA's over the pre-gathered view (gather
    excluded); and the planted fault the limit must catch: the combine
    with one split's rescale factor dropped."""
    import dataclasses

    from tpuscratch_torch.ops import attention as ta

    err = 0.0
    dtypes = (torch.float32, torch.int8, torch.float8_e4m3fn)
    for dtype in dtypes:
        for K in (1, 4, 20):
            for geom, B, P, max_pages in ((dict(H=3, D=40, page=4), 6, 64, 12),
                                          (PAGED_GEOM, 8, 64, 9)):
                ops = _paged_ops(gen, B, K, geom["H"], geom["D"], geom["page"], P, max_pages, dtype)
                got = ta.paged_attention(*ops)
                e = max_err(got, ta._verify_attention_dense(*ops))
                if e > PAGED_ATOL or got[0].abs().max() != 0:
                    raise AssertionError(f"paged_attention {str(dtype)[6:]} K={K} {geom}: "
                                         f"max_abs_err {e:.3e} (atol {PAGED_ATOL:g}) or idle slot "
                                         "not zero")
                err = max(err, e)
                log(f"  paged_attention {str(dtype)[6:]:14s} K={K:2d} H={geom['H']} "
                    f"D={geom['D']:3d} page={geom['page']:2d} B={B}: max_abs_err {e:.3e}, "
                    f"{_paged_route()}")
    # past the old refusals: 65 and 128 queries (two groups of 64), d_head
    # 384 (three output tiles), and a bf16 q (bf16 out, one bf16 ulp)
    for K, D, dtype, qdt in ((65, 128, torch.float32, torch.float32),
                             (128, 128, torch.int8, torch.float32),
                             (4, 384, torch.float32, torch.float32),
                             (65, 384, torch.float8_e4m3fn, torch.float32),
                             (20, 128, torch.float32, torch.bfloat16),
                             (128, 384, torch.int8, torch.bfloat16)):
        ops = list(_paged_ops(gen, 6, K, 8, D, 16, 64, 16, dtype))
        ops[0] = ops[0].to(qdt)
        got = ta.paged_attention(*ops)
        atol = PAGED_ATOL if qdt == torch.float32 else PAGED_BF16_ATOL
        e = max_err(got.float(), ta._verify_attention_dense(*ops).float())
        if e > atol or got.dtype != qdt or got[0].abs().max() != 0:
            raise AssertionError(f"paged_attention K={K} D={D} {str(dtype)[6:]} q {str(qdt)[6:]}: "
                                 f"max_abs_err {e:.3e} (atol {atol:g}), dtype {got.dtype}, or "
                                 "idle slot not zero")
        if qdt == torch.float32:
            err = max(err, e)
        log(f"  paged_attention {str(dtype)[6:]:14s} K={K:3d} H=8 D={D:3d} page=16 B=6 "
            f"q {str(qdt)[6:]}: max_abs_err {e:.3e} (atol {atol:g}), out {str(got.dtype)[6:]}, "
            f"{_paged_route()}")
    # a head no whole-row ring fits (ROADMAP C2): d_head 16384, one
    # sequence over 3 pages, 512-column units through the ring
    for K in (1, 8):
        for dtype in (torch.float32, torch.int8):
            ops = _paged_ops(gen, 1, K, 1, 16384, 16, 8, 3, dtype, lens=np.array([37]))
            got = ta.paged_attention(*ops)
            e = max_err(got, ta._verify_attention_dense(*ops))
            if e > PAGED_ATOL or not torch.equal(got, ta.paged_attention(*ops)):
                raise AssertionError(f"paged_attention D=16384 K={K} {str(dtype)[6:]}: "
                                     f"max_abs_err {e:.3e} (atol {PAGED_ATOL:g}) or two calls "
                                     "differ")
            err = max(err, e)
            log(f"  paged_attention {str(dtype)[6:]:14s} K={K:3d} H=1 D=16384 page=16 B=1 "
                f"T=37: max_abs_err {e:.3e}, two calls bit-equal, {_paged_route()}")
    H, D, page = PAGED_GEOM["H"], PAGED_GEOM["D"], PAGED_GEOM["page"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    B, T = PAGED_TIMED["B"], PAGED_TIMED["T"]
    for dtype in dtypes:
        q, k, v, table, lens, ks, vs = _paged_ops(gen, B, 1, H, D, page, 512, 9, dtype,
                                                  lens=np.full(B, T))
        b, by = bound(_paged_bytes(B, T, page, H, D, k, q, table, lens), 4 * B * H * T * D)
        e = max_err(ta.paged_attention(q, k, v, table, lens, ks, vs),
                    ta._verify_attention_dense(q, k, v, table, lens, ks, vs))
        if e > PAGED_ATOL:
            raise AssertionError(f"paged_attention {str(dtype)[6:]} B={B} T={T} P=512: "
                                 f"max_abs_err {e:.3e} (atol {PAGED_ATOL:g})")
        err = max(err, e)
        log(f"  paged_attention {str(dtype)[6:]:14s} K= 1 H={H} D={D:3d} page={page:2d} B={B} "
            f"P=512 (the timed case): max_abs_err {e:.3e}, {_paged_route()}")
        kg, vg = _pregathered(k, v, table, T)
        qs = q.transpose(1, 2)                                     # (B, H, 1, D)
        mask = (torch.arange(kg.shape[2], device=DEVICE) < lens[:, None])[:, None, None, :]
        rows.append(dict(
            name="paged_attention", shape=f"B{B} T{T} H{H} D{D} page{page} K1 {str(dtype)[6:]}",
            ms=device_ms(lambda: ta.paged_attention(q, k, v, table, lens, ks, vs)),
            plain_ms=device_ms(lambda: ta._verify_attention_dense(q, k, v, table, lens, ks, vs),
                               n=5),
            library_ms=device_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)),
            library_shape=f"SDPA on the pre-gathered (B, H, {kg.shape[2]}, D) f32 view",
            bound_ms=b, bound_by=by))
        del q, k, v, table, kg, vg
        # L2-cold: each call reads pages (and SDPA a view) that the other
        # tables' calls have pushed out of the 50 MB L2
        q, k, v, tables, lens, ks, vs = _cold_pool(gen, dtype, B, T)
        views = [_pregathered(k, v, t, T) for t in tables]
        mask = (torch.arange(T, device=DEVICE) < lens[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)
        for t in tables:
            e = max_err(ta.paged_attention(q, k, v, t, lens, ks, vs),
                        ta._verify_attention_dense(q, k, v, t, lens, ks, vs))
            if e > PAGED_ATOL:
                raise AssertionError(f"paged_attention {str(dtype)[6:]} L2-cold table: "
                                     f"max_abs_err {e:.3e} (atol {PAGED_ATOL:g})")
            err = max(err, e)
        rows.append(dict(
            name="paged_attention",
            shape=f"L2-cold {len(tables)} tables: B{B} T{T} K1 {str(dtype)[6:]}",
            ms=device_ms(_rotating([functools.partial(ta.paged_attention, q, k, v, t, lens, ks, vs)
                                    for t in tables]), n=4 * len(tables)),
            plain_ms=device_ms(_rotating([functools.partial(
                ta._verify_attention_dense, q, k, v, t, lens, ks, vs) for t in tables]),
                n=len(tables)),
            library_ms=device_ms(_rotating([functools.partial(sdpa, qs, kv[0], kv[1],
                                                              attn_mask=mask)
                                            for kv in views]), n=4 * len(tables)),
            library_shape=f"SDPA on {len(tables)} rotating pre-gathered f32 views",
            bound_ms=b, bound_by=by))
        del q, k, v, tables, views
    # the split case: B 4 x T 4096, where (head, sequence) blocks alone
    # leave most SMs idle; beside it the same kernels under an unsplit plan
    B, T = PAGED_LONG["B"], PAGED_LONG["T"]
    for dtype in dtypes:
        q, k, v, tables, lens, ks, vs = _cold_pool(gen, dtype, B, T)
        table = tables[0]
        ops = (q, k, v, table, lens, ks, vs)
        got = ta.paged_attention(*ops)
        route, splits = _paged_route(), ta.paged_attention.splits
        want = ta._verify_attention_dense(*ops)
        e = max_err(got, want)
        if e > PAGED_ATOL or splits < 2 or not torch.equal(got, ta.paged_attention(*ops)):
            raise AssertionError(f"paged_attention {str(dtype)[6:]} B={B} T={T}: max_abs_err "
                                 f"{e:.3e} (atol {PAGED_ATOL:g}), {route}, or two calls differ")
        err = max(err, e)
        esize = k.element_size()
        vb = ta.paged_load_width(esize, D, k.stride()[:-1] + v.stride()[:-1],
                                 (k.data_ptr(), v.data_ptr()))
        plan = ta.paged_plan(B, 1, H, D, page, table.shape[-1], esize, vb,
                             *ta._paged_device(torch.cuda.current_device()))
        whole = dataclasses.replace(plan, n_split=1, split_len=-(-T // plan.tt) * plan.tt)
        e1 = max_err(ta._paged_launch(whole, *ops), want)
        if e1 > PAGED_ATOL:
            raise AssertionError(f"paged_attention {str(dtype)[6:]} B={B} T={T} unsplit: "
                                 f"max_abs_err {e1:.3e} (atol {PAGED_ATOL:g})")
        log(f"  paged_attention {str(dtype)[6:]:14s} K= 1 H={H} D={D:3d} page={page:2d} B={B} "
            f"T={T}: max_abs_err {e:.3e} ({route}), unsplit {e1:.3e}; two calls bit-equal")
        if dtype == torch.float32:
            # the planted fault: the split model of the kernel's plan, its
            # combine with split 0's exp(m_0 - M) taken as 1
            m, l, acc = ta.paged_split_plain(*ops, split_len=plan.split_len, n_split=plan.n_split)
            good = max_err(ta.combine_splits_plain(m, l, acc), want)
            bad = max_err(ta.combine_splits_plain(m, l, acc, drop_rescale=0), want)
            log(f"  planted fault (combine, split 0's rescale factor dropped): max_abs_err "
                f"{bad:.3e} against the unchanged atol {PAGED_ATOL:g} (the split model unplanted: "
                f"{good:.3e})")
            if good > PAGED_ATOL or bad <= PAGED_ATOL:
                raise AssertionError(f"the planted combine fault: model {good:.3e}, planted "
                                     f"{bad:.3e}, atol {PAGED_ATOL:g}")
            del m, l, acc
        b, by = bound(_paged_bytes(B, T, page, H, D, k, q, table, lens), 4 * B * H * T * D)
        kg, vg = _pregathered(k, v, table, T)
        mask = (torch.arange(T, device=DEVICE) < lens[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)
        rows.append(dict(
            name="paged_attention", shape=f"B{B} T{T} H{H} D{D} page{page} K1 {str(dtype)[6:]}",
            ms=device_ms(lambda: ta.paged_attention(*ops)),
            unsplit_ms=device_ms(lambda: ta._paged_launch(whole, *ops)),
            plain_ms=device_ms(lambda: ta._verify_attention_dense(*ops), n=5),
            library_ms=device_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)),
            library_shape=f"SDPA on the pre-gathered (B, H, {T}, D) f32 view",
            bound_ms=b, bound_by=by, splits=splits))
        del q, k, v, tables, ops, kg, vg, got, want
    for r in rows:
        extra = (f", unsplit {r['unsplit_ms']:.4f} ms ({r['splits']} splits)"
                 if "unsplit_ms" in r else "")
        log(f"  time {r['name']} {r['shape']:40s} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms"
            f"{extra})")
    return {"paged_attention": err}, rows


def _serve_setup():
    from tpuscratch_torch.bench.decode_bench import default_decode_setup
    from tpuscratch_torch.models.transformer import init_params
    from tpuscratch_torch.serve.engine import init_embed

    cfg, scfg, _, _ = default_decode_setup(on_card=True)
    weights = dict(params=init_params(scfg.seed, cfg, DEVICE),
                   embed=init_embed(scfg.seed, scfg.vocab, cfg.d_model, DEVICE))
    return cfg, scfg, weights


def phase15_serve_path(cfg, scfg, weights) -> dict:
    """``ServeEngine`` at config 12's model on a 1x1 mesh: 8 requests
    (prompt 64, 32 new tokens, greedy) with the kernel (``"on"``) and with
    the plain attention (``"off"``); the tokens must be equal and the
    kernel launched once per layer per decode tick. The launch count is
    zeroed just before the kernel run and read just after."""
    import dataclasses

    from tpuscratch_torch.ops import attention as ta
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.serve import Request, ServeEngine

    mesh = make_mesh((1, 1), ("dp", "sp"), DEVICE)
    reqs = [Request(rid=i, prompt=tuple((7 * i + 3 * t) % scfg.vocab for t in range(64)),
                    max_new=32) for i in range(8)]
    reports = {}
    for mode in ("off", "on"):
        eng = ServeEngine(mesh, cfg, dataclasses.replace(scfg, n_slots=8, max_seq=96,
                                                         fused_attention=mode), **weights)
        if mode == "on":
            ta.reset_launches()
        t0 = time.perf_counter()
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if mode == "on":
            counts = ta.launch_counts()
        reports[mode] = rep
        log(f"  engine fused_attention={mode}: {wall:.3f} s wall, completed {rep.completed}, "
            f"tokens {rep.tokens_generated}, decode_steps {rep.decode_steps}, prefills "
            f"{rep.prefills}, programs built {rep.decode_compiles} decode + "
            f"{rep.prefill_compiles} prefill, prefill_s {rep.prefill_s:.3f}, decode_s "
            f"{rep.decode_s:.3f}, slot_steps {rep.slot_steps}, dispatches {rep.dispatches}, "
            f"host_syncs {rep.host_syncs}, kv {eng.kv_cache_bytes} B "
            f"({eng.kv_bytes_per_token:.0f} B/token)")
    on, off = reports["on"], reports["off"]
    toks = [t for _, out in on.outputs for t in out]
    if on.completed != 8 or any(len(o) != 32 for _, o in on.outputs) or not all(
            0 <= t < scfg.vocab for t in toks):
        raise AssertionError(f"serve path: {on.completed} completed, malformed outputs")
    if on.outputs != off.outputs:
        diff = sum(a != b for (_, x), (_, y) in zip(on.outputs, off.outputs) for a, b in zip(x, y))
        raise AssertionError(f"serve path: the kernel's tokens differ from the plain "
                             f"attention's in {diff} of {len(toks)} places")
    want = cfg.n_layers * on.decode_steps
    log(f"  launches on the serving path: {counts} (n_layers x decode ticks = {want}); "
        f"tokens equal in all {len(toks)} places")
    if counts["paged_attention"] != want:
        raise AssertionError(f"serve path launched paged_attention {counts} times, want {want}")
    return counts


def phase16_config12(cfg, scfg, weights) -> list:
    """Config 12 through ``bench.record``, then where a batch-32 tick's
    time goes (``torch.profiler`` over 16 ticks, kernel and plain
    attention)."""
    import dataclasses

    from tpuscratch_torch.bench.decode_bench import profile_ticks
    from tpuscratch_torch.bench.record import config12_decode
    from tpuscratch_torch.runtime.mesh import make_mesh

    out: list = []
    config12_decode(out, device=DEVICE)
    for r in out:
        log(f"  config 12 {r['metric']}: {r.get('value', '')} {r['detail']}")
    for s in out[0]["sweep"]:
        log(f"  config 12 batch {s['batch']:2d}: {s['tokens_per_s']:.1f} tokens/s, per-token p50 "
            f"{s['p50_s_per_token'] * 1e3:.3f} ms, p99 {s['p99_s_per_token'] * 1e3:.3f} ms")
    mesh = make_mesh((1, 1), ("dp", "sp"), DEVICE)
    for mode in ("on", "off"):
        prof = profile_ticks(mesh, cfg, dataclasses.replace(scfg, n_slots=32, fused_attention=mode),
                             **weights)
        log(f"  profile batch 32 fused_attention={mode}: {prof['tick_ms']:.3f} ms an unprofiled "
            f"tick, {prof['profiled_tick_ms']:.3f} ms a profiled one, device "
            f"{prof['device_ms']:.3f} ms (idle share {prof['idle_share']:.3f} of the unprofiled "
            f"tick, {prof['idle_share_profiled']:.3f} of the profiled), "
            f"{prof['launches_per_tick']:.0f} kernel launches a tick")
        log("    by group (ms a tick): " + ", ".join(f"{k} {v:.3f}"
                                                  for k, v in prof["groups_ms"].items()))
        for name, ms in prof["top_ms"]:
            log(f"    {ms:8.4f} ms  {name}")
    return out


# Phases 17-19: the training path. The flash kernels against their plain
# versions on the card. f32 (split TF32 on the tensor cores up to D 128,
# FMAs above): the kernels' products drop the lo*lo terms and the tensor
# cores truncate each k8 step's sum, while the plain version sums full f32
# products through cuBLAS (TF32 off, set below), so a few ulps of the
# largest output: held to FLASH_TOL of max(1, max|want|), where the
# split-TF32 kernels read at most 0.47 of it and one-pass TF32 products
# (phase 17 plants them) read far over it. bf16 operands (the tensor-core kernels):
# q * scale, k * scale, p and ds are rounded to bf16 in both, so an output
# differs where an f32 value a few ulps apart rounded to the other bf16
# neighbour, plus one bf16 ulp (2^-7 of |want|) where the output is bf16
# itself. Each output is held element by element, |got - want| <= a |want|
# + b rms(want) (a = 2^-7 for a bf16 output, 0 for an f32 one), and as a
# whole, rms(got - want) <= c rms(want). The forward rounds p against the
# running max of each key tile, the plain version against the row's final
# max, so p rounds differently in every tile before the max: its (b, c) are
# larger. The backward recomputes p from the final lse in both and rounds p
# and ds as the plain version does (the kernels redo a value near a
# rounding midpoint in cuBLAS's order), so what is left is the outputs' own
# f32 sums: the tensor cores' round toward zero, cuBLAS's to nearest, and a
# bf16 output rounds to the other neighbour where the two straddle a
# midpoint. Sound runs read, at worst over every case and the timed
# shapes: forward (2.1e-2, 2.4e-3), backward (4.0e-4, 2.3e-4; the rms from
# config 6's bf16 gradients, sums of 4096 terms). The backward's p or ds
# left unrounded reads (1.3e-2, 2.6e-3) or more, dv scaled by 0.9 (2.5,
# 0.11): phase 17 plants each in its own reference and fails unless the
# limits catch it. The forward's limits sit about 2x over its sound readings
# (its p left unrounded cannot be told from rounding against the running
# max). PERF.md has the runs.
FLASH_TOL = 1e-5
FLASH_BF16 = {"fwd": (4e-2, 4e-3), "bwd": (2e-3, 2.5e-4)}
BF16_ULP = 2.0 ** -7
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 on the tensor cores
# f32 flash runs as split TF32: three TF32 tensor-core products (495 TFLOP/s
# dense) for each f32 product, so no kernel can beat 495 / 3 TFLOP/s of f32
# work; the f32 FMA rate (F32_FLOP_PER_S) is logged beside it
TF32_SPLIT_FLOP_PER_S = 495e12 / 3
FLASH_PEAK = {torch.float32: TF32_SPLIT_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S}
FLASH_WRAPPERS = ("_flash_fwd_call", "_flash_fwd_compact", "_flash_bwd_call",
                  "_flash_bwd_compact")
# (lead, S, T, H, D, causal, q_offset, kv_offset): ragged S and T, D 64 /
# 128 / 256, per-entry offsets with one fully masked entry (its queries all
# precede its keys); then the tensor-core kernels' other branches: bf16 rows
# of 40 bytes (D 20, H 3), which TMA cannot address and the producer stages
# itself; D 320, split over output-column chunks; S = T = 1000, causal,
# per-entry offsets off the tile grid with one entry fully masked; and D 18,
# whose f32 rows (72 bytes) TMA cannot address either
FLASH_CASES = [
    ((), 70, 70, 2, 64, True, 0, 0),
    ((2,), 45, 83, 3, 128, False, 0, 0),
    ((), 64, 96, 2, 128, True, 16, 0),
    ((2, 3), 40, 40, 2, 64, True, [[0, 40, 80], [0, 0, 0]], [[0, 0, 0], [100, 40, 30]]),
    ((2,), 33, 65, 2, 256, True, 0, 0),
    ((), 17, 129, 1, 96, False, 0, 0),
    ((2,), 200, 200, 2, 128, True, [0, 64], [0, 0]),
    ((), 40, 40, 3, 20, True, 0, 0),
    ((), 50, 70, 2, 320, False, 0, 0),
    ((2,), 1000, 1000, 2, 128, True, [0, 300], [37, 1400]),
    ((), 40, 40, 3, 18, True, 0, 0),
]
# the kernels a flash call takes, by dtype and head width alone
# (csrc/flash_attention.cu): split TF32 up to D 128 (f32), the bf16
# tensor-core kernels up to D 448, the FMA kernels above
FLASH_TC_MAX_D = {torch.float32: 128, torch.bfloat16: 448}
FLASH_TC_ROUTE = {torch.float32: "tf32", torch.bfloat16: "bf16"}
# the suffix of each route's kernel names in the built library
# (flash_fwd_tf32, flash_bwd_dq_wgmma, flash_bwd_dkv_kernel, ...)
FLASH_ROUTE_SUFFIX = {"tf32": "_tf32", "bf16": "_wgmma", "fma": "_kernel"}
# the timed shapes: config 6 (S 4096, H 8, D 128, one sequence) and config
# 11's attention (batch 8 of S 2048, H 8, D 128, per-entry offsets as the
# ring hands them over)
FLASH_TIMED = [("config 6", (), 4096, False), ("config 11", (8,), 2048, True)]
# The three faults of the first design's review, planted in phase 17's own
# copy of the plain backward: each must fail the bf16 limits on the
# kernels' sound output (the 200-row case and config 11's shape).
FLASH_FAULTS = ("p unrounded", "ds unrounded", "dv x 0.9")


def _flash_errs(got, want, dtype, part: str) -> tuple[float, float, tuple]:
    """(max abs error, the share of its limit used (over 1 fails), the
    readings) of one output of a flash call on ``dtype`` operands, ``part``
    "fwd" or "bwd". f32: the error over max(1, max|want|), against
    FLASH_TOL. bf16: (max(|got - want| - a |want|) / rms(want), rms(got -
    want) / rms(want)), against FLASH_BF16[part]. The m state's -1e30
    sentinel (a fully masked row) must match exactly and stays out of the
    rms."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    for what, t in (("got", got), ("want", want)):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"non-finite values in {what}")
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    err = float(d.max())
    if dtype == torch.float32:
        rel = err / max(1.0, float(w.max()))
        return err, rel / FLASH_TOL, (rel,)
    live = w < 1e29
    if bool((d[~live] != 0).any()):
        return err, math.inf, (math.inf, math.inf)
    d, w = d[live], w[live]
    rms = float(w.square().mean().sqrt())
    a = BF16_ULP if got.dtype == torch.bfloat16 else 0.0
    if rms == 0.0:
        readings = (0.0, 0.0) if err == 0.0 else (math.inf, math.inf)
    else:
        readings = (max(0.0, float((d - a * w).max())) / rms,
                    float(d.square().mean().sqrt()) / rms)
    b, c = FLASH_BF16[part]
    return err, max(readings[0] / b, readings[1] / c), readings


def _flash_bound(nbytes: int, flops: float, dtype) -> tuple[float, str]:
    """The least time of a flash call: its bytes at the memory rate or its
    FLOPs at the card's peak for the operand dtype, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLASH_PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kept_pairs(S, T, lead, qo, ko, causal) -> int:
    """(query, key) pairs the mask keeps, summed over the leading entries:
    the work the kernels must do on these inputs."""
    if not causal:
        return S * T * math.prod(lead)
    qo = torch.broadcast_to(torch.as_tensor(qo), lead).reshape(-1).tolist()
    ko = torch.broadcast_to(torch.as_tensor(ko), lead).reshape(-1).tolist()
    total = 0
    for a, b in zip(qo, ko):
        rows = np.arange(S) + a - b + 1           # keys each row keeps
        total += int(np.clip(rows, 0, T).sum())
    return total


def _flash_bwd_planted(q, k, v, do, lse, delta, qo, ko, causal, out_dtype, fault: str):
    """``_flash_bwd_plain``'s arithmetic with one of FLASH_FAULTS planted."""
    from tpuscratch_torch.ops import attention as ta

    mm = ta._mm_dtype(q)
    s, keep = ta._plain_scores(q, k, qo, ko, causal)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    dof = do.to(mm).float()
    dp = torch.einsum("...shd,...thd->...hst", dof, v.float())
    ds = p * (dp - delta[..., None])
    if fault != "ds unrounded":
        ds = ds.to(mm).float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("...hst,...thd->...shd", ds, ta._scaled(k, scale))
    dk = torch.einsum("...hst,...shd->...thd", ds, ta._scaled(q, scale))
    pv = p if fault == "p unrounded" else p.to(mm).float()
    dv = torch.einsum("...hst,...shd->...thd", pv, dof)
    if fault == "dv x 0.9":
        dv = dv * 0.9
    od = out_dtype or q.dtype
    return dq.to(od), dk.to(od), dv.to(od)


def _flash_faults(got, q, k, v, do, lse, delta, qo, ko, causal, od, label) -> None:
    """Each planted fault's reference against the kernels' sound ``got``
    must fail the bf16 backward limits (the limits have teeth)."""
    for fault in FLASH_FAULTS:
        want = _flash_bwd_planted(q, k, v, do, lse, delta, qo, ko, causal, od, fault)
        share, readings = 0.0, None
        for g, w in zip(got, want):
            _, sh, rd = _flash_errs(g, w, torch.bfloat16, "bwd")
            if sh > share:
                share, readings = sh, rd
        log(f"  planted fault '{fault}' at {label}: readings "
            + ", ".join(f"{r:.3e}" for r in readings) + f" ({share:.1f}x the limits)")
        if share <= 1.0:
            raise AssertionError(f"the bf16 backward limits do not catch '{fault}' at {label}")


def _flash_route_check(wrapper, dtype, D, what) -> str:
    """The kernels ``wrapper``'s last launch took, which must be the shape
    rule's: the tensor-core kernels of ``dtype`` up to FLASH_TC_MAX_D, the
    FMA kernels above."""
    want = FLASH_TC_ROUTE[dtype] if D <= FLASH_TC_MAX_D[dtype] else "fma"
    if wrapper.route != want:
        raise AssertionError(f"{wrapper.__name__} {str(dtype)[6:]} D={D} {what}: took "
                             f"{wrapper.route}, the shape rule says {want}")
    return wrapper.route


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (to nearest, ties away): the operand of one TF32 pass."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _flash_one_pass(q, k, v, do, lse, delta, qo, ko, causal):
    """(out, dq, dk, dv): the f32 flash function with every product one TF32
    pass, its operands rounded to TF32 and the split's lo terms dropped
    (phase 17's planted f32 fault)."""
    from tpuscratch_torch.ops import attention as ta

    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks = ta._scaled(q, scale), ta._scaled(k, scale)
    s = torch.einsum("...shd,...thd->...hst", _tf32(qs), _tf32(k))
    keep = ta._keep(qo, ko, q.shape[-3], k.shape[-3], tuple(q.shape[:-3]), causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.tensor(ta.NEG_INF, device=s.device))
    zero = torch.zeros((), device=s.device)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p if keep is None else torch.where(keep, p, zero)
    l = p.sum(-1)
    acc = torch.einsum("...hst,...thd->...shd", _tf32(p), _tf32(v))
    out = acc / torch.where(l > 0, l, torch.ones((), device=l.device)).transpose(-1, -2)[..., None]
    p = torch.exp(s - lse[..., None])
    p = p if keep is None else torch.where(keep, p, zero)
    dp = torch.einsum("...shd,...thd->...hst", _tf32(do), _tf32(v))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("...hst,...thd->...shd", _tf32(ds), _tf32(ks))
    dk = torch.einsum("...hst,...shd->...thd", _tf32(ds), _tf32(qs))
    dv = torch.einsum("...hst,...shd->...thd", _tf32(p), _tf32(do))
    return out, dq, dk, dv


def _flash_one_pass_fault(got, q, k, v, do, lse, delta, qo, ko, causal, label) -> None:
    """The kernels' sound f32 (out, dq, dk, dv) against the one-pass TF32
    reference must fail FLASH_TOL (the f32 limit has teeth)."""
    want = _flash_one_pass(q, k, v, do, lse, delta, qo, ko, causal)
    shares = [_flash_errs(g, w, torch.float32, "fwd")[1] for g, w in zip(got, want)]
    log(f"  planted fault 'one-pass TF32' at {label}: out, dq, dk, dv at "
        + ", ".join(f"{x:.1f}" for x in shares) + "x FLASH_TOL")
    if max(shares) <= 1.0:
        raise AssertionError(f"FLASH_TOL does not catch one-pass TF32 products at {label}")


def _hgmma_counts() -> dict:
    """``cuobjdump -sass`` of the built flash library: the HGMMA
    (warpgroup MMA) instructions of each flash kernel instantiation, by its
    mangled name (0 for the FMA kernels)."""
    from tpuscratch_torch.ops.common import build_all, nvcc_path

    lib = build_all()["flash_attention"]
    tool = str(pathlib.Path(nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            if "flash_" in fn:
                counts[fn] = 0
            else:
                fn = None
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def _kernel_name(mangled: str) -> str:
    """The source name of a mangled kernel name (_Z14flash_fwd_tf32I... ->
    flash_fwd_tf32)."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def _route_kernels(built, route: str, part: str) -> list:
    """The names, read from the built library's SASS, of the kernels a flash
    call of ``route`` launches, ``part`` "fwd" or "bwd"."""
    names = sorted({n for n in map(_kernel_name, built) if n.startswith(f"flash_{part}_")
                    and n.endswith(FLASH_ROUTE_SUFFIX[route])})
    if not names:
        raise AssertionError(f"no {route} {part} flash kernel in the built library: {built}")
    return names


def phase17_flash_kernels(gen, dtypes=(torch.float32, torch.bfloat16)) -> tuple[dict, list]:
    """The flash kernels through their four wrappers against the plain
    versions: f32 (split TF32) and bf16 (the tensor-core kernels, HGMMA in
    their SASS), causal and full, static and per-entry offsets (one entry
    fully masked), ragged S and T, D 18 to 320, the state outputs, the
    backward at dense and compact offsets with q-dtype and f32 gradients,
    each call's route, the planted faults; then each wrapper at config 6's
    and config 11's shapes, its time beside its bound, its plain time and
    SDPA's (forward, or SDPA's autograd backward), and two backward calls
    bit-equal at config 11's. ``dtypes`` narrows the operand types checked.
    The plain versions and SDPA run in full f32: TF32 is off for cuBLAS
    and cuDNN here."""
    from tpuscratch_torch.ops import attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    errs = {n: 0.0 for n in FLASH_WRAPPERS}
    seen: dict = {}     # (dtype, part) -> the worst of each reading, all cases
    case: dict = {}     # the same, this case

    def check(name, got, want, dtype, what):
        part = "bwd" if "bwd" in name else "fwd"
        err, share, readings = _flash_errs(got, want, dtype, part)
        key = (str(dtype)[6:], part)
        for d in (seen, case):
            d[key] = tuple(max(r) for r in zip(d.get(key, readings), readings))
        if share > 1.0:
            limit = (FLASH_TOL,) if dtype == torch.float32 else FLASH_BF16[part]
            raise AssertionError(f"{name} {str(dtype)[6:]} {what}: readings "
                                 + ", ".join(f"{r:.3e}" for r in readings) + f" over {limit}")
        if dtype == torch.float32:
            errs[name] = max(errs[name], err)
        return share

    def inputs(lead, S, T, H, D, dtype):
        return [randn(lead + (n, H, D), gen).to(dtype) for n in (S, T, T, S)]

    hgmma = _hgmma_counts()
    for fn, n in sorted(hgmma.items()):
        log(f"  sass {fn}: {n} HGMMA")
    for route, dt in (("tf32", torch.float32), ("bf16", torch.bfloat16)):
        mine = [n for fn, n in hgmma.items()
                if _kernel_name(fn).endswith(FLASH_ROUTE_SUFFIX[route])]
        if dt in dtypes and (len(mine) != 12 or min(mine) == 0):
            raise AssertionError(f"a {route} flash kernel is missing or has no HGMMA: {hgmma}")

    for dtype in dtypes:
        for lead, S, T, H, D, causal, qo, ko in FLASH_CASES:
            case.clear()
            q, k, v, do = inputs(lead, S, T, H, D, dtype)
            if not isinstance(qo, int):
                qo, ko = torch.tensor(qo, device=DEVICE), torch.tensor(ko, device=DEVICE)
            worst = check("_flash_fwd_call", ta._flash_fwd_call(q, k, v, qo, ko, causal),
                          ta._flash_fwd_plain(q, k, v, qo, ko, causal, False), dtype, "out")
            routes = [_flash_route_check(ta._flash_fwd_call, dtype, D, "out")]
            state = ta._flash_fwd_call(q, k, v, qo, ko, causal, return_state=True)
            pstate = ta._flash_fwd_plain(q, k, v, qo, ko, causal, True)
            for got, want in zip(state, pstate):
                worst = max(worst, check("_flash_fwd_call", got, want, dtype, "state"))
            o, lse = ta._normalize(*pstate, dtype)
            delta = ta._delta(do, o)
            for od in (None, torch.float32):
                got = ta._flash_bwd_call(q, k, v, do, lse, delta, qo, ko, causal, out_dtype=od)
                routes.append(_flash_route_check(ta._flash_bwd_call, dtype, D, "grads"))
                want = ta._flash_bwd_plain(q, k, v, do, lse, delta, qo, ko, causal, od)
                for g, w in zip(got, want):
                    worst = max(worst, check("_flash_bwd_call", g, w, dtype, f"grads {od}"))
                if od is None and (lead, S) == ((2,), 200):
                    if dtype == torch.bfloat16:
                        _flash_faults(got, q, k, v, do, lse, delta, qo, ko, causal, od,
                                      f"lead={lead} S={S}")
                    else:
                        _flash_one_pass_fault(
                            (ta._flash_fwd_call(q, k, v, qo, ko, causal), *got), q, k, v, do,
                            lse, delta, qo, ko, causal, f"lead={lead} S={S}")
            if causal and isinstance(qo, int):
                worst = max(worst, check(
                    "_flash_fwd_compact", ta._flash_fwd_compact(q, k, v, qo, ko),
                    ta._flash_fwd_plain(q, k, v, qo, ko, True, False), dtype, "out"))
                got = ta._flash_bwd_compact(q, k, v, do, lse, delta, qo, ko)
                want = ta._flash_bwd_plain(q, k, v, do, lse, delta, qo, ko, True)
                for g, w in zip(got, want):
                    worst = max(worst, check("_flash_bwd_compact", g, w, dtype, "grads"))
            if not isinstance(qo, int) and bool((state[2] == 0).any()):
                masked = state[2] == 0                   # rows that attend nothing
                out = ta._flash_fwd_call(q, k, v, qo, ko, causal)
                if bool(out.transpose(-2, -3)[masked].any()):
                    raise AssertionError("a fully masked row is not zero")
            log(f"  flash {str(dtype)[6:]:8s} lead={lead} S={S} T={T} H={H} D={D} "
                f"causal={int(causal)} offsets={'per-entry' if not isinstance(qo, int) else (qo, ko)}"
                f" route {'/'.join(sorted(set(routes)))}"
                f": worst share of the limit {worst:.3f}; readings "
                + "; ".join(f"{part} " + ", ".join(f"{r:.3e}" for r in rs)
                            for (_, part), rs in sorted(case.items())))

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, lead, S, per_entry in FLASH_TIMED:
        H, D = 8, 128
        for dtype in dtypes:
            for causal in ((True, False) if label == "config 6" else (True,)):
                q, k, v, do = inputs(lead, S, S, H, D, dtype)
                qo = torch.zeros(lead, dtype=torch.int32, device=DEVICE) if per_entry else 0
                ko = qo
                pairs = _kept_pairs(S, S, lead, 0, 0, causal)
                fflops = 4 * D * H * pairs
                esize = q.element_size()
                B = math.prod(lead)
                state = per_entry      # the ring asks for the state, config 6 for the output
                fwd_name = "_flash_fwd_compact" if causal and not per_entry else "_flash_fwd_call"
                bwd_name = "_flash_bwd_compact" if causal and not per_entry else "_flash_bwd_call"
                fwd = getattr(ta, fwd_name)
                if fwd_name == "_flash_fwd_compact":
                    fcall = lambda: fwd(q, k, v, 0, 0, return_state=state)  # noqa: E731
                else:
                    fcall = lambda: fwd(q, k, v, qo, ko, causal, return_state=state)  # noqa: E731
                pcall = lambda: ta._flash_fwd_plain(q, k, v, qo, ko, causal, state)  # noqa: E731
                got, want = fcall(), pcall()
                for g, w in zip(got if state else (got,), want if state else (want,)):
                    check(fwd_name, g, w, dtype, f"{label} timed")
                fwd_route = _flash_route_check(fwd, dtype, D, f"{label} timed")
                del got, want
                out_bytes = (4 * q.numel() + 8 * B * H * S) if state else q.numel() * esize
                b, by = _flash_bound(3 * q.numel() * esize + out_bytes, fflops, dtype)
                # SDPA's copies (B, H, S, D): 4-D even at config 6, whose lone
                # sequence would give 3-D ones and SDPA's plain math path
                qt, kt, vt = (t.transpose(-3, -2).contiguous().reshape(B, H, S, D)
                              for t in (q, k, v))
                shape = (f"{label} B{B} S{S} H{H} D{D} {'causal' if causal else 'full'} "
                         f"{str(dtype)[6:]}{' state' if state else ''}")
                rows.append(dict(
                    name=fwd_name, shape=shape, ms=device_ms(fcall, n=10),
                    plain_ms=device_ms(pcall, n=3),
                    library_ms=device_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), n=10),
                    library_shape="SDPA forward on (B, H, S, D) copies", bound_ms=b, bound_by=by,
                    gflop=fflops / 1e9, cuda_kernels=_route_kernels(hgmma, fwd_route, "fwd"),
                    **({"fma_bound_ms": fflops / F32_FLOP_PER_S * 1e3}
                       if dtype == torch.float32 else {})))
                acc, m, l = ta._flash_fwd_plain(q, k, v, qo, ko, causal, True)
                o, lse = ta._normalize(acc, m, l, dtype)
                del acc
                delta = ta._delta(do, o)
                od = torch.float32 if per_entry else None   # the ring asks for f32 partials
                bwd = getattr(ta, bwd_name)
                if bwd_name == "_flash_bwd_compact":
                    bcall = lambda: bwd(q, k, v, do, lse, delta, 0, 0)  # noqa: E731
                else:
                    bcall = lambda: bwd(q, k, v, do, lse, delta, qo, ko, causal,  # noqa: E731
                                        out_dtype=od)
                pbcall = lambda: ta._flash_bwd_plain(q, k, v, do, lse, delta, qo, ko,  # noqa: E731
                                                     causal, od)
                got = bcall()
                for g, w in zip(got, pbcall()):
                    check(bwd_name, g, w, dtype, f"{label} timed")
                bwd_route = _flash_route_check(bwd, dtype, D, f"{label} timed")
                if per_entry:
                    # no atomics: every call gives the same bits, through both wrappers
                    for name, call in (
                            (bwd_name, bcall),
                            ("_flash_bwd_compact",
                             lambda: ta._flash_bwd_compact(q, k, v, do, lse, delta, 0, 0))):
                        a, b = call(), call()
                        if not all(torch.equal(x, y) for x, y in zip(a, b)):
                            raise AssertionError(f"{name} {label} {str(dtype)[6:]}: two calls "
                                                 "differ")
                        log(f"  {name} {label} {str(dtype)[6:]}: two calls bit-equal")
                        del a, b
                    if dtype == torch.bfloat16:
                        _flash_faults(got, q, k, v, do, lse, delta, qo, ko, causal, od, label)
                    else:
                        out = ta._normalize(*fcall(), dtype)[0] if state else fcall()
                        _flash_one_pass_fault((out, *got), q, k, v, do, lse, delta, qo, ko,
                                              causal, label)
                        del out
                del got
                bflops = 2.5 * fflops
                gsize = 4 if od == torch.float32 else esize
                nbytes = 4 * q.numel() * esize + 8 * B * H * S + 3 * q.numel() * gsize
                b, by = _flash_bound(nbytes, bflops, dtype)
                qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))
                so = sdpa(qg, kg, vg, is_causal=causal)
                dot = do.transpose(-3, -2).contiguous().reshape(B, H, S, D)
                lib = device_ms(lambda: torch.autograd.grad(so, (qg, kg, vg), dot,
                                                            retain_graph=True), n=5)
                rows.append(dict(
                    name=bwd_name, shape=shape.replace(" state", "") + (" f32 grads" if od else ""),
                    ms=device_ms(bcall, n=5), plain_ms=device_ms(pbcall, n=2), library_ms=lib,
                    library_shape="SDPA's autograd backward on (B, H, S, D) copies",
                    bound_ms=b, bound_by=by, gflop=bflops / 1e9,
                    cuda_kernels=_route_kernels(hgmma, bwd_route, "bwd"),
                    **({"fma_bound_ms": bflops / F32_FLOP_PER_S * 1e3}
                       if dtype == torch.float32 else {})))
                del q, k, v, do, qt, kt, vt, qg, kg, vg, so, dot, o, lse, delta
                torch.cuda.empty_cache()
    for (dt, part), readings in sorted(seen.items()):
        limit = (FLASH_TOL,) if dt == "float32" else FLASH_BF16[part]
        log(f"  flash {dt} {part}: worst readings " + ", ".join(f"{r:.3e}" for r in readings)
            + f" (limits {limit})")
    for r in rows:
        fma = f", {r['fma_bound_ms']:.4f} ms at the f32 FMA rate" if "fma_bound_ms" in r else ""
        log(f"  time {r['name']:20s} {r['shape']:48s} {r['ms']:.4f} ms "
            f"({r['gflop'] / r['ms']:.2f} TFLOP/s; {'+'.join(r['cuda_kernels'])}; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}{fma}, plain {r['plain_ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.4f} ms)")
    return errs, rows


TRAIN_STEPS = 3
# The training path at config 11's model, the flash kernels against the
# plain ring from the same weights and batch: the same function with
# attention summed in another order. One step's reduced gradients are held
# leaf by leaf, rms(g - g_xla) / rms(g_xla), and the losses of TRAIN_STEPS
# SGD steps (f32) or one (bf16) relatively. A step moves the loss by about
# 3e-4 of itself, so the losses alone would miss a wrong attention
# gradient; the gradients do not. f32 reads losses 9.3e-8 and gradients
# 2.4e-4 apart at worst; bf16 (the plain ring rounds its scores and softmax
# to bf16 once per op, the kernels keep them in f32 and round p) 9.6e-6 and
# 3.6e-2. dv scaled by 0.9 in the dk/dv kernel reads losses 5.2e-5 (f32)
# and gradients 0.27 apart. The limits are about 3-10x the sound readings
# (PERF.md has the runs).
TRAIN_TOL = {"float32": (1e-6, 1e-3), "bfloat16": (4e-5, 0.1)}   # (loss, gradients)


def _train_grads(mesh, cfg, params, x, y) -> list:
    """One step's reduced (logical) gradients as (path, leaf) pairs in
    flatten order: ``train_step_fn``'s own ``_value_and_grad`` and
    ``_grad_reduce``."""
    from tpuscratch_torch.comm.spmd import P, run_spmd
    from tpuscratch_torch.models.transformer import (_grad_reduce, _paths, _value_and_grad,
                                                     param_spec)

    def body(p, xs, ys):
        return _grad_reduce(_value_and_grad(p, xs, ys, cfg, "sp", "dp")[1], "dp", "sp")

    pspec = param_spec(cfg)
    return _paths(run_spmd(mesh, body, (pspec, P("dp", "sp"), P("dp", "sp")), pspec)(
        params, x, y))


def phase18_train_path() -> dict:
    """``train_step`` at config 11's model (d_model 1024, 8 heads, 4 experts,
    d_ff 4096, 4 layers, batch 8, seq 2048, seed-0 weights) on a 1x1 mesh
    with ``attn_impl`` "xla" (the plain ring), "pallas" (the ring through
    the dense flash wrappers) and "ulysses-pallas" (the differentiable
    flash_attention, compact wrappers): ``TRAIN_STEPS`` f32 SGD steps each,
    with one forward and one backward launch per layer per step, the launch
    counts zeroed just before each kernel run and read just after; then one
    step's gradients in f32 and one bf16 step with its gradients, each
    against the plain ring's within TRAIN_TOL."""
    import dataclasses

    from tpuscratch_torch.bench.train_bench import default_train_setup, train_data
    from tpuscratch_torch.models.transformer import init_params, train_step
    from tpuscratch_torch.ops import attention as ta
    from tpuscratch_torch.runtime.mesh import make_mesh

    base, batch, seq, _ = default_train_setup(on_card=True)
    mesh = make_mesh((1, 1), ("dp", "sp"), DEVICE)
    x, y = train_data(0, batch, seq, base.d_model, DEVICE)
    params0 = init_params(0, base, DEVICE)
    impls = ("xla", "pallas", "ulysses-pallas")
    counts = {}
    for dtype in ("float32", "bfloat16"):
        n = TRAIN_STEPS if dtype == "float32" else 1
        loss_tol, grad_tol = TRAIN_TOL[dtype]
        losses, grads = {}, {}
        for impl in impls:
            cfg = dataclasses.replace(base, attn_impl=impl, compute_dtype=dtype)
            step = train_step(mesh, cfg, lr=1e-3)
            p, ls = params0, []
            torch.cuda.synchronize()
            if impl != "xla" and dtype == "float32":
                ta.reset_launches()
            t0 = time.perf_counter()
            for _ in range(n):
                p, loss = step(p, x, y)
                ls.append(float(loss))
            wall = time.perf_counter() - t0
            if impl != "xla" and dtype == "float32":
                counts[impl] = ta.launch_counts()
            del p
            losses[impl] = ls
            if not all(math.isfinite(v) for v in ls):
                raise AssertionError(f"train path {impl} {dtype}: losses {ls}")
            g = _train_grads(mesh, cfg, params0, x, y)
            if impl == "xla":
                grads, worst, leaf = g, 0.0, ""
            else:
                worst, leaf = max(
                    (float((a.double() - b.double()).square().mean().sqrt())
                     / float(b.double().square().mean().sqrt()), "/".join(map(str, path)))
                    for (path, a), (_, b) in zip(g, grads))
            del g
            dl = max(abs(a - b) / abs(b) for a, b in zip(ls, losses["xla"]))
            log(f"  train_step {dtype} attn_impl={impl:14s} {n} steps in {wall:.3f} s: losses "
                + ", ".join(f"{v:.7f}" for v in ls)
                + ("" if impl == "xla" else f"; against xla: losses {dl:.3e} (limit "
                   f"{loss_tol:g}), gradients' worst leaf rms {worst:.3e} ({leaf}; limit {grad_tol:g})"))
            if dl > loss_tol or worst > grad_tol or not math.isfinite(worst):
                raise AssertionError(f"train path {impl} {dtype} differs from the plain ring: "
                                     f"losses {dl:.3e} (limit {loss_tol:g}), gradients "
                                     f"{worst:.3e} (limit {grad_tol:g})")
        del grads
        torch.cuda.empty_cache()
    want = base.n_layers * TRAIN_STEPS
    ring, uly = counts["pallas"], counts["ulysses-pallas"]
    log(f"  launches: pallas {ring}; ulysses-pallas {uly} (n_layers x steps = {want})")
    if (ring["_flash_fwd_call"], ring["_flash_bwd_call"]) != (want, want) or \
            (uly["_flash_fwd_compact"], uly["_flash_bwd_compact"]) != (want, want):
        raise AssertionError(f"train path launched the flash kernels {ring} / {uly}, want {want}")
    return {"_flash_fwd_call": ring["_flash_fwd_call"], "_flash_bwd_call": ring["_flash_bwd_call"],
            "_flash_fwd_compact": uly["_flash_fwd_compact"],
            "_flash_bwd_compact": uly["_flash_bwd_compact"]}


def phase19_configs6_11() -> list:
    """Configs 6 and 11 through ``bench.record``, then where a config-11
    train step's time goes (``torch.profiler`` over 2 steps, f32 and bf16)."""
    import dataclasses

    from tpuscratch_torch.bench.record import config6_flash_attention, config11_train
    from tpuscratch_torch.bench.train_bench import default_train_setup, profile_train
    from tpuscratch_torch.runtime.mesh import make_mesh

    out: list = []
    config6_flash_attention(out, device=DEVICE)
    config11_train(out, device=DEVICE, pp_row=False)   # phase 26 runs the pp row, cut
    for r in out:
        if not math.isfinite(r["value"]) or r["value"] <= 0:
            raise AssertionError(f"config {r['config']} {r['metric']}: {r['value']}")
        extra = (f", {r['model_tflops']:.2f} model TFLOP/s, {r['flops_per_token']:.4g} FLOPs/token"
                 if "model_tflops" in r else "")
        log(f"  config {r['config']} {r['metric']}: {r['value']:.6g} (p50 {r['p50_s']:.4f} s"
            f"{extra}) {r['detail']}")
    base, batch, seq, _ = default_train_setup(on_card=True)
    mesh = make_mesh((1, 1), ("dp", "sp"), DEVICE)
    for dtype in ("float32", "bfloat16"):
        prof = profile_train(mesh, dataclasses.replace(base, compute_dtype=dtype), batch, seq)
        log(f"  profile config 11 {dtype}: {prof['step_ms']:.3f} ms an unprofiled step, "
            f"{prof['profiled_step_ms']:.3f} ms a profiled one, device {prof['device_ms']:.3f} ms "
            f"(idle share {prof['idle_share']:.3f} of the unprofiled step), "
            f"{prof['launches_per_step']:.0f} kernel launches a step")
        log("    by group (ms a step): " + ", ".join(f"{k} {v:.3f}"
                                                  for k, v in prof["groups_ms"].items()))
        for name, ms in prof["top_ms"]:
            log(f"    {ms:9.4f} ms  {name}")
    return out


# Phases 20-23: ZeRO training and the copy probes. The fused Adam kernel
# rounds every product, sum, quotient and root as its plain version does,
# in the same association, so it must equal it bit for bit; so must the
# copy probes their clone / multiply.
ADAM_LENGTHS = (1, 3, 1023, 1025, 3001)
ADAM_FLOPS = 12             # per element: m' 3, v' 4, w' 5
# The ZeRO path at config 13's model on dp 2 and 4 against the replicated
# Adam step from the same weights and batch, TRAIN_STEPS steps: the
# reduce-scatter sums each flat element over the dp ranks as the all-reduce
# does, so the two are expected to agree bit for bit; the limits below
# (losses relative, params' worst element relative to the leaf's largest)
# are set from the sound readings and the planted fault (alpha x 0.9 through
# the same kernel): sound runs read 0 and 0 on dp 2 and 4, the fault 4.9e-2
# (the second loss) and 1.4e-3 (params after one step); PERF.md has the run.
ZERO_TOL = (1e-7, 1e-6)
ZERO_OVERLAP_BLOCKS = 4


def _adam_case(gen, shape, mdt, alpha_shape):
    w, g, m = (randn(shape, gen) for _ in range(3))
    v = randn(shape, gen).abs()
    n_alpha = math.prod(alpha_shape)
    alpha = torch.linspace(1e-3, 4e-3, n_alpha, device="cuda").reshape(alpha_shape)
    return w, g, m.to(mdt), v.to(mdt), alpha


def _bit_err(got, want) -> float:
    """max |got - want| over the outputs, non-finite values refused in both."""
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype:
            raise AssertionError(f"dtype {a.dtype} != {b.dtype}")
        if not bool(torch.isfinite(b.float()).all()):
            raise AssertionError("non-finite values in the plain version")
        err = max(err, max_err(a.float(), b.float()))
    return err


def _adam_bytes(n: int, mdt) -> int:
    return n * (28 if mdt == torch.float32 else 20)


def phase20_fused_adam(gen) -> tuple[dict, list]:
    """The fused Adam kernel against its plain version: lengths 1, 3, 1023,
    1025, 3001 and a stacked (4, 3001) with four alphas, f32 and bf16
    moments, donated and not, bit-equal; then its time at adam_bench's tree
    (one launch a leaf) and at config 13's dp-4 shard (4 stacked ranks of
    4,200,448), beside the byte bound, the plain time and
    ``torch._fused_adam_`` over the same tensors (f32 moments only; it puts
    eps after the bias correction: a yardstick of the same traffic)."""
    from tpuscratch_torch.bench import adam_bench
    from tpuscratch_torch.ops import adam as tadam

    err = 0.0
    cases = [((n,), ()) for n in ADAM_LENGTHS] + [((4, 3001), (4,))]
    for mdt in (torch.float32, torch.bfloat16):
        for shape, ashape in cases:
            for donate in (False, True):
                w, g, m, v, alpha = _adam_case(gen, shape, mdt, ashape)
                want = tadam.fused_adam_plain(w, g, m, v, alpha)
                got = tadam.fused_adam_flat(w, g, m, v, alpha, donate=donate)
                torch.cuda.synchronize()
                e = _bit_err(got, want)
                if e != 0.0 or (donate and got[0].data_ptr() != w.data_ptr()):
                    raise AssertionError(f"fused_adam_flat {shape} {str(mdt)[6:]} donate={donate}: "
                                         f"max_abs_err {e:.3e}, want bit-equal and in place")
                err = max(err, e)
        log(f"  fused_adam_flat {str(mdt)[6:]:8s} lengths {ADAM_LENGTHS} and (4, 3001) x 4 "
            f"alphas, donated and not: bit-equal")

    rows = []
    gen_t = torch.Generator(device="cuda").manual_seed(SEED)
    shard = (4, 1, 4_200_448)
    for what, mdt in (("adam_bench tree", torch.float32), ("adam_bench tree", torch.bfloat16),
                      ("config 13 dp-4 shard", torch.float32)):
        if what == "adam_bench tree":
            leaves = adam_bench.LEAVES
            alpha = torch.tensor(1e-3, device="cuda")
        else:
            leaves = {"flat": shard}
            alpha = torch.linspace(1e-3, 4e-3, 4, device="cuda").reshape(4, 1)
        n = sum(math.prod(s) for s in leaves.values())
        w, g = adam_bench.make_tree(gen_t, leaves=leaves), adam_bench.make_tree(gen_t, leaves=leaves)
        m = adam_bench.make_tree(gen_t, mdt, leaves)
        v = adam_bench.make_tree(gen_t, mdt, leaves, positive=True)
        want = tadam.fused_adam_tree(w, g, m, v, alpha)
        got = tadam.fused_adam_tree(w, g, m, v, alpha, donate=False)
        err = max(err, max(_bit_err([got[i][k] for i in range(3)], [want[i][k] for i in range(3)])
                           for k in leaves))
        ms = device_ms(lambda: tadam.fused_adam_tree(w, g, m, v, alpha, donate=True), n=10)
        plain = device_ms(lambda: [tadam.fused_adam_plain(w[k], g[k], m[k], v[k], alpha)
                                   for k in leaves], n=3)
        lib = None
        if mdt == torch.float32:
            ks = list(leaves)
            steps = [torch.tensor(1.0, device="cuda") for _ in ks]
            lib = device_ms(lambda: torch._fused_adam_(
                [w[k] for k in ks], [g[k] for k in ks], [m[k] for k in ks], [v[k] for k in ks], [],
                steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                amsgrad=False, maximize=False), n=10)
        b, by = bound(_adam_bytes(n, mdt), ADAM_FLOPS * n)
        rows.append(dict(name="fused_adam_flat",
                         shape=f"{what} {n:,} {str(mdt)[6:]} moments ({len(leaves)} launch"
                               f"{'es' if len(leaves) > 1 else ''})",
                         ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by))
        del w, g, m, v, want, got
        torch.cuda.empty_cache()
    # the experts' update at config 13's dp 4: the elementwise Adam of the
    # train step (not the kernel) over 4 ranks x 8 expert leaves
    from tpuscratch_torch.models.transformer import _adam_apply

    leaves = [randn((4, 1, 1, 1024, 4096), gen_t) for _ in range(8)]
    grads = [randn(t.shape, gen_t) for t in leaves]
    nus = [t.abs() for t in grads]
    alpha = torch.linspace(1e-3, 4e-3, 4, device="cuda").reshape(4, 1)
    n = sum(t.numel() for t in leaves)
    ms = device_ms(lambda: _adam_apply(leaves, leaves, nus, grads, alpha, 0.9, 0.999, 1e-8), n=3)
    log(f"  time the experts' elementwise Adam at config 13 dp 4 ({n:,} elements, 8 leaves): "
        f"{ms:.4f} ms (a fused pass: {_adam_bytes(n, torch.float32) / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms at 3.35 TB/s)")
    del leaves, grads, nus
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  time fused_adam_flat {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}, {r['bound_ms'] / r['ms']:.2f} of it; plain {r['plain_ms']:.4f} "
            f"ms, torch._fused_adam_ {lib})")
    return {"fused_adam_flat": err}, rows


def _config13_setup(dp: int):
    import dataclasses

    from tpuscratch_torch.bench.train_bench import default_train_setup
    from tpuscratch_torch.models.transformer import init_params
    from tpuscratch_torch.runtime.mesh import make_mesh

    base, batch, seq, _ = default_train_setup(on_card=True)
    cfg = dataclasses.replace(base, n_experts=max(base.n_experts, dp))
    return (cfg, make_mesh((dp, 1), ("dp", "sp"), DEVICE), init_params(0, cfg, DEVICE),
            batch * dp, seq)


def _param_err(a, b) -> float:
    """Worst leaf of max|a - b| / max|b| over two parameter trees."""
    from tpuscratch_torch.models.transformer import _leaves

    return max(float((x.double() - y.double()).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(_leaves(a), _leaves(b)))


def _run_steps(step, params, opt, x, y, n):
    losses = []
    for _ in range(n):
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
    return params, opt, losses


def phase21_zero_path() -> dict:
    """The ZeRO step at config 13's model (d_model 1024, 8 heads, 4 layers,
    d_ff 4096, ``n_experts = max(4, dp)``, batch 8 a dp rank of seq 2048,
    flash attention), seed-0 weights: on 1x1 the elementwise ZeRO step
    against ``train_step_adam`` and the fused step against the elementwise
    one, bit-identical over TRAIN_STEPS steps (the launch counts zeroed just
    before the fused run and read just after: one fused Adam launch a step,
    n_layers flash forward and backward launches a step); on dp 2 and 4
    stacked, ZeRO against replicated within ZERO_TOL, with the planted fault
    (alpha x 0.9 through the same kernel) outside it; the overlap schedule
    against the serial one on dp 4, bit-identical, one launch a block; two
    identical microbatches against one on dp 2 at 1e-6; the grad-sync leg
    at dp 4 <= 0.55x the replicated one; optimizer bytes a rank; the peak
    device memory at dp 4."""
    from tpuscratch_torch.bench.train_bench import train_data
    from tpuscratch_torch.comm import count_wire_bytes
    from tpuscratch_torch.models import zero as tz
    from tpuscratch_torch.models.transformer import (_leaves, init_adam_state,
                                                     train_step_adam)
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta

    counts = {}
    n = TRAIN_STEPS
    # 1x1: ZeRO elementwise == replicated, fused == elementwise
    cfg, mesh, params, batch, seq = _config13_setup(1)
    x, y = train_data(0, batch, seq, cfg.d_model, DEVICE)
    rp, _, rl = _run_steps(train_step_adam(mesh, cfg), params, init_adam_state(params), x, y, n)
    up, uo, ul = _run_steps(tz.train_step_zero(mesh, cfg, fused=False), params,
                            tz.init_zero_adam_state(params, 1), x, y, n)
    torch.cuda.synchronize()
    tadam.reset_launches()
    ta.reset_launches()
    fp, fo, fl = _run_steps(tz.train_step_zero(mesh, cfg, fused=True), params,
                            tz.init_zero_adam_state(params, 1), x, y, n)
    torch.cuda.synchronize()
    counts.update(tadam.launch_counts())
    flash = ta.launch_counts()
    log(f"  1x1: replicated losses {rl}; ZeRO elementwise {ul}; ZeRO fused {fl}")
    same = (rl == ul == fl and all(torch.equal(a, b) and torch.equal(b, c) for a, b, c in
                                   zip(_leaves(rp), _leaves(up), _leaves(fp)))
            and torch.equal(uo["mu_flat"], fo["mu_flat"]) and torch.equal(uo["nu_flat"], fo["nu_flat"]))
    log(f"  1x1 bit-identical (replicated = ZeRO elementwise = ZeRO fused): {same}; launches "
        f"fused_adam_flat {counts['fused_adam_flat']} (want {n}), flash fwd "
        f"{flash['_flash_fwd_call']} bwd {flash['_flash_bwd_call']} (want {cfg.n_layers * n})")
    if not same:
        raise AssertionError("the 1x1 ZeRO step is not bit-identical to the replicated one")
    if counts["fused_adam_flat"] != n or (flash["_flash_fwd_call"], flash["_flash_bwd_call"]) != \
            (cfg.n_layers * n,) * 2:
        raise AssertionError(f"ZeRO path launches: {counts} {flash}")
    del rp, up, fp, uo, fo, x, y, params
    torch.cuda.empty_cache()

    for dp in (2, 4):
        cfg, mesh, params, batch, seq = _config13_setup(dp)
        x, y = train_data(0, batch, seq, cfg.d_model, DEVICE)
        rstep = train_step_adam(mesh, cfg)
        with count_wire_bytes() as rep_b:
            rp1, ro, rl = _run_steps(rstep, params, init_adam_state(params), x, y, 1)
        rp, _, more = _run_steps(rstep, rp1, ro, x, y, n - 1)
        rl += more
        del ro
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zstep = tz.train_step_zero(mesh, cfg)
        with count_wire_bytes() as zero_b:
            zp1, zo, zl = _run_steps(zstep, params, tz.init_zero_adam_state(params, dp), x, y, 1)
        zp, zo, more = _run_steps(zstep, zp1, zo, x, y, n - 1)
        zl += more
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        dl = max(abs(a - b) / abs(b) for a, b in zip(zl, rl))
        dpar = max(_param_err(zp1, rp1), _param_err(zp, rp))
        log(f"  dp {dp}: replicated losses {rl}; ZeRO {zl}; losses {dl:.3e} apart (limit "
            f"{ZERO_TOL[0]:g}), params after 1 and {n} steps {dpar:.3e} (limit {ZERO_TOL[1]:g}); "
            f"peak device memory of the ZeRO run {peak:,} B")
        if dl > ZERO_TOL[0] or dpar > ZERO_TOL[1]:
            raise AssertionError(f"ZeRO dp {dp} differs from replicated: {dl:.3e}, {dpar:.3e}")
        log(f"  dp {dp} grad-sync bytes a step: replicated {rep_b}, ZeRO {zero_b}; grad ratio "
            f"{zero_b.grad / rep_b.grad:.4f}")
        if dp == 4 and not zero_b.grad <= 0.55 * rep_b.grad:
            raise AssertionError(f"ZeRO grad leg {zero_b.grad} > 0.55 x {rep_b.grad}")
        rep_state = sum(t.numel() * t.element_size() for t in _leaves(params)) * 2
        zbytes = tz.zero_state_bytes_per_rank(cfg, params, dp)
        log(f"  dp {dp} optimizer bytes a rank: ZeRO {zbytes:,} against replicated {rep_state:,} / "
            f"{dp} = {rep_state // dp:,}")
        if zbytes > rep_state / dp + 2 * 4 * dp * 8:
            raise AssertionError("per-rank ZeRO optimizer bytes do not divide by dp")
        if dp == 2:
            # the planted fault: a 10% step-size error through the same kernel
            real = tz.fused_adam_tree
            tz.fused_adam_tree = lambda p, g, m, v, alpha, *a, **k: real(p, g, m, v, alpha * 0.9,
                                                                        *a, **k)
            try:
                bstep = tz.train_step_zero(mesh, cfg)
                bp1, bo, bl = _run_steps(bstep, params, tz.init_zero_adam_state(params, dp), x, y, 1)
                bl += _run_steps(bstep, bp1, bo, x, y, 1)[2]
            finally:
                tz.fused_adam_tree = real
            bdl, bdp = abs(bl[1] - rl[1]) / abs(rl[1]), _param_err(bp1, rp1)
            log(f"  dp 2 planted fault (alpha x 0.9): second loss {bdl:.3e}, params after one "
                f"step {bdp:.3e} apart")
            if bdl <= ZERO_TOL[0] or bdp <= ZERO_TOL[1]:
                raise AssertionError("the planted fault passes a ZeRO limit")
            del bp1, bo
            # two identical microbatches against one
            xk, yk = torch.stack([x, x]), torch.stack([y, y])
            _, _, al = _run_steps(tz.train_step_zero(mesh, cfg, accum_steps=2), params,
                                  tz.init_zero_adam_state(params, dp), xk, yk, 2)
            ad = max(abs(a - b) / abs(b) for a, b in zip(al, zl[:2]))
            log(f"  dp 2 accum_steps=2 on identical microbatches: losses {al}, {ad:.3e} from "
                f"accum_steps=1 (limit 1e-6)")
            if ad > 1e-6:
                raise AssertionError(f"accumulation drifts: {ad}")
            del xk, yk
        else:
            torch.cuda.synchronize()
            tadam.reset_launches()
            op, oo, ol = _run_steps(tz.train_step_zero(mesh, cfg,
                                                       overlap_blocks=ZERO_OVERLAP_BLOCKS),
                                    params, tz.init_zero_adam_state(params, dp), x, y, n)
            torch.cuda.synchronize()
            blocks = tadam.launch_counts()["fused_adam_flat"]
            same = ol == zl and all(torch.equal(a, b) for a, b in zip(_leaves(op), _leaves(zp))) \
                and torch.equal(oo["mu_flat"], zo["mu_flat"])
            log(f"  dp 4 overlap_blocks={ZERO_OVERLAP_BLOCKS} against serial: bit-identical {same}, "
                f"{blocks} fused launches in {n} steps")
            if not same or blocks != ZERO_OVERLAP_BLOCKS * n:
                raise AssertionError(f"overlap schedule: identical {same}, launches {blocks}")
            log(f"  dp 4 torch.cuda.max_memory_allocated: {peak:,} B")
            del op, oo
        del rp1, rp, zp1, zp, zo, x, y, params
        torch.cuda.empty_cache()
    return counts


def phase22_config13() -> list:
    """Config 13 through ``bench.record`` (steps cut, listed in each row's
    ``reduced``), a profile of one dp-4 ZeRO step, and the adam_bench race."""
    from tpuscratch_torch.bench import adam_bench
    from tpuscratch_torch.bench.record import config13_zero_train
    from tpuscratch_torch.bench.train_bench import profile_train

    out: list = []
    config13_zero_train(out, iters=1, steps=2, sweep_steps=1, device=DEVICE)
    for r in out:
        log(f"  config 13 {r['metric']}: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()
            if k not in ("config", "metric", "platform")))
        for key in ("repl_tokens_per_s", "zero_tokens_per_s"):
            if key in r and not (math.isfinite(r[key]) and r[key] > 0):
                raise AssertionError(f"config 13 {r['metric']} {key}: {r[key]}")
    cfg, mesh, params, batch, seq = _config13_setup(4)
    del params
    prof = profile_train(mesh, cfg, batch, seq, steps=1, zero=True)
    log(f"  profile config 13 dp 4 ZeRO: {prof['step_ms']:.3f} ms an unprofiled step, "
        f"{prof['profiled_step_ms']:.3f} ms a profiled one, device {prof['device_ms']:.3f} ms "
        f"(idle share {prof['idle_share']:.3f} of the unprofiled step), "
        f"{prof['launches_per_step']:.0f} kernel launches a step")
    log("    by group (ms a step): " + ", ".join(f"{k} {v:.3f}" for k, v in prof["groups_ms"].items()))
    for name, ms in prof["top_ms"]:
        log(f"    {ms:9.4f} ms  {name}")
    torch.cuda.empty_cache()
    r = adam_bench.race(20, device=DEVICE)
    log(f"  adam_bench: {r['n']:,} params, kernel vs 3-map after 3 updates {r['gate_err']:.3e}")
    for form, v in r["forms"].items():
        log(f"    {form:13s} {v['ms']:.4f} ms/update ({v['gbps']:.0f} GB/s effective)")
    torch.cuda.empty_cache()
    return out


def phase23_copy_probes() -> tuple[dict, list, dict]:
    """The copy probes against clone / x * c, bit-equal, at a ragged small
    array and at 256x512x512; then every probe's marginal GB/s (the launch
    counts zeroed just before and read just after), ``copy_``'s and the
    measured copy rate; each wrapper's best configuration is its row."""
    from tpuscratch_torch.bench import dma_bound as tb

    c = torch.full((1,), 1.0 + 2 ** -20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = {w.__name__: 0.0 for w in tb.WRAPPERS}
    probes = tb.probes()
    for shape in ((8, 37, 12), (tb.NZ, tb.CY, tb.CX)):
        x = randn(shape, gen)
        for name, step in probes[:-2]:
            want = tb.touch_plain(x, c) if "touch" in name else tb.copy_plain(x, c)
            e = max_err(step(x, c), want)
            if e != 0.0:
                raise AssertionError(f"{name} {shape}: max_abs_err {e:.3e}, want bit-equal")
        log(f"  every probe at {shape}: bit-equal to clone / x * c")
        del x
    tb.reset_launches()
    results = {name: tb.race(name, step, device=DEVICE) for name, step in probes}
    counts = tb.launch_counts()
    plain = {"copy": tb.race("clone", tb.copy_plain, device=DEVICE),
             "touch": tb.race("x * c", tb.touch_plain, device=DEVICE)}
    for r in list(results.values()) + list(plain.values()):
        log(f"  {r['name']:32s} marginal {r['ms']:.4f} ms/step ({r['gbps']:.1f} GB/s rd+wr)")
    best = max(results.values(), key=lambda r: r["gbps"])
    log(f"measured copy rate: {best['gbps']:.1f} GB/s rd+wr ({best['name']}; data sheet 3350 GB/s)")
    b, by = bound(2 * tb.BYTES, 0)
    prefix = {"manual_stream": "manual-", "hbm2hbm": "hbm2hbm", "kway_hbm2hbm": "hbm2hbm-",
              "lanes_stream": "lanes"}
    rows = []
    for w in tb.WRAPPERS:
        mine = [r for n, r in results.items() if n.startswith(prefix[w.__name__])
                and (("way" in n) == (w.__name__ == "kway_hbm2hbm"))]
        top = max(mine, key=lambda r: r["gbps"])
        kind = "touch" if "touch" in top["name"] else "copy"
        log(f"  best {w.__name__:14s} {top['name']}: {top['ms']:.4f} ms/step")
        rows.append(dict(name=w.__name__, shape=f"256x512x512 f32 {top['name']}", ms=top["ms"],
                         plain_ms=plain[kind]["ms"],
                         library_ms=results["xla-touch" if kind == "touch" else "copy_"]["ms"],
                         library_shape="x * c" if kind == "touch" else "Tensor.copy_",
                         bound_ms=b, bound_by=by))
    return err, rows, counts


# Phases 25-26: the pipelined training path at config 11's model (d_model
# 1024, 8 heads, 4 experts, d_ff 4096, 4 layers, f32, the flash kernels;
# batch 8 a dp rank of seq 2048). Each stage's layers run through the same
# kernels as phase 18's step, so a degenerate schedule (one stage, one
# microbatch) and an extra stage (1x1x2 against 1x1x1) are expected to
# agree with their reference bit for bit; they are held to TRAIN_TOL's f32
# loss limit and ZERO_TOL's params limit, and whether the bits agree is
# logged. The plain ring against the flash kernels at n_micro 4 is held as
# phase 18 holds them (TRAIN_TOL); the plan's ZeRO step against its
# stacked Adam step to ZERO_TOL, with phase 21's planted fault outside it.
PP_STEPS = 2
# The SSM block on 4 stacked sequence ranks against the local scan at T
# 65,536: the same recurrence in other groupings (a 14-level scan a shard
# and a 4-way carry against one 16-level scan), so f32 roundings of the
# O(10) states; held relative to max|want|. Dropping the cross-shard carry
# (each shard scanned from zero) must read far over it.
SSM_SHAPE = dict(T=65536, d_model=1024, d_state=128, ranks=4)
SSM_TOL = 1e-5


def _counted(fn):
    """``fn()`` with the flash and fused-Adam launch counts zeroed just before
    and read just after: (result, {wrapper: launches})."""
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta

    torch.cuda.synchronize()
    ta.reset_launches()
    tadam.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in ta.launch_counts().items() if k in ("_flash_fwd_call",
                                                                    "_flash_bwd_call")}
    counts["fused_adam_flat"] = tadam.launch_counts()["fused_adam_flat"]
    return out, counts


def _sgd_steps(step, params, x, y, n):
    losses = []
    for _ in range(n):
        params, loss = step(params, x, y)
        losses.append(float(loss))
    return params, losses


def _same(la, lb, pa, pb) -> bool:
    from tpuscratch_torch.models.transformer import _leaves

    return la == lb and all(torch.equal(a, b) for a, b in zip(_leaves(pa), _leaves(pb)))


def _held(what: str, la, lb, pa, pb, bits_expected: bool = True) -> None:
    """Losses within TRAIN_TOL's f32 limit, params within ZERO_TOL's; logs
    whether the two runs agree bit for bit."""
    dl = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    dp = _param_err(pa, pb)
    log(f"  {what}: losses {la} against {lb}, {dl:.3e} apart (limit {TRAIN_TOL['float32'][0]:g}),"
        f" params {dp:.3e} (limit {ZERO_TOL[1]:g})"
        + (f"; bit-identical {_same(la, lb, pa, pb)}" if bits_expected else ""))
    if dl > TRAIN_TOL["float32"][0] or dp > ZERO_TOL[1]:
        raise AssertionError(f"{what}: losses {dl:.3e}, params {dp:.3e} over the limits")


def _stage_batching_bits(gen) -> dict:
    """Whether a block's GEMMs round the same with two stages in the stage
    dim as with one (what 1x1x2 against 1x1x1 changes): stage 0's output and
    gradients of the projection ``x @ w`` and of the experts' first einsum
    at a 1x1x2 tick's shapes, from one call over both stages and from a call
    over stage 0 alone. Returns {op: (out, dx, dw) bit-equal}."""
    from tpuscratch_torch.ops import attention as ta

    def flash(a, b):  # q = a, k = v = b, causal, per-entry offsets (the dense wrappers)
        qo = torch.zeros(a.shape[:-3], dtype=torch.int32, device=a.device)
        return ta.flash_attention(a, b, b, causal=True, q_offset=qo, kv_offset=qo)

    shapes = {"projection x @ w": ((4, 2048, 1024), (1024, 1024), (4, 2048, 1024),
                                   lambda a, b: a @ b[..., None, :, :]),
              "gate logits": ((8192, 1024), (1024, 4), (8192, 4), lambda a, b: a @ b),
              "expert einsum in": ((4, 4096, 1024), (4, 1024, 4096), (4, 4096, 4096),
                                   lambda a, b: torch.einsum("...ecd,...edf->...ecf", a, b)),
              "expert einsum out": ((4, 4096, 4096), (4, 4096, 1024), (4, 4096, 1024),
                                    lambda a, b: torch.einsum("...ecf,...efd->...ecd", a, b)),
              "rms norm": ((4, 2048, 1024), (1024,), (4, 2048, 1024),
                           lambda a, b: a * torch.rsqrt(torch.mean(torch.square(a), dim=-1,
                                                                   keepdim=True) + 1e-6)
                           * b[..., None, None, :]),
              "mean over a rank's (B, S, d)": (
                  (4, 2048, 1024), (1,), (),
                  lambda a, b: torch.mean(torch.square(a - b[..., None, None]), dim=(-3, -2, -1))),
              "flash fwd + bwd": ((4, 2048, 8, 128), (4, 2048, 8, 128), (4, 2048, 8, 128), flash)}
    out = {}
    for name, (xs, ws, gs, f) in shapes.items():
        x, w, g = (randn((1, 1, 2) + s, gen) for s in (xs, ws, gs))

        def run(n):
            a = x[:, :, :n].clone().requires_grad_()
            b = (w[:, :, :n] * 0.03).requires_grad_()
            y = f(a, b)
            y.backward(g[:, :, :n])
            return y[:, :, 0], a.grad[:, :, 0], b.grad[:, :, 0]

        out[name] = tuple(torch.equal(p, q) for p, q in zip(run(2), run(1)))
        del x, w, g
    return out


def _pp_kernel_checks(gen, lead) -> dict:
    """The flash wrappers at a pipelined tick's attention shape (``lead`` =
    the mesh dims and the microbatch) and the fused Adam kernel at the plan's
    flat-shard layout, each against its plain version: (wrapper -> max abs
    error)."""
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta

    S, H, D = 2048, 8, 128
    q, k, v, do = (randn(lead + (S, H, D), gen) for _ in range(4))
    qo = torch.zeros(lead, dtype=torch.int32, device=DEVICE)
    errs = {}
    got = ta._flash_fwd_call(q, k, v, qo, qo, True, return_state=True)
    want = ta._flash_fwd_plain(q, k, v, qo, qo, True, True)
    share = 0.0
    for g, w in zip(got, want):
        err, sh, _ = _flash_errs(g, w, torch.float32, "fwd")
        errs["_flash_fwd_call"] = max(errs.get("_flash_fwd_call", 0.0), err)
        share = max(share, sh)
    o, lse = ta._normalize(*want, torch.float32)
    delta = ta._delta(do, o)
    for g, w in zip(ta._flash_bwd_call(q, k, v, do, lse, delta, qo, qo, True,
                                       out_dtype=torch.float32),
                    ta._flash_bwd_plain(q, k, v, do, lse, delta, qo, qo, True, torch.float32)):
        err, sh, _ = _flash_errs(g, w, torch.float32, "bwd")
        errs["_flash_bwd_call"] = max(errs.get("_flash_bwd_call", 0.0), err)
        share = max(share, sh)
    log(f"  flash at the tick shape lead={lead} S={S} H={H} D={D} causal, per-entry offsets: "
        f"fwd {errs['_flash_fwd_call']:.3e}, bwd {errs['_flash_bwd_call']:.3e}, worst share of "
        f"FLASH_TOL {share:.3f}")
    if share > 1.0:
        raise AssertionError("the flash kernels disagree at the pipelined tick shape")
    del q, k, v, do, got, want, o, lse, delta
    # the plan's flat moments: a (|pp| * flat,) vector split P((pp, dp)) on the
    # (dp, sp, pp) = (2, 1, 2) mesh, two strides that the kernel's rows cannot
    # walk as one, so the wrapper copies them (donate=False, as the step does)
    shard = 4_200_448
    mu = randn((2 * 2 * shard,), gen)
    nu = randn((2 * 2 * shard,), gen).abs()
    view = lambda t: t.reshape(2, 2, shard).permute(1, 0, 2).unsqueeze(1)  # noqa: E731
    w, g = randn((2, 1, 2, shard), gen), randn((2, 1, 2, shard), gen)
    alpha = torch.tensor([[[1e-3, 2e-3]], [[3e-3, 4e-3]]], device=DEVICE)
    got = tadam.fused_adam_flat(w, g, view(mu), view(nu), alpha, donate=False)
    want = tadam.fused_adam_plain(w, g, view(mu), view(nu), alpha)
    errs["fused_adam_flat"] = _bit_err(got, want)
    log(f"  fused_adam_flat at the plan's (pp, dp)-split shards (2, 1, 2, {shard:,}): "
        f"bit-equal {errs['fused_adam_flat'] == 0.0}")
    if errs["fused_adam_flat"] != 0.0:
        raise AssertionError("fused Adam differs from its plain version at the plan's layout")
    return errs


def phase25_pipelined_path(gen) -> tuple[dict, dict]:
    """The pipelined training path at config 11's model (module comment):
    ``train_step_pp`` on 1x1x1 at n_micro 1 against ``train_step``; n_micro 4
    on 1x1x1 with the plain ring and with the flash kernels; 1x1x2 against
    1x1x1 at n_micro 2; ``train_step_plan`` on stacked pp2 x dp2 (batch 8 a
    dp rank, n_micro 2): ZeRO overlap against serial (bit-identical), ZeRO
    against the stacked Adam step (ZERO_TOL) and the planted fault (alpha x
    0.9) outside it; every run's flash and fused-Adam launches counted (the
    counts zeroed just before each run, read just after) and held to the
    schedule's; the kernels against their plain versions at the tick's
    shapes; then ``ssm_block`` on 4 stacked sequence ranks against the local
    path. Returns (the pipelined path's launches, max abs errors)."""
    import dataclasses

    from tpuscratch_torch.bench.train_bench import default_train_setup, train_data
    from tpuscratch_torch.comm import P, run_spmd
    from tpuscratch_torch.models import ssm as tm
    from tpuscratch_torch.models import zero as tz
    from tpuscratch_torch.models.transformer import (init_adam_state, init_params,
                                                     stack_layers, train_step, train_step_pp,
                                                     unstack_layers)
    from tpuscratch_torch.parallel.plan import ShardingPlan
    from tpuscratch_torch.runtime.mesh import make_mesh, make_mesh_1d

    base, batch, seq, _ = default_train_setup(on_card=True)
    L = base.n_layers
    axes = ("dp", "sp", "stage")
    x, y = train_data(0, batch, seq, base.d_model, DEVICE)
    params = init_params(0, base, DEVICE)
    stacked = stack_layers(params)
    total = {"_flash_fwd_call": 0, "_flash_bwd_call": 0, "fused_adam_flat": 0}

    def expect(what, counts, fwd, adam=0):
        log(f"  {what} launches: {counts} (want flash {fwd} each way, fused Adam {adam})")
        if (counts["_flash_fwd_call"], counts["_flash_bwd_call"],
                counts["fused_adam_flat"]) != (fwd, fwd, adam):
            raise AssertionError(f"{what}: launches {counts}")
        for k in total:
            total[k] += counts[k]

    # 1x1x1 at n_micro 1 against the plain dp x sp step
    ref_p, ref_l = _sgd_steps(train_step(make_mesh((1, 1), ("dp", "sp"), DEVICE), base, lr=1e-3),
                              params, x, y, PP_STEPS)
    mesh1 = make_mesh((1, 1, 1), axes, DEVICE)
    t0 = time.perf_counter()
    (pp_p, pp_l), c = _counted(lambda: _sgd_steps(train_step_pp(mesh1, base, lr=1e-3, n_micro=1),
                                                  stacked, x, y, PP_STEPS))
    log(f"  train_step_pp 1x1x1 n_micro 1: {PP_STEPS} steps in {time.perf_counter() - t0:.3f} s")
    expect("1x1x1 n_micro 1", c, L * PP_STEPS)
    _held("1x1x1 n_micro 1 against train_step", pp_l, ref_l, unstack_layers(pp_p), ref_p)
    del ref_p, pp_p

    # n_micro 4 on 1x1x1: the plain ring against the flash kernels
    runs = {}
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        t0 = time.perf_counter()
        runs[impl], c = _counted(lambda: _sgd_steps(train_step_pp(mesh1, cfg, lr=1e-3, n_micro=4),
                                                    stacked, x, y, PP_STEPS))
        log(f"  train_step_pp 1x1x1 n_micro 4 attn_impl={impl}: {PP_STEPS} steps in "
            f"{time.perf_counter() - t0:.3f} s")
        if impl == "pallas":
            expect("1x1x1 n_micro 4", c, 4 * L * PP_STEPS)
    _held("n_micro 4 flash against the plain ring", runs["pallas"][1], runs["xla"][1],
          runs["pallas"][0], runs["xla"][0], bits_expected=False)
    del runs

    # one stage against two at n_micro 2
    one = _sgd_steps(train_step_pp(mesh1, base, lr=1e-3, n_micro=2), stacked, x, y, PP_STEPS)
    t0 = time.perf_counter()
    two, c = _counted(lambda: _sgd_steps(train_step_pp(make_mesh((1, 1, 2), axes, DEVICE), base,
                                                       lr=1e-3, n_micro=2),
                                         stacked, x, y, PP_STEPS))
    log(f"  train_step_pp 1x1x2 n_micro 2: {PP_STEPS} steps in {time.perf_counter() - t0:.3f} s")
    expect("1x1x2 n_micro 2", c, 3 * (L // 2) * PP_STEPS)
    _held("1x1x2 against 1x1x1 at n_micro 2", two[1], one[1], two[0], one[0])
    del one, two, x, y, params
    log("  stage batching, (out, dx, dw) bit-equal with two stages in a call and with one: "
        + "; ".join(f"{k} {v}" for k, v in _stage_batching_bits(gen).items()))
    torch.cuda.empty_cache()

    # the plan's step on stacked pp2 x dp2
    dp, pp = 2, 2
    pmesh = make_mesh((dp, 1, pp), ("dp", "sp", "pp"), DEVICE)
    serial = ShardingPlan(pmesh, pp="pp", n_micro=2, overlap=False)
    overlap = ShardingPlan(pmesh, pp="pp", n_micro=2)
    px, py = train_data(0, dp * batch, seq, base.d_model, DEVICE)
    ticks = 2 + pp - 1

    def plan_run(plan, zero=True):
        opt = tz.init_plan_zero_state(stacked, plan) if zero else init_adam_state(stacked)
        t0 = time.perf_counter()
        out = _run_steps(tz.train_step_plan(plan, base, zero=zero), stacked, opt, px, py,
                         PP_STEPS)
        log(f"  train_step_plan pp2 x dp2 zero={zero} overlap_blocks={plan.overlap_blocks}: "
            f"{PP_STEPS} steps in {time.perf_counter() - t0:.3f} s, losses {out[2]}")
        return out

    torch.cuda.reset_peak_memory_stats()
    (sp_, so, sl), c = _counted(lambda: plan_run(serial))
    expect("plan serial", c, ticks * (L // pp) * PP_STEPS, PP_STEPS)
    (op_, oo, ol), c = _counted(lambda: plan_run(overlap))
    expect("plan overlap", c, ticks * (L // pp) * PP_STEPS, overlap.prefetch_blocks * PP_STEPS)
    same = _same(ol, sl, op_, sp_) and torch.equal(oo["mu_flat"], so["mu_flat"]) and \
        torch.equal(oo["nu_flat"], so["nu_flat"])
    log(f"  plan overlap against serial: bit-identical {same}; peak device memory "
        f"{torch.cuda.max_memory_allocated():,} B")
    if not same:
        raise AssertionError("the plan's overlap schedule is not bit-identical to the serial one")
    del op_, oo, so
    (rp, _, rl), c = _counted(lambda: plan_run(serial, zero=False))
    expect("plan zero=False", c, ticks * (L // pp) * PP_STEPS)
    dl = max(abs(a - b) / abs(b) for a, b in zip(sl, rl))
    dpar = _param_err(sp_, rp)
    log(f"  plan ZeRO against the stacked Adam step: losses {dl:.3e} (limit {ZERO_TOL[0]:g}), "
        f"params {dpar:.3e} (limit {ZERO_TOL[1]:g}); bit-identical {_same(sl, rl, sp_, rp)}")
    if dl > ZERO_TOL[0] or dpar > ZERO_TOL[1]:
        raise AssertionError(f"plan ZeRO differs from the stacked Adam step: {dl:.3e}, {dpar:.3e}")
    real = tz.fused_adam_tree
    tz.fused_adam_tree = lambda p, g, m, v, alpha, *a, **k: real(p, g, m, v, alpha * 0.9, *a, **k)
    try:
        bp, _, bl = plan_run(serial)
    finally:
        tz.fused_adam_tree = real
    bdl, bdp = abs(bl[1] - rl[1]) / abs(rl[1]), _param_err(bp, rp)
    log(f"  plan planted fault (alpha x 0.9): second loss {bdl:.3e}, params {bdp:.3e} apart")
    if bdl <= ZERO_TOL[0] or bdp <= ZERO_TOL[1]:
        raise AssertionError("the planted fault passes a ZeRO limit")
    del sp_, rp, bp, px, py, stacked
    torch.cuda.empty_cache()
    errs = _pp_kernel_checks(gen, (dp, 1, pp, batch // 2))
    torch.cuda.empty_cache()

    # the SSM block: 4 stacked sequence ranks against the local scan
    sh = SSM_SHAPE
    sparams = tm.init_params(0, tm.SSMConfig(d_model=sh["d_model"], d_state=sh["d_state"]),
                             DEVICE)
    sx = randn((sh["T"], sh["d_model"]), gen)
    smesh = make_mesh_1d("seq", sh["ranks"], DEVICE)
    sharded = run_spmd(smesh, lambda p, xx: tm.ssm_block(p, xx, "seq"), (P(), P("seq")),
                       P("seq"))
    want = tm.ssm_block(sparams, sx, None)
    got = sharded(sparams, sx)
    scale = float(want.abs().max())
    err = max_err(got, want) / scale
    ms = {"sharded": device_ms(lambda: sharded(sparams, sx), 5),
          "local": device_ms(lambda: tm.ssm_block(sparams, sx, None), 5)}
    cut = run_spmd(smesh, lambda p, xx: tm.ssm_block(p, xx, None), (P(), P("seq")), P("seq"))
    fault = max_err(cut(sparams, sx), want) / scale
    log(f"  ssm_block T={sh['T']} d_model={sh['d_model']} d_state={sh['d_state']} on "
        f"{sh['ranks']} stacked ranks against the local scan: {err:.3e} of max|want| "
        f"{scale:.3f} (limit {SSM_TOL:g}); the carry dropped reads {fault:.3e}; device ms "
        f"sharded {ms['sharded']:.3f}, local {ms['local']:.3f}")
    if not err <= SSM_TOL or fault <= SSM_TOL:
        raise AssertionError(f"ssm_block sharded {err:.3e}, carry dropped {fault:.3e}")
    return total, errs


def phase26_configs11pp_14() -> list:
    """Config 11's pp row and config 14 through ``bench.record`` (steps and
    repeats cut, each cut in the row's ``reduced``), then the bubble bench at
    M = 4, 8 and 32 on 4 stacked stages."""
    from tpuscratch_torch.bench.pipeline_bench import bench_pipeline_bubble
    from tpuscratch_torch.bench.record import config11_pp_row, config14_plan_overlap

    out: list = []
    config11_pp_row(out, iters=1, steps=PP_STEPS, device=DEVICE)
    torch.cuda.empty_cache()
    config14_plan_overlap(out, iters=1, steps=PP_STEPS, device=DEVICE)
    torch.cuda.empty_cache()
    for r in out:
        log(f"  config {r['config']} {r['metric']}: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()
            if k not in ("config", "metric", "platform")))
        keys = [k for k in r if k.startswith("tokens_per_s")] + ["value"]
        if not all(math.isfinite(r[k]) and r[k] > 0 for k in keys):
            raise AssertionError(f"config {r['config']} {r['metric']}: {r}")
    for M in (4, 8, 32):
        b = bench_pipeline_bubble(n_micro=M, device=DEVICE)
        log(f"  {b.summary()}")
        if not (b.proxy and math.isfinite(b.measured_bubble) and b.wall_s > 0):
            raise AssertionError(f"bubble bench M={M}: {b}")
    return out


# Phase 27: the solvers at the JAX package's chip sizes.
OMEGA3 = 6 / 7                  # multigrid3d's Jacobi damping: the streamed smoother's weights
CG_TOL = 1e-5
# 2D multigrid at 1024^2: f32 cannot hold the residual much under 1e-5 of
# ||b|| there (a tol 1e-6 solve stagnates at 9.9e-6 on the CPU port), so
# the solve asks for 1e-5; 3D at 256^3 reaches 1e-6 (6.6e-7 on the CPU).
MG2_TOL, MG3_TOL = 1e-5, 1e-6
# Sizes: CG at 1024^2 on 1x1 (the geometry the JAX program cache names) and
# 256^2 on 1x1 and 2x2 (config 15's CG geometry); 2D multigrid at 1024^2;
# 3D at 256^3 (mg3d_chip's N) and 512x256x256 on 2x1x1; the spectral
# solve at 4096^2 and 256^3; the pair transforms at 1024^2 and 8192^2.
CG_SIZES, MG2_N, MG3_N, SPECTRAL2_N, FFT_SIZES = (1024, 256), 1024, 256, 4096, (1024, 8192)
# The float64 oracle's residual ||A x - b|| against c * tol * ||b||. Classic
# CG stops on its recurrence residual (<= tol), and the true one drifts from
# it with the rounding of every update of x: 26.6 tol after 2152 iterations
# at 1024^2, the same in the JAX package and the port on the CPU. Pipelined
# CG refreshes its residual every 96 iterations (the JAX test's own 10 tol);
# multigrid and MG-PCG measure the true residual (the JAX tests' 2.5 tol).
ORACLE_C = {"cg": 50.0, "pipelined": 10.0, "mg": 2.5}
# Rounding the exact solution to f32 alone leaves a residual of up to
# ||A|| u ||x|| / ||b|| (||A|| = 8 in 2D, 12 in 3D, u = 2^-24): the f32
# floor, _f32_floor. At 1024^2 in 2D it is as large as 2.5 tol, so the 2D
# multigrid solves are held to 2.5 tol plus the floor, and a solve stopped
# short (MG three cycles, MG-PCG two iterations before its own stop, which
# leaves ~2e-4) must break that limit. A spectral solve's residual is the
# floor, and the transforms' products add some multiples of it.
SPECTRAL_C = 16.0
SHORT_2D = {"mg_poisson_solve": ("max_cycles", 3), "pcg_poisson_solve": ("max_iters", 2)}
PIPELINED_ITERS = 0.03        # pipelined CG's iterations, 2x2 against 1x1
CYCLES_3D = (4, 14)             # the JAX tests' cycle counts in 3D
SOLVER_XTOL = 1e-4              # solutions held to each other, of max|x|


def _lap3_np(x: np.ndarray) -> np.ndarray:
    """The periodic 7-point operator in numpy (the JAX tests' oracle)."""
    return 6 * x - sum(np.roll(x, s, a) for a in range(3) for s in (1, -1))


def _held_to_oracle(what, lap, x, b, limit) -> float:
    """The relative residual of ``x`` under ``lap`` in float64; raises past
    ``limit``."""
    x64 = x.astype(np.float64)
    rel = float(np.linalg.norm(lap(x64) - b) / np.linalg.norm(b))
    log(f"    {what}: float64 oracle ||Ax - b|| / ||b|| {rel:.3e} (limit {limit:.3e})")
    if not (math.isfinite(rel) and rel <= limit):
        raise AssertionError(f"{what}: oracle residual {rel:.3e} > {limit:.3e}")
    return rel


def _f32_floor(x, b, norm_a) -> float:
    return norm_a * 2.0**-24 * float(np.linalg.norm(x.astype(np.float64)) / np.linalg.norm(b))


def _spectral_limit(x, b, norm_a) -> float:
    return SPECTRAL_C * _f32_floor(x, b, norm_a)


def _close(what, x, ref, tol=SOLVER_XTOL) -> float:
    d = float(np.abs(x - ref).max() / np.abs(ref).max())
    log(f"    {what}: max|x - x'| / max|x'| {d:.3e} (limit {tol:g})")
    if not d <= tol:
        raise AssertionError(f"{what}: {d:.3e} > {tol:g}")
    return d


def _within(what, a, b, slack: int = 1) -> None:
    log(f"    {what}: {a} against {b} (within {slack})")
    if abs(a - b) > slack:
        raise AssertionError(f"{what}: {a} against {b}")


def _solve(what, fn):
    """``fn()``, a solver's ``(x, iterations, relres)`` or a direct
    solver's ``x``, timed on the host (a solve ends by copying x to the
    host); returns ``(x, iterations, relres)``, None for a direct solve."""
    t0 = time.perf_counter()
    out = fn()
    s = time.perf_counter() - t0
    x, k, rel = out if isinstance(out, tuple) else (out, None, None)
    log(f"  {what}: {s:.3f} s" + ("" if k is None else f", {k} iterations, relres {rel:.3e}"))
    return x, k, rel


def _stream_at_solver_shapes(gen) -> float:
    """Row 9's kernel against its plain version as the streamed smoother
    calls it: z-slab cores of 256^3 (1x1x1 and 2x1x1) and 128^3, depth 2
    (nu 2), the rhs term, weights (omega/6,)*6 + (1 - omega,). Bit-equal."""
    from tpuscratch_torch.ops import stencil_stream as ss

    coeffs, rc, k = (OMEGA3 / 6.0,) * 6 + (1.0 - OMEGA3,), OMEGA3 / 6.0, 2
    worst = 0.0
    for lead, shape in (((1, 1, 1), (MG3_N,) * 3), ((2, 1, 1), (MG3_N,) * 3),
                        ((1, 1, 1), (MG3_N // 2,) * 3)):
        cz, cy, cx = shape
        a = (randn(lead + shape, gen), randn(lead + (k, cy, cx), gen),
             randn(lead + (k, cy, cx), gen))
        rhs = randn(lead + (cz + 2 * k, cy, cx), gen)
        flags = torch.zeros(lead + (6,), dtype=torch.int32, device=DEVICE)
        kernel = lambda: ss.seven_point_streamed_pallas(*a, shape, coeffs, k, rhs=rhs,  # noqa: E731
                                                        rhs_coeff=rc)
        plain = lambda: ss.seven_point_streamed_plain(*a, coeffs, k, flags, rhs=rhs,  # noqa: E731
                                                      rhs_coeff=rc)
        got, want = kernel(), plain()
        err, bits = max_err(got, want), same_bits(got, want)
        cells = got.numel()
        b, by = bound((2 * cells + a[1].numel() + a[2].numel() + rhs.numel()) * 4, 15 * cells * k,
                      F32_SEPARATE_OPS_PER_S)
        log(f"  seven_point_streamed_pallas {lead}+{cz}^3 k={k} rhs: max_abs_err {err:.3e}, "
            f"bit-equal {bits}; {device_ms(kernel, 10):.4f} ms (bound {b:.4f} by {by}, plain "
            f"{device_ms(plain, 3):.4f})")
        if not bits:
            raise AssertionError(f"the streamed kernel at the solver's {lead}+{shape}: {err:.3e}")
        worst = max(worst, err)
    return worst


def _cg_and_mg_2d() -> None:
    """CG and pipelined CG at 1024^2 (1x1) and 256^2 (1x1, 2x2); multigrid
    and MG-PCG at 1024^2 on 1x1 and 2x2, held to the oracle, to each other
    and to the spectral solve."""
    from tpuscratch_torch.runtime.mesh import make_mesh_2d
    from tpuscratch_torch.solvers import (mg_poisson_solve, pcg_poisson_solve,
                                          periodic_poisson_fft, poisson_solve)
    from tpuscratch_torch.solvers.cg import laplacian_apply_np
    from tpuscratch_torch.solvers.spectral import periodic_laplacian_np

    rng = np.random.default_rng(SEED)
    for n in CG_SIZES:
        b = rng.standard_normal((n, n)).astype(np.float32)
        meshes = ((1, 1),) if n == CG_SIZES[0] else ((1, 1), (2, 2))
        for method in ("cg", "pipelined"):
            iters = {}
            for shape in meshes:
                x, iters[shape], rel = _solve(
                    f"poisson_solve {n}^2 {shape[0]}x{shape[1]} method={method} tol {CG_TOL:g}",
                    lambda: poisson_solve(b, make_mesh_2d(shape, DEVICE), tol=CG_TOL,
                                          method=method))
                if not rel <= CG_TOL:
                    raise AssertionError(f"{method}: relres {rel:.3e} > tol")
                _held_to_oracle(method, laplacian_apply_np, x, b, ORACLE_C[method] * CG_TOL)
            if len(meshes) > 1:
                # pipelined CG's restarted recurrence turns a reduction's
                # rounding into iterations: the JAX package on the CPU takes
                # 1219 on 1x1 and 1232 on 2x2 at 256^2, so it gets 3%
                slack = 1 if method == "cg" else math.ceil(PIPELINED_ITERS * iters[(1, 1)])
                _within(f"{method} iterations 2x2 against 1x1", iters[(2, 2)], iters[(1, 1)],
                        slack)
    b = rng.standard_normal((MG2_N, MG2_N)).astype(np.float32)
    b -= b.mean()
    x_sp = _solve(f"periodic_poisson_fft {MG2_N}^2 xla (the reference for MG)",
                  lambda: periodic_poisson_fft(b, impl="xla", device=DEVICE))[0]
    for name, fn in (("mg_poisson_solve", mg_poisson_solve),
                     ("pcg_poisson_solve", pcg_poisson_solve)):
        runs = {}
        for shape in ((1, 1), (2, 2)):
            x, k, rel = _solve(f"{name} {MG2_N}^2 {shape[0]}x{shape[1]} tol {MG2_TOL:g}",
                                  lambda: fn(b, make_mesh_2d(shape, DEVICE), tol=MG2_TOL))
            runs[shape] = x, k
            _held_to_oracle(name, periodic_laplacian_np, x, b,
                            ORACLE_C["mg"] * MG2_TOL + _f32_floor(x, b, 8))
            _close(f"{name} against spectral", x, x_sp)
        _within(f"{name} iterations 2x2 against 1x1", runs[(2, 2)][1], runs[(1, 1)][1])
        cap, fewer = SHORT_2D[name]
        short = max(1, runs[(1, 1)][1] - fewer)
        with warnings.catch_warnings():  # the short solve warns that it stopped above tol
            warnings.simplefilter("ignore", RuntimeWarning)
            x = _solve(f"{name} stopped short, {cap}={short}",
                       lambda: fn(b, make_mesh_2d((1, 1), DEVICE), tol=MG2_TOL,
                                  **{cap: short}))[0]
        try:
            _held_to_oracle(f"{name} stopped short", periodic_laplacian_np, x, b,
                            ORACLE_C["mg"] * MG2_TOL + _f32_floor(x, b, 8))
        except AssertionError as e:
            log(f"    caught, as it must be: {e}")
        else:
            raise AssertionError(f"{name} stopped {fewer} short of its stop passes the limit")


def _mg_3d() -> int:
    """3D multigrid at 256^3 with every smoother and s_step 2, the streamed
    smoother on 2x1x1 (512x256x256) against 1x1x1, MG-PCG, and the spectral
    solve; row 9's launches in each ``jacobi-stream`` solve held to the
    rule's count. Returns those launches."""
    from tpuscratch_torch.ops import stencil_stream as ss
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.solvers import (mg_poisson3d_solve, pcg_poisson3d_solve,
                                          periodic_poisson3d_fft)
    from tpuscratch_torch.solvers.multigrid3d import (_mg_prologue3, _stream_smoothable,
                                                      stream_launches)

    axes = ("z", "row", "col")
    rng = np.random.default_rng(SEED + 1)
    total = 0

    def mg3(b, dims, smoother, s_step=1):
        nonlocal total
        mesh = make_mesh(dims, axes, DEVICE)
        ss.reset_launches()
        x, k, rel = _solve(
            f"mg_poisson3d_solve {'x'.join(map(str, b.shape))} on {'x'.join(map(str, dims))} "
            f"smoother={smoother} s_step={s_step} tol {MG3_TOL:g}",
            lambda: mg_poisson3d_solve(b, mesh, tol=MG3_TOL, smoother=smoother, s_step=s_step))
        n = ss.seven_point_streamed_pallas.launches
        if smoother == "jacobi-stream":
            specs = _mg_prologue3(b, mesh, None)[2]
            want = stream_launches(specs) * k
            levels = [i for i, (s6, _) in enumerate(specs) if _stream_smoothable(s6, 2)]
            log(f"    stream3d_kernel launches {n} (the rule: {stream_launches(specs)} a cycle, "
                f"levels {levels} stream, x {k} cycles = {want})")
            if n != want or n == 0:
                raise AssertionError(f"jacobi-stream launched the kernel {n} times, want {want}")
            total += n
        elif n:
            raise AssertionError(f"smoother {smoother} launched the streamed kernel {n} times")
        if not (CYCLES_3D[0] <= k <= CYCLES_3D[1] and rel <= 2.5 * MG3_TOL):
            raise AssertionError(f"mg3d {smoother}: {k} cycles, relres {rel:.3e}")
        _held_to_oracle("mg_poisson3d_solve", _lap3_np, x, b, ORACLE_C["mg"] * MG3_TOL)
        return x, k

    b = rng.standard_normal((MG3_N,) * 3).astype(np.float32)
    b -= b.mean()
    runs = {sm: mg3(b, (1, 1, 1), sm) for sm in ("rbgs", "jacobi", "jacobi-stream")}
    xs2, ks2 = mg3(b, (1, 1, 1), "rbgs", s_step=2)
    # the deep smoother runs the per-sweep one's ops in its order: the same bits
    same = np.array_equal(xs2, runs["rbgs"][0])
    log(f"    s_step 2 against 1: cycles {ks2} / {runs['rbgs'][1]}, bit-identical {same}")
    if ks2 != runs["rbgs"][1] or not same:
        raise AssertionError("s_step 2 is not bit-identical to s_step 1")
    _within("jacobi-stream cycles against jacobi", runs["jacobi-stream"][1],
                runs["jacobi"][1])
    _close("jacobi-stream against jacobi", runs["jacobi-stream"][0], runs["jacobi"][0])
    x_sp = _solve(f"periodic_poisson3d_fft {MG3_N}^3 xla (the reference for MG)",
                  lambda: periodic_poisson3d_fft(b, impl="xla", device=DEVICE))[0]
    for sm, (x, _) in runs.items():
        _close(f"mg3d {sm} against spectral", x, x_sp)
    x, k, rel = _solve(f"pcg_poisson3d_solve {MG3_N}^3 tol {MG3_TOL:g}",
                          lambda: pcg_poisson3d_solve(b, device=DEVICE, tol=MG3_TOL))
    _held_to_oracle("pcg_poisson3d_solve", _lap3_np, x, b, ORACLE_C["mg"] * MG3_TOL)
    _close("pcg3d against spectral", x, x_sp)
    del runs, x_sp
    b = rng.standard_normal((2 * MG3_N, MG3_N, MG3_N)).astype(np.float32)
    b -= b.mean()
    x2, k2 = mg3(b, (2, 1, 1), "jacobi-stream")
    x1, k1 = mg3(b, (1, 1, 1), "jacobi-stream")
    _within("jacobi-stream cycles 2x1x1 against 1x1x1", k2, k1)
    _close("jacobi-stream 2x1x1 against 1x1x1", x2, x1)
    return total


def _spectral_and_fft() -> None:
    """The spectral solvers (4096^2 on 1 and 4 ranks, 256^3, both impls)
    against the oracle and each other; the pair transforms against
    complex128 at 1024^2 and 8192^2, and a planted TF32 run that
    PAIR_FFT_TOL must catch."""
    from tpuscratch_torch.bench.fft_bench import forward_error
    from tpuscratch_torch.comm import P, run_spmd
    from tpuscratch_torch.parallel import fft as pfft
    from tpuscratch_torch.parallel.fft import PAIR_FFT_TOL, fft2_sharded_pair
    from tpuscratch_torch.runtime.mesh import make_mesh_1d
    from tpuscratch_torch.solvers import periodic_poisson3d_fft, periodic_poisson_fft
    from tpuscratch_torch.solvers.spectral import periodic_laplacian_np

    rng = np.random.default_rng(SEED + 2)
    b = rng.standard_normal((SPECTRAL2_N,) * 2).astype(np.float32)
    b -= b.mean()
    ref = None
    for impl in ("xla", "dft"):
        for n in (1, 4):
            x = _solve(f"periodic_poisson_fft {SPECTRAL2_N}^2 on {n} ranks impl={impl}",
                       lambda: periodic_poisson_fft(b, make_mesh_1d("x", n, DEVICE), impl=impl))[0]
            _held_to_oracle("periodic_poisson_fft", periodic_laplacian_np, x, b,
                            _spectral_limit(x, b, 8))
            if ref is None:
                ref = x
            else:
                _close(f"impl={impl} on {n} ranks against xla on 1", x, ref)
    b = rng.standard_normal((MG3_N,) * 3).astype(np.float32)
    b -= b.mean()
    ref = None
    for impl in ("xla", "dft"):
        x = _solve(f"periodic_poisson3d_fft {MG3_N}^3 impl={impl}",
                   lambda: periodic_poisson3d_fft(b, impl=impl, device=DEVICE))[0]
        _held_to_oracle("periodic_poisson3d_fft", _lap3_np, x, b, _spectral_limit(x, b, 12))
        if ref is None:
            ref = x
        else:
            _close("impl=dft against xla", x, ref)
    del b, ref, x

    mesh = make_mesh_1d("x", 1, DEVICE)

    def fwd_err(n, method):
        g = torch.Generator(device=DEVICE).manual_seed(n)
        re, im = randn((n, n), g), randn((n, n), g)
        prog = run_spmd(mesh, lambda r, i: fft2_sharded_pair(r, i, "x", method=method),
                        (P("x"), P("x")), (P("x"), P("x")))
        return forward_error(prog(re, im), re, im)

    for n in FFT_SIZES:
        for method in ("direct", "four-step"):
            err = fwd_err(n, method)
            log(f"  fft2_sharded_pair {n}^2 {method}: max|got - want| / max|want| {err:.3e} "
                f"against complex128 torch.fft (limit {PAIR_FFT_TOL:g})")
            if not err <= PAIR_FFT_TOL:
                raise AssertionError(f"pair FFT {method} at {n}^2: {err:.3e}")
            torch.cuda.empty_cache()
    # with TF32 on the pair transform refuses to run; with that refusal
    # taken out, its TF32 products must break PAIR_FFT_TOL
    tf32, guard = torch.backends.cuda.matmul.allow_tf32, pfft._require_f32_products
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        try:
            fwd_err(FFT_SIZES[0], "direct")
        except RuntimeError as e:
            log(f"  TF32 on: the pair transform refuses ({str(e)[:60]}...)")
        else:
            raise AssertionError("the pair transform ran with TF32 products allowed")
        pfft._require_f32_products = lambda x: None
        planted = {m: fwd_err(FFT_SIZES[0], m) for m in ("direct", "four-step")}
    finally:
        torch.backends.cuda.matmul.allow_tf32, pfft._require_f32_products = tf32, guard
    log(f"  planted TF32 products at {FFT_SIZES[0]}^2 (refusal taken out): {planted} "
        f"(each must exceed {PAIR_FFT_TOL:g})")
    if min(planted.values()) <= PAIR_FFT_TOL:
        raise AssertionError("a TF32 pair transform passes PAIR_FFT_TOL")


def phase27_solvers(gen) -> tuple[int, float]:
    """The solvers (module comment). Returns row 9's launches on the
    solver path and its worst error against the plain version."""
    from tpuscratch_torch.bench.mg3d_chip import SMOOTHERS, profile_cycles, race
    from tpuscratch_torch.bench.record import config8_dft

    t0 = time.perf_counter()

    def lap(what: str) -> None:
        log(f"  [{what} done at {time.perf_counter() - t0:.1f} s of phase 27]")

    err = _stream_at_solver_shapes(gen)
    torch.cuda.empty_cache()
    lap("the kernel at the solver's shapes")
    _cg_and_mg_2d()
    lap("CG and 2D multigrid")
    launches = _mg_3d()
    torch.cuda.empty_cache()
    lap("3D multigrid")
    _spectral_and_fft()
    torch.cuda.empty_cache()
    lap("spectral and the pair FFT")
    out: list = []
    # one timed call a point (record's default 3) of at most 100 round trips (record's 1000)
    res = config8_dft(out, iters=1, device=DEVICE, max_rounds=100)
    for n, point in res["race"].items():
        log(f"  config 8 at {n}^2: " + ", ".join(
            f"{m} {s * 1e3:.4f} ms" for m, s in point["s_per_roundtrip"].items())
            + f", winner {point.get('winner')}")
        if point.get("errors") or len(point["s_per_roundtrip"]) != 2:
            raise AssertionError(f"config 8 at {n}^2: {point}")
    tflops = out[0]["value"]
    log(f"  config 8 pair_dft_roundtrip_tflops {tflops:.3f} ({res['headline'].summary()}; "
        f"f32 bound {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s)")
    if not (math.isfinite(tflops) and tflops > 0):
        raise AssertionError(f"config 8: {out[0]}")
    lap("config 8")
    ms = race(MG3_N, device=DEVICE)
    log(f"  mg3d_chip at {MG3_N}^3: " + ", ".join(f"{k} {v:.3f} ms/V-cycle" for k, v in ms.items()))
    if not all(math.isfinite(v) and v > 0 for v in ms.values()):
        raise AssertionError(f"mg3d_chip: {ms}")
    lap("mg3d_chip's race")
    for sm in SMOOTHERS:
        p = profile_cycles(MG3_N, sm, device=DEVICE)
        log(f"  a V-cycle's profile, {sm}: {p['cycle_ms']:.3f} ms a cycle, device "
            f"{p['device_ms']:.3f} ms (idle share {p['idle_share']:.3f}), "
            f"{p['launches_per_cycle']:.0f} launches; by group " + ", ".join(
                f"{g} {v:.3f}" for g, v in p["groups_ms"].items()) + "; top " + ", ".join(
                f"{k} {v:.3f}" for k, v in p["top_ms"][:5]))
    log(f"  phase 27 took {time.perf_counter() - t0:.1f} s")
    return launches, err


# ---- phase 28: the fault-tolerant chunked path ----------------------------------------

FT_WORLD, FT_STEPS, FT_EVERY = 1024, 1024, 256   # halo: 1024^2, a save every 256 steps
FT_IMPLS = {"resident:8": ("resident_periodic_pallas", 1),   # launches a chunk (the rule)
            "deep-pallas:16": ("deep_trapezoid_pallas", FT_EVERY // 16)}
FT_TRAIN_STEPS, FT_TRAIN_EVERY, FT_TRAIN_BATCH = 6, 3, 2
FT_SOLVE_CHUNK = 3

# the child: the port's driver, ended with os._exit after its second save
FT_CHILD = r"""
import os, sys
import numpy as np
from tpuscratch_torch.halo.driver import checkpointed_stencil

class ExitAfterSecondSave:
    enabled = True
    saves = 0
    def emit(self, event, **fields):
        if event == "ckpt/save":
            ExitAfterSecondSave.saves += 1
            if ExitAfterSecondSave.saves == 2:
                os._exit(17)
    def emit_metrics(self, *a, **k): pass
    def flush(self): pass
    def close(self): pass

world = np.load(sys.argv[1])
checkpointed_stencil(world, int(sys.argv[3]), sys.argv[2], save_every=int(sys.argv[4]),
                     impl=sys.argv[5], keep=8, sink=ExitAfterSecondSave(), device=sys.argv[6])
raise SystemExit("the driver finished without being ended")
"""


class _SaveLog:
    """A sink that logs every checkpoint event's bytes and seconds and keeps
    the events."""

    enabled = True

    def __init__(self, label: str):
        self.label, self.events = label, []

    def emit(self, event: str, **f) -> None:
        self.events.append({"event": event, **f})
        if event in ("ckpt/save", "ckpt/snapshot", "ckpt/write"):
            b = f.get("bytes", 0)
            copy = (f", its device-to-host copy {f['copy_device_s']:.4f} s on the device"
                    if "copy_device_s" in f else "")
            log(f"    {self.label} {event} step {f.get('step')}: {b / 1e6:.1f} MB in "
                f"{f['wall_s']:.4f} s ({b / max(f['wall_s'], 1e-9) / 1e9:.2f} GB/s){copy}")

    def emit_metrics(self, *a, **k) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _same_dirs(a: pathlib.Path, b: pathlib.Path) -> int:
    """Every file of two checkpoint directories byte for byte; returns the
    files compared."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    if fa != fb or not fa:
        raise AssertionError(f"checkpoint files differ: {fa} / {fb}")
    for rel in fa:
        if (a / rel).read_bytes() != (b / rel).read_bytes():
            raise AssertionError(f"async checkpoint {rel} differs from the blocking one")
    return len(fa)


def _ft_halo(tmp: pathlib.Path) -> dict:
    """(a): checkpointed_stencil killed in a child after its second save and
    resumed here, against the uninterrupted run, distributed_stencil and the
    async run's checkpoints; rows 3 and 4 held to the rule's launches."""
    from tpuscratch_torch.halo.driver import checkpointed_stencil, distributed_stencil
    from tpuscratch_torch.ops import stencil_kernel as sk
    from tpuscratch_torch.runtime import checkpoint

    world = np.random.default_rng(SEED + 28).standard_normal((FT_WORLD,) * 2).astype(np.float32)
    np.save(tmp / "world.npy", world)
    root = pathlib.Path(__file__).resolve().parent
    children = {impl: subprocess.Popen(
        [sys.executable, "-c", FT_CHILD, str(tmp / "world.npy"), str(tmp / f"killed_{impl}"),
         str(FT_STEPS), str(FT_EVERY), impl, DEVICE], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for impl in FT_IMPLS}
    chunks = FT_STEPS // FT_EVERY
    launches = {}

    def counted(name, per, n_chunks, what, fn):
        sk.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        n = sk.launch_counts()[name]
        log(f"  {what}: {time.perf_counter() - t0:.3f} s, {name} launched {n} "
            f"(the rule: {per} x {n_chunks} chunks)")
        if n != per * n_chunks:
            raise AssertionError(f"{what}: {name} launched {n}, want {per * n_chunks}")
        launches[name] = launches.get(name, 0) + n
        return out

    for impl, (name, per) in FT_IMPLS.items():
        base, _, arg = impl.partition(":")
        halo = (int(arg),) * 2 if base.startswith("deep") else (1, 1)
        whole = counted(name, per if base.startswith("deep") else 1,
                        chunks if base.startswith("deep") else 1,
                        f"distributed_stencil {FT_WORLD}^2 x{FT_STEPS} impl={impl}",
                        lambda: distributed_stencil(world, FT_STEPS, halo=halo, impl=base,
                                                    device=DEVICE))
        outs = {}
        for mode in ("blocking", "async"):
            sink = _SaveLog(f"{impl} {mode}")
            outs[mode] = counted(
                name, per, chunks, f"checkpointed_stencil impl={impl} {mode}, a save every "
                f"{FT_EVERY}",
                lambda: checkpointed_stencil(world, FT_STEPS, str(tmp / f"{mode}_{impl}"),
                                             save_every=FT_EVERY, impl=impl, keep=chunks,
                                             sink=sink, async_ckpt=mode == "async",
                                             device=DEVICE))
        files = _same_dirs(tmp / f"blocking_{impl}", tmp / f"async_{impl}")
        log(f"  {impl}: the async run's {files} checkpoint files are byte-identical to the "
            f"blocking run's")
        child = children[impl]
        _, err = child.communicate(timeout=300)
        at = checkpoint.latest_step(tmp / f"killed_{impl}")
        log(f"  the child ended with code {child.returncode} at step {at}")
        if child.returncode != 17 or at != 2 * FT_EVERY:
            raise AssertionError(f"the killed child: code {child.returncode}, step {at}: {err[-2000:]}")
        resumed = counted(name, per, chunks - 2, f"resumed {impl} from step {at} here",
                          lambda: checkpointed_stencil(world, FT_STEPS, str(tmp / f"killed_{impl}"),
                                                       save_every=FT_EVERY, impl=impl,
                                                       device=DEVICE))
        for label, ref in (("the uninterrupted run", outs["blocking"]),
                           ("the async run", outs["async"]),
                           (f"distributed_stencil impl={base}", whole)):
            same = np.array_equal(resumed, ref)
            log(f"  {impl} resumed against {label}: bit-identical {same}")
            if not same:
                raise AssertionError(f"{impl}: the resumed run differs from {label}: "
                                     f"{float(np.abs(resumed - ref).max()):.3e}")
        if not np.isfinite(resumed).all():
            raise AssertionError(f"{impl}: non-finite cells")
    return launches


def _params_same(a, b) -> bool:
    from tpuscratch_torch.runtime.checkpoint import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _ft_train(tmp: pathlib.Path) -> tuple[dict, list]:
    """(b): the trainer at config 11's width (batch cut to 2): SGD clean, a
    NaN rolled back, a preemption under supervise_train; ZeRO Adam on 2
    stacked dp ranks with async saves, preempted once. Returns the flash and
    fused Adam launches and the ``reduced`` list."""
    import dataclasses
    import shutil

    from tpuscratch_torch.bench.train_bench import default_train_setup
    from tpuscratch_torch.ft import ChaosPlan, Fault, GuardPolicy, supervise_train
    from tpuscratch_torch.models.trainer import train
    from tpuscratch_torch.obs.metrics import MetricsRegistry
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta
    from tpuscratch_torch.runtime.mesh import make_mesh

    cfg, batch, seq, _ = default_train_setup(on_card=True)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    reduced = [f"batch {batch} -> {FT_TRAIN_BATCH}", f"steps -> {FT_TRAIN_STEPS}"]
    kw = dict(save_every=FT_TRAIN_EVERY, batch=FT_TRAIN_BATCH, seq=seq, keep=1, lr=1e-3, seed=3)
    launches = {"_flash_fwd_call": 0, "_flash_bwd_call": 0, "fused_adam_flat": 0}

    def run(what, fn, d, steps_run, layers, adam_steps=0):
        ta.reset_launches()
        tadam.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        got = {**ta.launch_counts(), **tadam.launch_counts()}
        want = layers * steps_run
        log(f"  {what}: {wall:.3f} s, {steps_run} steps run; launches fwd "
            f"{got['_flash_fwd_call']} bwd {got['_flash_bwd_call']} (the rule: {layers} layers x "
            f"{steps_run} steps = {want}), fused Adam {got['fused_adam_flat']}")
        if (got["_flash_fwd_call"], got["_flash_bwd_call"]) != (want, want):
            raise AssertionError(f"{what}: flash launches {got}, want {want}")
        if adam_steps and got["fused_adam_flat"] != adam_steps:
            raise AssertionError(f"{what}: fused Adam launched {got['fused_adam_flat']}, "
                                 f"want {adam_steps}")
        for k in launches:
            launches[k] += got[k]
        shutil.rmtree(d, ignore_errors=True)
        return out

    mesh = make_mesh((1, 1), ("dp", "sp"), DEVICE)
    n = FT_TRAIN_STEPS
    sink = _SaveLog("sgd clean")
    clean, rep = run("SGD clean, 1x1", lambda: train(mesh, cfg, n, str(tmp / "sgd"), obs=sink,
                                                       **kw), tmp / "sgd", n, cfg.n_layers)
    if not all(math.isfinite(v) for v in rep.losses):
        raise AssertionError(f"SGD losses {rep.losses}")
    compiles = [e["compiles"] for e in sink.events if e["event"] == "train/run"]
    compile_s = sum(e["compile_s"] for e in sink.events if "compile_s" in e)
    log(f"    losses {rep.losses}; step builds {compiles} (one a run by construction); "
        f"compile_s {compile_s} (no kernel library loaded in the run)")
    if compile_s != 0:
        raise AssertionError(f"the trainer booked {compile_s} s of kernel builds")
    plan = ChaosPlan(0, [Fault("train/grad", at=(4,), kind="nan")])
    healed, rep = run("SGD, a NaN at step 4 under GuardPolicy(max_skips=0, max_rollbacks=1)",
                      lambda: train(mesh, cfg, n, str(tmp / "nan"), chaos=plan,
                                    guard=GuardPolicy(max_skips=0, max_rollbacks=1),
                                    obs=_SaveLog("sgd nan"), **kw),
                      tmp / "nan", n + FT_TRAIN_EVERY, cfg.n_layers)
    same = _params_same(healed, clean)
    log(f"    skipped {rep.skipped}, rollbacks {rep.rollbacks}; bit-identical to the clean run "
        f"{same}")
    if not (same and rep.skipped == 1 and rep.rollbacks == 1):
        raise AssertionError(f"the NaN rollback: {rep}, bit-identical {same}")
    del healed
    metrics = MetricsRegistry()
    plan = ChaosPlan(0, [Fault("train/preempt", at=(FT_TRAIN_EVERY,), kind="preempt")])
    resumed, rep = run(f"SGD preempted after the step-{FT_TRAIN_EVERY} save, under "
                       "supervise_train",
                       lambda: supervise_train(mesh, cfg, n, str(tmp / "pre"), chaos=plan,
                                               metrics=metrics, obs=_SaveLog("sgd preempted"),
                                               **kw), tmp / "pre", n, cfg.n_layers)
    restarts = int(metrics.counter("ft/restarts").value)
    same = _params_same(resumed, clean)
    log(f"    restarts {restarts}; bit-identical to the clean run {same}")
    if not (same and restarts == 1):
        raise AssertionError(f"the preempted run: restarts {restarts}, bit-identical {same}")
    del resumed, clean
    torch.cuda.empty_cache()

    zmesh = make_mesh((2, 1), ("dp", "sp"), DEVICE)
    zkw = dict(kw, optimizer="adam", zero=True, lr=1e-4)
    zclean, _ = run("ZeRO Adam clean, dp 2 stacked",
                    lambda: train(zmesh, cfg, n, str(tmp / "zclean"),
                                  obs=_SaveLog("zero clean"), **zkw),
                    tmp / "zclean", n, cfg.n_layers, adam_steps=n)
    metrics = MetricsRegistry()
    plan = ChaosPlan(0, [Fault("train/preempt", at=(FT_TRAIN_EVERY,), kind="preempt")])
    zres, _ = run("ZeRO Adam dp 2, async saves, preempted once",
                  lambda: supervise_train(zmesh, cfg, n, str(tmp / "zpre"), chaos=plan,
                                          metrics=metrics, obs=_SaveLog("zero async"),
                                          async_ckpt=True, **zkw),
                  tmp / "zpre", n, cfg.n_layers, adam_steps=n)
    restarts = int(metrics.counter("ft/restarts").value)
    same = _params_same(zres, zclean)
    log(f"    restarts {restarts}; bit-identical to the clean ZeRO run {same}")
    if not (same and restarts == 1):
        raise AssertionError(f"the preempted ZeRO run: restarts {restarts}, bit-identical {same}")
    return launches, reduced


def _ft_solver(tmp: pathlib.Path) -> int:
    """(c): supervised_mg3d_solve at 256^3, jacobi-stream, preempted after
    its second chunk, against checkpointed_mg3d_solve with no fault; row 9's
    launches held to stream_launches x the cycles run."""
    from tpuscratch_torch.ft import ChaosPlan, Fault
    from tpuscratch_torch.obs.metrics import MetricsRegistry
    from tpuscratch_torch.ops import stencil_stream as ss
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.solvers.multigrid3d import _mg_prologue3, stream_launches
    from tpuscratch_torch.solvers.runner import checkpointed_mg3d_solve, supervised_mg3d_solve

    b = np.random.default_rng(SEED + 29).standard_normal((MG3_N,) * 3).astype(np.float32)
    b -= b.mean()
    mesh = make_mesh((1, 1, 1), ("z", "row", "col"), DEVICE)
    per_cycle = stream_launches(_mg_prologue3(b, mesh, None)[2])
    kw = dict(mesh=mesh, tol=MG3_TOL, chunk_cycles=FT_SOLVE_CHUNK, smoother="jacobi-stream",
              keep=1)
    total = 0
    runs = {}
    for label, fn in (
            ("checkpointed_mg3d_solve, no fault", lambda: checkpointed_mg3d_solve(
                b, str(tmp / "solve"), sink=_SaveLog("solver"), **kw)),
            (f"supervised_mg3d_solve, preempted after chunk 2", lambda: supervised_mg3d_solve(
                b, str(tmp / "solve_pre"), metrics=metrics, sink=_SaveLog("solver preempted"),
                chaos=ChaosPlan(0, [Fault("solver/preempt", at=(2 * FT_SOLVE_CHUNK,),
                                          kind="preempt")]), **kw))):
        metrics = MetricsRegistry()
        ss.reset_launches()
        t0 = time.perf_counter()
        x, rep = fn()
        n = ss.seven_point_streamed_pallas.launches
        cycles = rep.cycles - rep.resumed_at + (2 * FT_SOLVE_CHUNK if rep.resumed_at else 0)
        log(f"  {label} {MG3_N}^3: {time.perf_counter() - t0:.3f} s, {rep}; "
            f"stream3d_kernel launches {n} (the rule: {per_cycle} x {cycles} cycles)")
        if n != per_cycle * cycles or not rep.converged:
            raise AssertionError(f"{label}: {n} launches, want {per_cycle * cycles}; {rep}")
        total += n
        runs[label] = x, rep
    (xa, ra), (xb, rb) = runs.values()
    same = np.array_equal(xa, xb) and ra.cycles == rb.cycles
    log(f"  the preempted solve against the uninterrupted one: {rb.cycles} / {ra.cycles} cycles, "
        f"bit-identical {same}")
    if not same:
        raise AssertionError("the preempted solve is not bit-identical to the uninterrupted one")
    _held_to_oracle("checkpointed_mg3d_solve", _lap3_np, xa, b, ORACLE_C["mg"] * MG3_TOL)
    return total


def phase28_fault_tolerant() -> dict:
    """The fault-tolerant chunked path (module comment). Returns the
    launches of rows 3, 4, 9, 14, 15 and 16 on this phase's runs."""
    import shutil
    import tempfile

    from tpuscratch_torch.bench.record import config16_elastic_goodput

    from tpuscratch_torch.ops.common import build_all, library
    from tpuscratch_torch.runtime.chunked import kernel_builds

    # every library loaded up front (earlier phases have loaded them when the
    # whole smoke runs): no chunk of this phase may then book a build
    for name in build_all():
        library(name)
    t0 = time.perf_counter()
    built = kernel_builds()

    def lap(what: str) -> None:
        log(f"  [{what} done at {time.perf_counter() - t0:.1f} s of phase 28]")

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tpuscratch_ft_"))
    try:
        launches = _ft_halo(tmp)
        lap("(a) the halo driver")
        more, reduced = _ft_train(tmp)
        launches.update(more)
        torch.cuda.empty_cache()
        lap(f"(b) the trainer (reduced: {', '.join(reduced)})")
        launches["seven_point_streamed_pallas"] = _ft_solver(tmp)
        lap("(c) the solver runner")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = config16_elastic_goodput([], device=DEVICE)
    for name, r in res.items():
        row = r["row"]
        log(f"  config 16 {name}: goodput {row['goodput_fraction_blocking']:.4f} blocking / "
            f"{row['goodput_fraction_async']:.4f} async; checkpoint share "
            f"{row['checkpoint_share_blocking']:.4f} / {row['checkpoint_share_async']:.4f}; "
            f"restart share {row['restart_share_blocking']:.4f} / "
            f"{row['restart_share_async']:.4f}; wall {row['wall_s_blocking']:.3f} / "
            f"{row['wall_s_async']:.3f} s; overlapped writes {row['overlapped_write_s']:.4f} s, "
            f"their device-to-host copies {row['copy_device_s_async']:.4f} s on the device "
            f"(booked in the chunks after each snapshot)")
    lap("(d) config 16")
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        raise AssertionError(f"phase 28 never launched {zero}")
    if kernel_builds() != built:
        raise AssertionError(f"phase 28 loaded {kernel_builds() - built} kernel libraries")
    log(f"  phase 28 launches {launches}; took {time.perf_counter() - t0:.1f} s")
    return launches


# ---- phase 29: the co-scheduler, the ledger, profiling, weak scaling, the CLIs -------

P29_TARGETS = {"train": 0.7, "solver": 0.3}
# the JAX ledger's numbers for config 15's columns at its chip sizes (32^3 a rank on
# 2x2x2, 16 sweeps; CG on 2x2), which tests/test_torch_ledger.py holds the port's to
C15_LEDGER = {"ppermutes_per_sweep_s1": 6.0, "halo_bytes_per_sweep_s1": 24576.0,
              "ppermutes_per_sweep_s2": 3.375, "halo_bytes_per_sweep_s2": 29410.0,
              "psums_total_classic": 3, "psums_per_iter_classic": 2,
              "psums_total_pipelined": 2, "psums_per_iter_pipelined": 1}
# the kernels phase 29 (b)'s profile must name (substrings of CUPTI's kernel names)
P29_PROFILED = ("stream3d_kernel", "adam_kernel", "flash_fwd_", "flash_bwd_")
P29_WEAK_ITERS = 3   # timed runs a weak-scaling point (bench_weak_scaling; 2 warm-up runs)


def _p29_launches() -> dict:
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta
    from tpuscratch_torch.ops import stencil_stream as ss

    return {"seven_point_streamed_pallas": ss.seven_point_streamed_pallas.launches,
            **{k: v for k, v in ta.launch_counts().items() if k in ("_flash_fwd_call",
                                                                      "_flash_bwd_call")},
            "fused_adam_flat": tadam.fused_adam_flat.launches}


def _p29_reset() -> None:
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta
    from tpuscratch_torch.ops import stencil_stream as ss

    ss.reset_launches()
    ta.reset_launches()
    tadam.reset_launches()


def _p29_kernel_cosched(tmp: pathlib.Path, tl) -> tuple[dict, str, list]:
    """(b) and (c): the ZeRO trainer at config 11's width (flash, fused Adam,
    async saves) and the 256^3 jacobi-stream solver, solo and then
    co-scheduled under GoodputShare with the first two ticks under
    ``profiling.trace``. Returns the co-scheduled run's launches, its JSONL
    path and the ``reduced`` list."""
    import dataclasses

    from tpuscratch_torch.bench.train_bench import default_train_setup
    from tpuscratch_torch.models.trainer import train_program
    from tpuscratch_torch.obs.goodput import by_workload
    from tpuscratch_torch.obs.report import load_events
    from tpuscratch_torch.obs.sink import Sink
    from tpuscratch_torch.runtime import profiling
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.runtime.scheduler import GoodputShare, MeshScheduler
    from tpuscratch_torch.solvers.multigrid3d import _mg_prologue3, stream_launches
    from tpuscratch_torch.solvers.runner import mg3d_solve_program

    cfg, batch, seq, _ = default_train_setup(on_card=True)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    reduced = [f"batch {batch} -> {FT_TRAIN_BATCH}", f"steps -> {FT_TRAIN_STEPS}"]
    zmesh = make_mesh((2, 1), ("dp", "sp"), DEVICE)
    b = np.random.default_rng(SEED + 30).standard_normal((MG3_N,) * 3).astype(np.float32)
    b -= b.mean()
    smesh = make_mesh((1, 1, 1), ("z", "row", "col"), DEVICE)
    per_cycle = stream_launches(_mg_prologue3(b, smesh, None)[2])

    def programs(d: pathlib.Path, sink):
        t = train_program(zmesh, cfg, FT_TRAIN_STEPS, str(d / "ckt"), save_every=FT_TRAIN_EVERY,
                          batch=FT_TRAIN_BATCH, seq=seq, keep=1, lr=1e-4, seed=3,
                          optimizer="adam", zero=True, async_ckpt=True, obs=sink)
        s = mg3d_solve_program(b, str(d / "cks"), mesh=smesh, tol=MG3_TOL,
                               chunk_cycles=FT_SOLVE_CHUNK, smoother="jacobi-stream", keep=1,
                               sink=sink)
        return t, s

    runs, trace_path = {}, None
    for mode in ("solo", "cosched"):
        d = tmp / f"p29_{mode}"
        path = d / "obs.jsonl"
        d.mkdir()
        sink = Sink(str(path), run={"bench": f"chip_smoke/phase29/{mode}", "platform": "cuda"})
        t, s = programs(d, sink)
        _p29_reset()
        t0 = time.perf_counter()
        with tl.span(f"29b {mode}"):
            if mode == "solo":
                res = {"train": t.run(), "solver": s.run()}
            else:
                sched = MeshScheduler(policy=GoodputShare(P29_TARGETS), sink=sink)
                sched.add(t)
                sched.add(s)
                prof = profiling.trace(str(tmp / "p29_trace"))
                traced = prof.__enter__()

                def stop_after_both(sch):   # (c): the first tick of each workload
                    if sch.ticks == 2:
                        prof.__exit__(None, None, None)

                sched.on_tick = stop_after_both
                res = sched.run()
                trace_path = traced.path
        wall = time.perf_counter() - t0
        sink.close()
        got = _p29_launches()
        (params, trep), (x, srep) = res["train"], res["solver"]
        want = {"seven_point_streamed_pallas": per_cycle * srep.cycles,
                "_flash_fwd_call": cfg.n_layers * FT_TRAIN_STEPS,
                "_flash_bwd_call": cfg.n_layers * FT_TRAIN_STEPS,
                "fused_adam_flat": FT_TRAIN_STEPS}
        log(f"  (b) {mode}: {wall:.3f} s; trainer losses {trep.losses}; solver {srep}; "
            f"launches {got} (the rules: {want})")
        if got != want or not srep.converged:
            raise AssertionError(f"(b) {mode}: launches {got}, want {want}; {srep}")
        runs[mode] = (params, trep, x, srep, got, path)
    (pa, ra, xa, sa, la, _), (pb, rb, xb, sb, lb, cpath) = runs["solo"], runs["cosched"]
    same = (_params_same(pa, pb) and ra.losses == rb.losses and np.array_equal(xa, xb)
            and sa.cycles == sb.cycles)
    log(f"  (b) co-scheduled against solo: bit-identical {same}; launches equal {la == lb}")
    if not (same and la == lb):
        raise AssertionError("(b) the co-scheduled kernel paths differ from solo")
    events = load_events([str(cpath)])
    wg = by_workload(events, targets=P29_TARGETS)
    wg.check()
    run_ev = next(e for e in events if e.get("event") == "sched/run")
    copies = sum(e.get("copy_device_s", 0.0) for e in events if e.get("event") == "ckpt/write")
    shares = wg.shares
    log(f"  (b) shares train {shares['train']:.4f} / solver {shares['solver']:.4f} against "
        f"{P29_TARGETS} (share_err {max(abs(shares[k] - v) for k, v in P29_TARGETS.items()):.4f}, "
        f"{run_ev['ticks']} ticks, {run_ev['switches']} switches); the async snapshots' copies "
        f"{copies:.4f} s on the device, booked to the trainer by the tick fence")
    # (c): the profile of the first tick of each workload
    if trace_path is None:
        raise AssertionError("(c) profiling.trace wrote no file")
    trace = json.loads(pathlib.Path(trace_path).read_text())
    kernels = {e.get("name", "") for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in kernels if k in n)[:2] for k in P29_PROFILED}
    log(f"  (c) {trace_path}: {pathlib.Path(trace_path).stat().st_size / 1e6:.1f} MB, "
        f"{len(kernels)} kernel names; {found}")
    if not all(found.values()):
        raise AssertionError(f"(c) the profile names none of {[k for k, v in found.items() if not v]}")
    return lb, str(cpath), reduced


def phase29_cosched_ledger() -> dict:
    """The co-scheduler, the ledger, profiling, weak scaling and the CLIs
    (module comment). Returns the launches of rows 3, 9, 14, 15 and 16."""
    import shutil
    import tempfile

    from tpuscratch_torch.bench.record import (
        config5_weak_scaling,
        config15_solver,
        config18_cosched,
    )
    from tpuscratch_torch.bench.weak_scaling import DEVICE_COUNTS, bench_weak_scaling
    from tpuscratch_torch.ops import stencil_kernel as sk
    from tpuscratch_torch.ops.common import build_all, library
    from tpuscratch_torch.runtime.chunked import kernel_builds
    from tpuscratch_torch.runtime.profiling import Timeline

    for name in build_all():   # loaded by earlier phases when the whole smoke runs
        library(name)
    t0 = time.perf_counter()
    built = kernel_builds()
    tl = Timeline()
    rows: list = []
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tpuscratch_p29_"))
    try:
        with tl.span("29a config 18"):
            res = config18_cosched(rows, device=DEVICE)
        row = res["row"]
        log(f"  (a) config 18: goodput {row['goodput_fraction_cosched']:.4f} co-scheduled / "
            f"{row['goodput_fraction_solo']:.4f} solo; shares train {row['share_train']:.4f} / "
            f"solver {row['share_solver']:.4f} (targets 0.7 / 0.3, share_err "
            f"{row['share_err']:.4f}); {row['switches']} switches, {1e3 * row['switch_s']:.3f} ms "
            f"a switch; bit-identical to solo, both partition checks held")
        launches, jsonl, reduced = _p29_kernel_cosched(tmp, tl)
        with tl.span("29d config 15"):
            c15 = config15_solver(rows, device=DEVICE)
        for name, r in c15.items():
            log(f"  (d) {name}: " + ", ".join(
                f"{k} {v}" for k, v in r.items() if k not in ("detail", "device", "platform")))
        cols = {**c15["solver_ca_smoothing"], **c15["solver_ca_cg"]}
        got = {k: cols[k] for k in C15_LEDGER}
        log(f"  (d) ledger columns {got}; the CPU twins' {C15_LEDGER}")
        if got != C15_LEDGER:
            raise AssertionError(f"(d) config 15's ledger columns {got} != {C15_LEDGER}")
        with tl.span("29e config 5"):
            pts = config5_weak_scaling(rows, device=DEVICE)
        log(f"  (e) config 5 (xla): efficiency {rows[-1]['points']}, comm_ratio "
            f"{rows[-1]['halo_bytes_per_cell']}")
        deep = 0
        with tl.span("29e deep-pallas:16 sweep"):
            for n in DEVICE_COUNTS:
                sk.reset_launches()
                (p,) = bench_weak_scaling(per_chip=(1024, 1024), steps=32, device_counts=[n],
                                          impl="deep-pallas:16", iters=P29_WEAK_ITERS,
                                          device=DEVICE)
                got = sk.deep_trapezoid_pallas.launches
                want = 2 * (P29_WEAK_ITERS + 2)
                log(f"  (e) deep-pallas:16 x32 on {n} ranks ({p.dims[0]}x{p.dims[1]}): "
                    f"{p.per_chip_rate:.4e} cell-updates/s a rank; deep_trapezoid_pallas "
                    f"launched {got} (the rule: 2 a run x {P29_WEAK_ITERS + 2} runs = {want})")
                if got != want:
                    raise AssertionError(f"(e) {n} ranks: row 3 launched {got}, want {want}")
                deep += got
        launches["deep_trapezoid_pallas"] = deep
        del pts
        # (f): the two command lines on this phase's own artifacts
        with tl.span("29f CLIs"):
            base, worse = tmp / "rows.json", tmp / "rows_halved.json"
            base.write_text("".join(json.dumps(r) + "\n" for r in rows))
            halved = [dict(r) for r in rows]
            victim = next(r for r in halved if r["metric"] == "solver_weak_mg3d_1dev")
            victim["cells_per_s"] /= 2
            worse.write_text("".join(json.dumps(r) + "\n" for r in halved))
            root = pathlib.Path(__file__).resolve().parent
            for args, want_rc in (((base, base), 0), ((base, worse), 1)):
                p = subprocess.run([sys.executable, "-m", "tpuscratch_torch.obs.regress",
                                    *map(str, args)], cwd=root, capture_output=True, text=True,
                                   timeout=120)
                log(f"  (f) obs.regress {args[0].name} {args[1].name}: exit {p.returncode}; "
                    f"{p.stdout.strip().splitlines()[:3]}")
                if p.returncode != want_rc:
                    raise AssertionError(f"(f) regress exited {p.returncode}, want {want_rc}: "
                                         f"{p.stderr[-2000:]}")
            p = subprocess.run([sys.executable, "-m", "tpuscratch_torch.obs.report", jsonl],
                               cwd=root, capture_output=True, text=True, timeout=120)
            lines = p.stdout.splitlines()
            log(f"  (f) obs.report on (b)'s stream: exit {p.returncode}, {len(lines)} lines")
            for ln in lines[:12]:
                log(f"      {ln}")
            if p.returncode != 0 or not any("sched/run" in ln for ln in lines):
                raise AssertionError(f"(f) report failed: {p.stderr[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if kernel_builds() != built:
        raise AssertionError(f"phase 29 loaded {kernel_builds() - built} kernel libraries")
    log("  phase 29 timeline:\n" + "\n".join(f"    {ln}" for ln in tl.report().splitlines()))
    log(f"  phase 29 launches {launches}; reduced: {', '.join(reduced)}; took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tpuscratch_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()

    def stage(title: str) -> None:  # each phase's start, in seconds since the smoke began
        log(f"{title} [{time.perf_counter() - t0:.1f} s]")

    stage("== phase 1: card and toolchain")
    phase1_card()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stage("== phase 2: kernels against their plain versions")
    errs, rows = phase2_kernels(gen)
    stage("== phase 3: main path (distributed_stencil, 1x1, 1024^2)")
    counts = phase3_main_path()
    stage("== phase 4: headline and rates")
    phase4_headline()
    stage("== phase 5: dot-product and fill kernels against their plain versions")
    errs2, rows2 = phase5_dot_fill_kernels(gen)
    stage("== phase 6: dot path (config 2, 1-rank mesh, 1e8 f32) and iota2d")
    counts2 = phase6_dot_path()
    stage("== phase 7: pingpong (config 3, 2 ranks stacked on the card) and host staging")
    phase7_pingpong()
    stage("== phase 8: streamed and DMA-halo kernels against their plain versions")
    errs3, rows3 = phase8_stream_dma_kernels(gen)
    stage("== phase 9: stream/dma path (distributed_stencil, 1024^2 on 1x1, 8192^2 on 4x4)")
    counts3 = phase9_stream_dma_path()
    stage("== phase 10: configs 4 (8192^2 on 4x4) and 10 (DMA halo, 1024^2)")
    phase10_configs()
    # the float64 oracle of phase 12 runs on the host while phase 11 runs
    worlds = _worlds3d()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    oracle = pool.submit(_oracle3d, worlds[(1, 1, 1)], STEPS)
    stage("== phase 11: 3D kernels against their plain versions")
    errs4, rows4 = phase11_kernels3d(gen)
    stage("== phase 12: 3D path (distributed_stencil3d, 256x512x512 on 1x1x1, 512^3 on 2x2x2)")
    counts4 = phase12_path3d(worlds, oracle)
    pool.shutdown()
    del worlds, oracle
    stage("== phase 13: config 9 (3D 7-point stencil, 256x512x512)")
    phase13_config9()
    stage("== phase 14: the paged-attention kernel against its plain version")
    errs5, rows5 = phase14_paged_kernel(gen)
    cfg12, scfg12, weights = _serve_setup()
    stage("== phase 15: serving path (ServeEngine, config 12's model, 1x1, 8 requests)")
    counts5 = phase15_serve_path(cfg12, scfg12, weights)
    stage("== phase 16: config 12 (serving decode: batches 1, 8, 32) and a tick's profile")
    phase16_config12(cfg12, scfg12, weights)
    del weights
    torch.cuda.empty_cache()
    stage("== phase 17: the flash kernels against their plain versions")
    errs6, rows6 = phase17_flash_kernels(gen)
    torch.cuda.empty_cache()
    stage("== phase 18: training path (train_step, config 11's model, 1x1, xla / pallas / ulysses)")
    counts6 = phase18_train_path()
    torch.cuda.empty_cache()
    stage("== phase 19: configs 6 (flash attention, S 4096) and 11 (train step) and a step's profile")
    phase19_configs6_11()
    torch.cuda.empty_cache()
    stage("== phase 20: the fused Adam kernel against its plain version")
    errs7, rows7 = phase20_fused_adam(gen)
    stage("== phase 21: ZeRO path (train_step_zero, config 13's model, 1x1, dp 2 and dp 4 stacked)")
    counts7 = phase21_zero_path()
    stage("== phase 22: config 13 (replicated vs ZeRO, dp 1/2/4, accumulation), a step's profile, "
        "adam_bench")
    phase22_config13()
    stage("== phase 23: the copy probes (256x512x512 f32) and the measured copy rate")
    errs8, rows8, counts8 = phase23_copy_probes()
    torch.cuda.empty_cache()
    stage("== phase 25: pipelined training path (train_step_pp, train_step_plan pp2 x dp2, "
        "config 11's model) and the SSM block")
    counts9, errs9 = phase25_pipelined_path(gen)
    torch.cuda.empty_cache()
    stage("== phase 26: config 11's pp row, config 14 (plan overlap, pp x dp in {1, 2}^2) and the "
        "bubble bench")
    phase26_configs11pp_14()
    torch.cuda.empty_cache()
    stage("== phase 27: the solvers (CG, multigrid 2D and 3D with the streamed smoother, spectral, "
        "the pair FFT), config 8 and mg3d_chip")
    stream_launches, errs10 = phase27_solvers(gen)
    torch.cuda.empty_cache()
    stage("== phase 28: the fault-tolerant chunked path (checkpointed_stencil killed and resumed, "
          "the trainer at config 11's width, the solver runner; config 16)")
    ft_launches = phase28_fault_tolerant()
    torch.cuda.empty_cache()
    stage("== phase 29: the co-scheduler (config 18, the kernel paths co-scheduled and profiled), "
          "config 15 with the ledger, config 5 and the deep-pallas:16 sweep, the CLIs")
    sched_launches = phase29_cosched_ledger()

    from tpuscratch_torch.bench import dma_bound as tb
    from tpuscratch_torch.ops import adam as tadam
    from tpuscratch_torch.ops import attention as ta
    from tpuscratch_torch.ops import halo_dma as hd
    from tpuscratch_torch.ops import reduction as tr
    from tpuscratch_torch.ops import stencil_kernel as sk
    from tpuscratch_torch.ops import stencil_stream as ss

    fill_mod = importlib.import_module("tpuscratch_torch.ops.fill")

    # name -> (source, TPU kernel it replaces, the main shape's row)
    table = {
        "five_point_pallas": ("stencil2d", "tpuscratch/ops/stencil_kernel.py:65", "1026^2"),
        "five_point_blocked": ("stencil2d", "tpuscratch/ops/stencil_kernel.py:658", "1026^2"),
        "deep_trapezoid_pallas": ("stencil2d", "tpuscratch/ops/stencil_kernel.py:136", "k=16"),
        "resident_periodic_pallas": ("stencil2d", "tpuscratch/ops/stencil_kernel.py:236", "1024^2"),
        "dot_partials_prepped": ("reduction", "tpuscratch/ops/reduction.py:132", "1e+08"),
        "dot_full_prepped": ("reduction", "tpuscratch/ops/reduction.py:163", "1e+08"),
        "fill": ("fill", "tpuscratch/ops/fill.py:27", "1e8"),
        "iota2d": ("fill", "tpuscratch/ops/fill.py:46", "8192x8192"),
        "nine_point_streamed_2d": ("stencil_stream2d", "tpuscratch/ops/stencil_stream.py:1067", "8192^2"),
        "dma_ring": ("halo_dma", "tpuscratch/ops/halo_dma.py:1099", "8192^2"),
        "dma_deep": ("halo_dma", "tpuscratch/ops/halo_dma.py:534", "8192^2"),
        "dma_hbm_step": ("halo_dma", "tpuscratch/ops/halo_dma.py:951", "8192^2"),
        "seven_point_banded_pallas": ("stencil3d", "tpuscratch/ops/stencil_kernel.py:313", "256x512x512"),
        "seven_point_strips_pallas": ("stencil3d", "tpuscratch/ops/stencil_kernel.py:377", "256x512x512"),
        "seven_point_assembled_pallas": ("stencil3d", "tpuscratch/ops/stencil_kernel.py:538", "256x512x512"),
        "seven_point_streamed_pallas": ("stencil_stream3d", "tpuscratch/ops/stencil_stream.py:566",
                                        f"k={STREAM3D_K}"),
        "paged_attention": ("paged_attention", "tpuscratch/ops/attention.py:1413",
                            "B32 T128 H8 D128 page16 K1 float32"),
        "_flash_fwd_call": ("flash_attention", "tpuscratch/ops/attention.py:865",
                            "config 11 B8 S2048 H8 D128 causal float32 state"),
        "_flash_fwd_compact": ("flash_attention", "tpuscratch/ops/attention.py:356",
                               "config 6 B1 S4096 H8 D128 causal float32"),
        "_flash_bwd_call": ("flash_attention", "tpuscratch/ops/attention.py:800",
                            "config 11 B8 S2048 H8 D128 causal float32 f32 grads"),
        "_flash_bwd_compact": ("flash_attention", "tpuscratch/ops/attention.py:675",
                               "config 6 B1 S4096 H8 D128 causal float32"),
        "fused_adam_flat": ("adam", "tpuscratch/ops/adam.py:87", "config 13 dp-4 shard"),
        "manual_stream": ("copy_probes", "tpuscratch/bench/dma_bound.py:38", "256x512x512"),
        "hbm2hbm": ("copy_probes", "tpuscratch/bench/dma_bound.py:106", "256x512x512"),
        "kway_hbm2hbm": ("copy_probes", "tpuscratch/bench/dma_bound.py:184", "256x512x512"),
        "lanes_stream": ("copy_probes", "tpuscratch/bench/dma_bound.py:216", "256x512x512"),
    }
    counts.update(counts2)
    counts.update(counts3)
    counts.update(counts4)
    counts.update(counts5)
    counts.update(counts6)
    counts.update(counts7)
    counts.update(counts8)
    errs.update(errs2)
    errs.update(errs3)
    errs.update(errs4)
    errs.update(errs5)
    errs.update(errs6)
    errs.update(errs7)
    errs.update(errs8)
    rows += rows2 + rows3 + rows4 + rows5 + rows6 + rows7 + rows8
    # the pipelined path (phase 25) launches the flash and fused Adam kernels too:
    # their launches are the sum over the paths that drive them, listed by path
    by_path = {name: {"phase 18" if "flash" in name else "phase 21": counts[name],
                      "phase 25": counts9[name]} for name in counts9}
    for name, n in counts9.items():
        if n == 0:
            raise AssertionError(f"the pipelined path never launched {name}")
        counts[name] += n
        errs[name] = max(errs[name], errs9[name])
    # the solver path (phase 27) launches the streamed 3D kernel in rhs mode
    name = "seven_point_streamed_pallas"
    by_path[name] = {"phase 12": counts[name], "phase 27": stream_launches}
    counts[name] += stream_launches
    errs[name] = max(errs[name], errs10)
    # the fault-tolerant chunked path (phase 28) runs rows 3, 4, 9 and 14-16 again
    for name, n in ft_launches.items():
        by_path.setdefault(name, {"phase 3": counts[name]})["phase 28"] = n
        counts[name] += n
    # phase 29 runs rows 3, 9 and 14-16 co-scheduled and in the weak-scaling sweep
    for name, n in sched_launches.items():
        by_path[name]["phase 29"] = n
        counts[name] += n
    kernels = []
    for name, (src, tpu, main_shape) in table.items():
        row = next(r for r in rows if r["name"] == name and main_shape in r["shape"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"tpuscratch_torch/csrc/{src}.cu",
            "replaces": tpu, "launches": counts[name], "max_abs_err": errs[name],
            **({"launches_by_path": by_path[name]} if name in by_path else {}),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
            **({"library_shape": row["library_shape"]} if "library_shape" in row else {}),
            **({"cuda_kernels": row["cuda_kernels"]} if "cuda_kernels" in row else {}),
        })
    wrappers = (sk.WRAPPERS + tr.WRAPPERS + fill_mod.WRAPPERS + ss.WRAPPERS + hd.WRAPPERS
                + ta.WRAPPERS + tadam.WRAPPERS + tb.WRAPPERS)
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
