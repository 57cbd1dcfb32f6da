"""Device times of the paged-attention, ``dma_hbm_step``, dot, fill, copy
probe, ``dma_ring``, streamed 3D, streamed 2D, depth-k DMA, deep-trapezoid,
resident, one-step 2D and iota2d kernels through their wrappers, for an
A/B of two checkouts on one card.

Cases (config 12's attention geometry: 8 heads, d_head 128, 16-token
pages, one query a sequence; config 4's and 10's stencil steps; config 2's
vectors):

- ``paged warm``: 32 sequences of 128 cached tokens, f32, int8 and fp8
  pools, the same call back to back (its 33.5 MB of f32 pages stay in L2);
- ``paged cold``: the same through 8 tables over disjoint pages of a
  2048-page pool, rotated, so that a table's pages have left the 50 MB L2
  before it comes back;
- ``paged long``: 4 sequences of 4096 cached tokens;
- ``hbm``: one Jacobi step of 8192^2 stacked on 4x4 and of 1024^2 on 1x1;
- ``dot``: ``dot_full_prepped``, ``dot_partials_prepped`` and ``torch.dot``
  over two f32 vectors of 1e8 and of 3000 elements;
- ``fill``: ``fill`` and ``torch.full`` at 1e8 f32 and 37x53 f32;
- ``probes``: every copy probe of ``bench/dma_bound.py``, ``x * c`` and
  ``copy_`` at 256x512x512 f32, each held bit-equal to ``clone`` / ``x *
  c`` first, as the marginal ms a step of ``dma_bound.race``;
- ``ring``: ``dma_ring``, 64 Jacobi steps of 8192^2 stacked on 4x4 and of
  1024^2 on 1x1 (config 4's and 10's runs), each held bit-equal to its
  plain version first;
- ``stream3d``: ``seven_point_streamed_pallas``, a z-slab Jacobi pass of
  k = 4, 3 and 2 on 256x512x512 (config 9's tile) and of k = 4 on
  2x2x2 stacked 256^3 ranks (phase 12's other world), each held bit-equal
  to its plain version first;
- ``stream2d``: ``nine_point_streamed_2d``, config 4's Jacobi passes of
  k = 16 and 32 at 8192^2 stacked on 4x4 (ghost columns) and a k = 16
  pass of the 1024^2 world (wrap), each held bit-equal first;
- ``deep``: ``dma_deep``, one Jacobi round of k = 8 at 8192^2 on 4x4 and
  at 1024^2, and the 9-point ``dma`` path's depth-1 round at 1024^2, each
  held bit-equal first;
- ``trapezoid``: ``deep_trapezoid_pallas``, a Jacobi pyramid of k = 16 and
  32 over the 1024^2 and 8192^2 cores (the headline ladder's
  ``deep-pallas:16`` and ``:32``), each held bit-equal first;
- ``resident``: ``resident_periodic_pallas``, 1000 Jacobi steps of 1024^2
  (the headline's ``resident:8``) and of 2560^2 (the largest grid its L2
  rule admits), each held bit-equal first;
- ``five``: ``five_point_pallas``, one Jacobi step of the 1026^2 and 8194^2
  padded tiles (the per-step ``pallas`` impl's), the whole call (kernel and
  whatever the wrapper runs after it), held bit-equal to the plain core and
  ``rebuild`` first, beside ``conv2d`` and ``conv2d`` with ``rebuild``;
- ``iota``: ``iota2d`` at 37x53 and 8192^2 f32 and 8192^2 bf16, held
  bit-equal first, beside ``torch.arange(h * w).view(h, w)``;
- ``engine``: config 12's default decode row, the serve engine's steady
  tick at batch 8 and 32 (``bench_decode`` at ``default_decode_setup``'s
  card shapes, seeded weights): the wall ms of a tick (the median of three
  windows, each the mean of its measured ticks; tokens/s is the batch over
  it), host and card together.

Usage, from the root of a checkout, on a machine with a card:

    python tpuscratch_torch/bench/kernel_ab.py [--root DIR] [--label NAME]

``--sweep`` times the kernels under other plans than the host rules'
instead (paged: chunk tokens, ring stages, split count; dot_full and fill:
smaller grids; dot_partials: a block a chunk against one resident wave;
the copy probes: each design switch of ``csrc/copy_probes.cu``, other
rings for ``hbm2hbm``; the ring: every fold, 1 to 3 blocks an SM;
stream3d: the z chunks of 1 to 8 and 16 chunks a rank; stream2d, deep
and trapezoid: other levels a stage, half-width strips and other row
chunks than ``march_plan``'s; resident: every fold, 1 to 3 blocks an SM;
five: every load width the pitch allows; iota: smaller grids).
``--only paged,hbm,dot,fill,probes,ring,stream3d,stream2d,deep,trapezoid,resident,five,iota,engine``
picks case groups.
``--root`` imports ``tpuscratch_torch`` from another checkout (for example
a parent commit unpacked with ``git archive`` into ``build/parent``), whose
kernels build into that checkout's own build directory; the wrappers'
signatures are the same on both sides. Prints the card's name and power
limit, then one JSON line a case: ``{"label", "case", "ms"}``. Run it as
parent, change, change, parent in one command to compare the two.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import pathlib
import subprocess
import sys

H, D, PAGE = 8, 128, 16
COLD_POOL, COLD_TABLES = 2048, 8


def device_ms(fn, n: int = 200) -> float:
    """Device time of one ``fn()``: CUDA events around ``n`` calls queued
    behind a sleep kernel (the host's launch cost hidden)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _pool(P: int, dtype, gen):
    import torch

    from tpuscratch_torch.serve.kvcache import quantize_pages

    kf = torch.randn((P, PAGE, H, D), generator=gen, device="cuda")
    vf = torch.randn((P, PAGE, H, D), generator=gen, device="cuda")
    if dtype == torch.float32:
        return kf, vf, None, None
    (k, ks), (v, vs) = quantize_pages(kf, dtype), quantize_pages(vf, dtype)
    return k, v, ks, vs


def paged_cases(gen):
    """(case, ms) of the paged kernel."""
    import numpy as np
    import torch

    from tpuscratch_torch.ops import attention as ta

    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.int8, torch.float8_e4m3fn):
        name = str(dtype).removeprefix("torch.")
        for B, T, what in ((32, 128, "warm"), (32, 128, "cold"), (4, 4096, "long")):
            per = B * T // PAGE
            P = COLD_POOL if what != "warm" else 512
            k, v, ks, vs = _pool(P, dtype, gen)
            perm = rng.permutation(P)
            n_tab = min(COLD_TABLES, P // per) if what == "cold" else 1
            tables = [torch.from_numpy(perm[j * per:(j + 1) * per].reshape(B, -1)
                                       .astype(np.int32)).cuda() for j in range(n_tab)]
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
            lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
            calls = [lambda t=t: ta.paged_attention(q, k, v, t, lens, ks, vs) for t in tables]
            for t, call in zip(tables, calls):
                want = ta._verify_attention_dense(q, k, v, t, lens, ks, vs)
                err = float((call() - want).abs().max())
                if err > 1e-5:
                    raise AssertionError(f"paged {what} {name}: max_abs_err {err}")
            it = itertools.cycle(calls)
            yield f"paged {what} B{B} T{T} {name}", device_ms(lambda: next(it)())
            del k, v, ks, vs, tables, calls


def plan_sweep(gen):
    """(case, ms) of the paged kernels under other plans than the host
    rule's (chunk tokens, ring stages, split count), on this checkout only:
    how the rule's choices were checked."""
    import dataclasses

    import numpy as np
    import torch

    from tpuscratch_torch.ops import attention as ta

    rng = np.random.default_rng(1)
    sms, optin = ta._paged_device(torch.cuda.current_device())
    for dtype in (torch.float32, torch.int8):
        name = str(dtype).removeprefix("torch.")
        for B, T in ((32, 128), (4, 4096)):
            per = B * T // PAGE
            k, v, ks, vs = _pool(2 * per, dtype, gen)
            table = torch.from_numpy(rng.permutation(2 * per)[:per].reshape(B, -1)
                                     .astype(np.int32)).cuda()
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
            lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
            ops = (q, k, v, table, lens, ks, vs)
            want = ta._verify_attention_dense(*ops)
            base = ta.paged_plan(B, 1, H, D, PAGE, T // PAGE, k.element_size(), 16, sms, optin)
            for tt in (8, 16, 32, 64):
                for stages in (2, 3, 4):
                    for n_split in (1, 2, 4, 8, 16, 32, 64):
                        if n_split > 1 and T // n_split < tt:
                            continue
                        split_len = -(-(-(-T // n_split)) // tt) * tt
                        smem = ta.paged_smem(k.element_size(), D, base.nj, base.wide, base.wq,
                                             tt, stages)
                        if smem > optin:
                            continue
                        plan = dataclasses.replace(base, tt=tt, stages=stages, smem=smem,
                                                   split_len=split_len,
                                                   n_split=-(-T // split_len))
                        err = float((ta._paged_launch(plan, *ops) - want).abs().max())
                        if err > 1e-5:
                            raise AssertionError(f"sweep {plan}: max_abs_err {err}")
                        mark = " (rule)" if plan == base else ""
                        yield (f"sweep B{B} T{T} {name} tt={tt} stages={stages} "
                               f"splits={plan.n_split}{mark}",
                               device_ms(lambda: ta._paged_launch(plan, *ops)))
            del k, v, ks, vs


def hbm_cases(gen):
    """(case, ms) of the stencil step."""
    import torch

    from tpuscratch_torch.ops import halo_dma as hd

    for lead, n in (((4, 4), 2048), ((1, 1), 1024)):
        cores = torch.randn(lead + (n, n), generator=gen, device="cuda")
        coeffs = (0.25, 0.25, 0.25, 0.25, 0.0)
        if not torch.equal(hd.dma_hbm_step(cores, coeffs), hd.dma_hbm_step_plain(cores, coeffs)):
            raise AssertionError(f"dma_hbm_step {lead} {n}^2 differs from its plain version")
        yield (f"hbm {lead[0] * n}^2 on {lead[0]}x{lead[1]}",
               device_ms(lambda: hd.dma_hbm_step(cores, coeffs)))
        del cores


DOT_RTOL = 1e-5  # of sum|x*y|: the kernels sum f32 products in another order


def _dot_inputs(gen, n: int):
    import torch

    from tpuscratch_torch.ops import reduction as tr

    x = torch.randn((n,), generator=gen, device="cuda")
    y = torch.randn((n,), generator=gen, device="cuda")
    x2, y2, _, block = tr.prep(x, y, 512 if n > 10**6 else 8)
    want = tr.dot_full_plain(x, y)
    scale = float((x.double() * y.double()).abs().sum())
    return x, y, x2, y2, block, want, scale


def _dot_ok(what: str, got, want, scale: float) -> None:
    err = abs(float(got) - float(want)) / scale
    if err > DOT_RTOL:
        raise AssertionError(f"{what}: relative error {err} > {DOT_RTOL}")


def dot_cases(gen):
    """(case, ms) of the two dot kernels and torch.dot."""
    import torch

    from tpuscratch_torch.ops import reduction as tr

    for n, label in ((100_000_000, "1e8"), (3000, "3000")):
        x, y, x2, y2, block, want, scale = _dot_inputs(gen, n)
        for name, fn in (("full", tr.dot_full_prepped), ("partials", tr.dot_partials_prepped)):
            _dot_ok(f"dot {name} {label}", fn(x2, y2, block), want, scale)
            yield f"dot {name} {label} f32", device_ms(lambda: fn(x2, y2, block))
        yield f"dot torch.dot {label} f32", device_ms(lambda: torch.dot(x, y))
        del x, y, x2, y2


def fill_cases(gen):
    """(case, ms) of the fill kernel and torch.full."""
    import importlib

    import torch

    tf = importlib.import_module("tpuscratch_torch.ops.fill")
    for shape, label in (((100_000_000,), "1e8"), ((37, 53), "37x53")):
        if not torch.equal(tf.fill(shape, 0.1), tf.fill_plain(shape, 0.1, device="cuda")):
            raise AssertionError(f"fill {label} differs from its plain version")
        yield f"fill {label} f32", device_ms(lambda: tf.fill(shape, 0.1))
        yield f"fill torch.full {label} f32", device_ms(lambda: torch.full(shape, 0.1, device="cuda"))


def dot_fill_sweep(gen):
    """(case, ms) of dot_full and fill on other grids than the host rules'
    (this checkout only): dot_full on 1 to ``per_sm`` blocks an SM, fill on
    1 to 8 resident blocks an SM striding over the output."""
    import importlib

    import torch

    from tpuscratch_torch.ops import reduction as tr

    tf = importlib.import_module("tpuscratch_torch.ops.fill")
    n_sm, per_sm = tr._occupancy(torch.cuda.current_device(), "full", 0, 0, 8)
    for n, label in ((100_000_000, "1e8"), (3000, "3000")):
        x, y, x2, y2, block, want, scale = _dot_inputs(gen, n)
        xf, yf = x2.flatten(), y2.flatten()
        rule = tr.dot_full_plan(xf.numel(), 1, 8, n_sm, per_sm)
        for waves in range(1, per_sm + 1):
            blocks = tr.dot_full_plan(xf.numel(), 1, 8, n_sm, waves)
            call = lambda: tr._full_launch(xf, yf, None, "sweep", blocks)  # noqa: E731
            _dot_ok(f"sweep dot_full {label} waves {waves}", call(), want, scale)
            yield (f"sweep dot_full {label} f32 waves={waves} blocks={blocks}"
                   f"{' (rule)' if blocks == rule else ''}", device_ms(call))
        # dot_partials: (a) a block a chunk, (b) 1 to per_sm blocks an SM
        # walking the chunks, blocks of 256 and 512 threads; the same bits
        # on every grid of a block size
        chunk = block * 128
        nchunks = -(-xf.numel() // chunk)
        rule = tr.dot_partials_threads(chunk, 8)
        for threads in (tr.DOT_THREADS, tr.PARTIALS_WIDE):
            _, per_t = tr._occupancy(torch.cuda.current_device(), "partials", 0, 0, 8, threads)
            first = None
            for blocks in sorted({nchunks} | {min(n_sm * w, nchunks) for w in range(1, per_t + 1)}):
                call = lambda: tr._partials_dot(xf, yf, chunk, None, "sweep", blocks,  # noqa: E731
                                                threads)[0]
                got = call()
                _dot_ok(f"sweep dot_partials {label} blocks {blocks}", got, want, scale)
                if first is not None and not torch.equal(got, first):
                    raise AssertionError(f"sweep dot_partials {label}: blocks {blocks} changed "
                                         "the bits")
                first = got
                grid = "a block a chunk" if blocks == nchunks else f"{blocks // n_sm} an SM"
                mark = " (rule)" if blocks == nchunks and threads == rule else ""
                yield (f"sweep dot_partials {label} f32 threads={threads} blocks={blocks} "
                       f"({grid}){mark}", device_ms(call))
        del x, y, x2, y2, xf, yf
    for shape, label in (((100_000_000,), "1e8"), ((37, 53), "37x53")):
        want = tf.fill_plain(shape, 0.1, device="cuda")
        rule = tf.fill_blocks(4 * want.numel())
        for blocks in sorted({tf.fill_blocks(4 * want.numel(), cap)
                              for cap in (None, n_sm, 2 * n_sm, 4 * n_sm, 8 * n_sm)}):
            call = lambda: tf._fill_launch(torch.empty(shape, device="cuda"), 0.1, blocks)  # noqa: E731
            if not torch.equal(call(), want):
                raise AssertionError(f"sweep fill {label} on {blocks} blocks differs from its "
                                     "plain version")
            yield (f"sweep fill {label} f32 blocks={blocks}{' (rule)' if blocks == rule else ''}",
                   device_ms(call))


def _probe_checked(name: str, step, x, c) -> None:
    import torch

    from tpuscratch_torch.bench import dma_bound as tb

    want = tb.touch_plain(x, c) if "touch" in name else tb.copy_plain(x, c)
    if not torch.equal(step(x, c), want):
        raise AssertionError(f"probe {name} differs from clone / x * c")


def probe_cases(gen):
    """(case, ms) of every copy probe, x * c and copy_ at 256x512x512 f32:
    the marginal ms a step (``dma_bound.race``)."""
    import torch

    from tpuscratch_torch.bench import dma_bound as tb

    x = torch.randn((tb.NZ, tb.CY, tb.CX), generator=gen, device="cuda")
    c = torch.full((1,), 1.0 + 2 ** -20, device="cuda")
    for name, step in tb.probes():
        _probe_checked(name, step, x, c)
        yield f"probe {name}", tb.race(name, step)["ms"]
    del x


def probe_sweep(gen):
    """(case, ms) of the copy probes under every design switch of
    ``csrc/copy_probes.cu`` (``dma_bound.FLAGS`` is the rule) and of
    ``hbm2hbm`` on other rings, this checkout only."""
    import torch

    from tpuscratch_torch.bench import dma_bound as tb

    x = torch.randn((tb.NZ, tb.CY, tb.CX), generator=gen, device="cuda")
    c = torch.full((1,), 1.0 + 2 ** -20, device="cuda")
    names = {tb.DYNAMIC: "dynamic", tb.EVICT_FIRST: "evict_first", tb.PDL: "pdl"}

    def label(flags):
        on = [n for bit, n in names.items() if flags & bit]
        return "+".join(on) or "static"

    cases = []
    for chunk, nbuf in (tb.HBM2HBM, (16384, 4), (24576, 4), (16384, 3)):
        for flags in range(8):
            cases.append((f"hbm2hbm {chunk}x{nbuf}", tb.hbm2hbm(chunk, nbuf, flags=flags), flags))
    # work-sized grids: a few chunks a static ring, more blocks than a wave
    nchunks = tb.BYTES // tb.HBM2HBM[0]
    for per_ring in (2, 4):
        cases.append((f"hbm2hbm {tb.HBM2HBM[0]}x{tb.HBM2HBM[1]} {per_ring} chunks a ring",
                      tb._ring(tb.hbm2hbm, *tb.HBM2HBM, 1, "direct", tb.EVICT_FIRST,
                               nchunks // per_ring), tb.EVICT_FIRST))
    for k in tb.KWAY:
        for flags in (0, tb.FLAGS & ~tb.PDL, tb.FLAGS):
            cases.append((f"hbm2hbm-{k}way", tb.kway_hbm2hbm(k, flags=flags), flags))
    for chunk, nbuf, mode in tb.MANUAL:
        for flags in (0, tb.FLAGS & ~tb.PDL, tb.FLAGS):
            cases.append((f"manual-{mode}-chunk{chunk}-nbuf{nbuf}",
                          tb.manual_stream(chunk, nbuf, mode, flags=flags), flags))
    for chunk, nbuf, lanes in tb.LANES + [(4096, 2, 8), (2048, 2, 15)]:
        for flags in (0, tb.FLAGS & ~tb.PDL, tb.FLAGS):
            cases.append((f"lanes{lanes}-touch-chunk{chunk}-nbuf{nbuf}",
                          tb.lanes_stream(chunk, nbuf, lanes, flags=flags), flags))
    for name, step, flags in cases:
        _probe_checked(name, step, x, c)
        mark = " (rule)" if flags == tb.FLAGS else ""
        yield f"sweep probe {name} {label(flags)}{mark}", tb.race(name, step)["ms"]
    del x


JACOBI = (0.25, 0.25, 0.25, 0.25, 0.0)
JACOBI7 = (1 / 6,) * 6 + (0.0,)
RING_SHAPES = (((4, 4), 2048, 10), ((1, 1), 1024, 50))  # stacked mesh, core edge, timed runs
RING_STEPS = 64


def ring_cases(gen):
    """(case, ms) of the DMA ring kernel, 64 steps."""
    import torch

    from tpuscratch_torch.ops import halo_dma as hd

    for lead, n, runs in RING_SHAPES:
        cores = torch.randn(lead + (n, n), generator=gen, device="cuda")
        if not torch.equal(hd.dma_ring(cores, RING_STEPS, JACOBI),
                           hd.dma_ring_plain(cores, RING_STEPS, JACOBI)):
            raise AssertionError(f"dma_ring {lead} {n}^2 differs from its plain version")
        yield (f"ring {lead[0] * n}^2 on {lead[0]}x{lead[1]} {RING_STEPS} steps",
               device_ms(lambda: hd.dma_ring(cores, RING_STEPS, JACOBI), n=runs))
        del cores


def ring_sweep(gen):
    """(case, ms) of the ring kernel under every fold and 1 to 3 blocks an
    SM (this checkout only)."""
    import torch

    from tpuscratch_torch.ops import common as tc
    from tpuscratch_torch.ops import halo_dma as hd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lead, n, runs in RING_SHAPES:
        cores = torch.randn(lead + (n, n), generator=gen, device="cuda")
        want = hd.dma_ring_plain(cores, RING_STEPS, JACOBI)
        rule = hd.dma_ring_plan(cores, RING_STEPS)
        for fold in range(1, tc.RING_F + 1):
            for per_sm in (1, 2, 3):
                plan = tc.ring_plan(*cores.shape, RING_STEPS, sms, per_sm, fold=fold)
                call = lambda: hd._ring_launch(cores, RING_STEPS, JACOBI, plan)  # noqa: E731
                if not torch.equal(call(), want):
                    raise AssertionError(f"sweep ring {plan} differs from its plain version")
                mark = " (rule)" if plan == rule else ""
                yield (f"sweep ring {lead[0] * n}^2 fold={fold} blocks={plan.blocks}{mark}",
                       device_ms(call, n=runs))
        del cores, want


def _stream3d_operands(gen, lead, shape, k):
    import torch

    cy, cx = shape[1:]
    a = [torch.randn(lead + s, generator=gen, device="cuda")
         for s in (shape, (k, cy, cx), (k, cy, cx))]
    return a, torch.zeros(lead + (6,), dtype=torch.int32, device="cuda")


STREAM3D_SHAPES = (((), (256, 512, 512), 4), ((), (256, 512, 512), 3),
                   ((), (256, 512, 512), 2), ((2, 2, 2), (256, 256, 256), 4))


def stream3d_cases(gen):
    """(case, ms) of the streamed 3D kernel, one z-slab Jacobi pass."""
    import torch

    from tpuscratch_torch.ops import stencil_stream as ss

    for lead, shape, k in STREAM3D_SHAPES:
        a, flags = _stream3d_operands(gen, lead, shape, k)
        call = lambda: ss.seven_point_streamed_pallas(*a, shape, JACOBI7, k,  # noqa: E731
                                                      open_flags=flags)
        if not torch.equal(call(), ss.seven_point_streamed_plain(*a, JACOBI7, k, flags)):
            raise AssertionError(f"stream3d {lead} {shape} k={k} differs from its plain version")
        label = "x".join(map(str, shape)) + (f" on {'x'.join(map(str, lead))}" if lead else "")
        yield f"stream3d {label} k={k}", device_ms(call, n=20)
        del a


def stream3d_sweep(gen):
    """(case, ms) of the streamed 3D kernel at the z chunks of 1 to 8 and
    16 chunks a rank, the rule's among them (this checkout only)."""
    import dataclasses

    import torch

    from tpuscratch_torch.ops import stencil_stream as ss

    w = ss._weights3d(JACOBI7)
    for lead, shape, k in STREAM3D_SHAPES:
        a, flags = _stream3d_operands(gen, lead, shape, k)
        want = ss.seven_point_streamed_plain(*a, JACOBI7, k, flags)
        nb = math.prod(lead)
        rule = ss._card_plan3d(0)(shape, nb, k, 7)
        plans = {rule} | {dataclasses.replace(rule, zc=-(-shape[0] // chunks))
                          for chunks in (1, 2, 3, 4, 5, 6, 7, 8, 16)}
        for plan in sorted(plans, key=lambda p: p.zc):
            call = lambda: ss._launch3d(*a, None, None, None, None, flags, w, k, 0.0,  # noqa: E731
                                        plan_of=lambda *_: plan)[0]
            if not torch.equal(call(), want):
                raise AssertionError(f"sweep stream3d {plan} differs from its plain version")
            mark = " (rule)" if plan == rule else ""
            label = "x".join(map(str, shape)) + (f" on {'x'.join(map(str, lead))}" if lead else "")
            yield f"sweep stream3d {label} k={k} zc={plan.zc}{mark}", device_ms(call, n=20)
        del a, want


NINE = (0.125,) * 4 + (0.0625,) * 4 + (0.0,)
# stacked mesh, core edge, depth, ghost columns (a distributed x axis)
STREAM2D_SHAPES = (((4, 4), 2048, 16, True), ((4, 4), 2048, 32, True), ((1, 1), 1024, 16, False))
# stacked mesh, core edge, depth, coefficients
DEEP_SHAPES = (((4, 4), 2048, 8, JACOBI), ((1, 1), 1024, 8, JACOBI), ((1, 1), 1024, 1, NINE))


def _label2d(lead, n) -> str:
    return f"{lead[0] * n}^2 on {lead[0]}x{lead[1]}"


def _stream2d_operands(gen, lead, n, k, ghost):
    import torch

    core = torch.randn(lead + (n, n), generator=gen, device="cuda")
    top, bot = (torch.randn(lead + (k, n), generator=gen, device="cuda") for _ in range(2))
    gl, gr = ((torch.randn(lead + (n + 2 * k, k), generator=gen, device="cuda")
               for _ in range(2)) if ghost else (None, None))
    flags = torch.zeros(lead + (4,), dtype=torch.int32, device="cuda")
    return core, top, bot, gl, gr, flags


def stream2d_cases(gen):
    """(case, ms) of the streamed 2D kernel, one Jacobi pass: config 4's
    stream:16 and stream:32 passes (8192^2 on 4x4, ghost columns) and a
    stream:16 pass of the 1024^2 world (wrap)."""
    import torch

    from tpuscratch_torch.ops import stencil_stream as ss

    for lead, n, k, ghost in STREAM2D_SHAPES:
        core, top, bot, gl, gr, flags = _stream2d_operands(gen, lead, n, k, ghost)
        call = lambda: ss.nine_point_streamed_2d(core, top, bot, (n, n), JACOBI, k,  # noqa: E731
                                                 gl=gl, gr=gr)  # periodic, as config 4's
        if not torch.equal(call(), ss.nine_point_streamed_2d_plain(core, top, bot, JACOBI, k,
                                                                   flags, gl, gr)):
            raise AssertionError(f"stream2d {lead} {n}^2 k={k} differs from its plain version")
        yield f"stream2d {_label2d(lead, n)} k={k}", device_ms(call, n=20)
        del core, top, bot, gl, gr


def deep_cases(gen):
    """(case, ms) of the depth-k DMA kernel, one round: k = 8 at 8192^2 on
    4x4 and at 1024^2 (config 4's and 10's dma-deep:8), and the 9-point
    dma path's depth-1 round at 1024^2."""
    import torch

    from tpuscratch_torch.ops import halo_dma as hd

    for lead, n, k, coeffs in DEEP_SHAPES:
        cores = torch.randn(lead + (n, n), generator=gen, device="cuda")
        call = lambda: hd.dma_deep(cores, k, coeffs, k)  # noqa: E731
        if not torch.equal(call(), hd.dma_deep_plain(cores, k, coeffs, k)):
            raise AssertionError(f"dma_deep {lead} {n}^2 k={k} differs from its plain version")
        yield (f"deep {_label2d(lead, n)} k={k} {len(coeffs)}pt",
               device_ms(call, n=20 if n > 1024 else 200))
        del cores


def _march_variants(rule, out_h, per_sm_of, plan_of):
    """The plans a sweep times beside the rule's: other levels a stage,
    half-width strips, chunks of a quarter to four times the rule's in
    steps of a factor of sqrt(2), and the even chunks of one and two more
    and fewer chunks than the rule's (of ``out_h`` rows)."""
    from tpuscratch_torch.ops import common as tc

    plans = {rule}
    for levels in tc.MARCH_LEVELS:
        if rule.depth <= tc.march_depth(levels):
            plans.add(plan_of(levels=levels, per_sm=per_sm_of(levels)))
    plans.add(plan_of(width=rule.width // 8 * 4))
    for i in range(-4, 5):
        plans.add(plan_of(rows=max(1, round(rule.rows * 2 ** (i / 2)))))
    even = tc.march_chunks(out_h)
    at = even.index(rule.rows) if rule.rows in even else None
    for i in () if at is None else range(max(0, at - 2), min(len(even), at + 3)):
        plans.add(plan_of(rows=even[i]))
    return sorted(plans, key=lambda p: (p.levels, p.width, p.rows))


def stream2d_sweep(gen):
    """(case, ms) of the streamed 2D kernel under the plans of
    ``_march_variants`` (this checkout only), each bit-checked."""
    import torch

    from tpuscratch_torch.ops import common as tc
    from tpuscratch_torch.ops import stencil_stream as ss

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lead, n, k, ghost in STREAM2D_SHAPES:
        core, top, bot, gl, gr, flags = _stream2d_operands(gen, lead, n, k, ghost)
        want = ss.nine_point_streamed_2d_plain(core, top, bot, JACOBI, k, flags, gl, gr)
        nb = math.prod(lead)
        mask = tc.march_mask(ss.stream_c9(JACOBI))

        def per_sm_of(levels):
            return ss._stream2d_per_sm(0, levels, mask, -(-k // levels), False)

        rule = tc.march_chain(nb, n, n, k, sms,
                              lambda lv, w: ss._stream2d_per_sm(0, lv, mask, w, False))[0]

        def plan_of(levels=rule.levels, per_sm=None, width=None, rows=None):
            return tc.march_plan(nb, n, n, k, sms, per_sm or per_sm_of(levels), levels=levels,
                                 width=width, rows=rows and min(rows, n))

        for plan in _march_variants(rule, n, per_sm_of, plan_of):
            call = lambda: ss._launch(core, top, bot, gl, gr, flags, JACOBI, k,  # noqa: E731
                                      plans=[plan], open_=False)
            if not torch.equal(call(), want):
                raise AssertionError(f"sweep stream2d {plan} differs from its plain version")
            mark = " (rule)" if plan == rule else ""
            yield (f"sweep stream2d {_label2d(lead, n)} k={k} levels={plan.levels} "
                   f"width={plan.width} rows={plan.rows} blocks={nb * plan.strips * plan.chunks} "
                   f"per_sm={per_sm_of(plan.levels)}{mark}", device_ms(call, n=20))
        del core, top, bot, gl, gr, want


def deep_sweep(gen):
    """(case, ms) of the depth-k DMA kernel under the plans of
    ``_march_variants`` (this checkout only), each bit-checked."""
    import torch

    from tpuscratch_torch.ops import common as tc
    from tpuscratch_torch.ops import halo_dma as hd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lead, n, k, coeffs in DEEP_SHAPES:
        cores = torch.randn(lead + (n, n), generator=gen, device="cuda")
        want = hd.dma_deep_plain(cores, k, coeffs, k)
        mask = tc.march_mask(hd.deep_c9(coeffs))

        def per_sm_of(levels):
            return hd._deep_per_sm(0, levels, mask, -(-k // levels))

        rule = hd.deep_plan(tuple(cores.shape), k, sms,
                            lambda lv, w: hd._deep_per_sm(0, lv, mask, w))

        def plan_of(levels=rule.levels, per_sm=None, width=None, rows=None):
            return tc.march_plan(1, lead[0] * n, lead[1] * n, k, sms,
                                 per_sm or per_sm_of(levels), levels=levels, width=width,
                                 rows=rows and min(rows, lead[0] * n))

        for plan in _march_variants(rule, lead[0] * n, per_sm_of, plan_of):
            call = lambda: hd._deep_launch(cores, coeffs, plan)  # noqa: E731
            if not torch.equal(call(), want):
                raise AssertionError(f"sweep deep {plan} differs from its plain version")
            mark = " (rule)" if plan == rule else ""
            yield (f"sweep deep {_label2d(lead, n)} k={k} {len(coeffs)}pt levels={plan.levels} "
                   f"width={plan.width} rows={plan.rows} blocks={plan.strips * plan.chunks} "
                   f"per_sm={per_sm_of(plan.levels)}{mark}",
                   device_ms(call, n=20 if n > 1024 else 200))
        del cores, want


# core edge, depth
TRAPEZOID_SHAPES = ((1024, 16), (1024, 32), (8192, 16), (8192, 32))
# grid edge, steps, timed runs
RESIDENT_SHAPES = ((1024, 1000, 20), (2560, 1000, 5))


def _trapezoid_operands(gen, n, k):
    import torch

    from tpuscratch_torch.halo.layout import TileLayout

    lay = TileLayout(n, n, k, k)
    return lay, torch.randn(lay.padded_shape, generator=gen, device="cuda")


def trapezoid_cases(gen):
    """(case, ms) of the deep-trapezoid kernel, one Jacobi pyramid of k
    substeps over the 1024^2 and 8192^2 cores."""
    import torch

    from tpuscratch_torch.ops import stencil_kernel as sk

    for n, k in TRAPEZOID_SHAPES:
        lay, tile = _trapezoid_operands(gen, n, k)
        call = lambda: sk.deep_trapezoid_pallas(tile, lay, k)  # noqa: E731
        if not torch.equal(call(), sk.deep_trapezoid_plain(tile, lay, k)):
            raise AssertionError(f"deep_trapezoid {n}^2 k={k} differs from its plain version")
        yield f"trapezoid {n}^2 k={k}", device_ms(call, n=20 if n > 1024 else 200)
        del tile


def resident_cases(gen):
    """(case, ms) of the resident kernel, 1000 Jacobi steps in one launch."""
    import torch

    from tpuscratch_torch.ops import stencil_kernel as sk

    for n, steps, runs in RESIDENT_SHAPES:
        core = torch.randn((n, n), generator=gen, device="cuda")
        call = lambda: sk.resident_periodic_pallas(core, steps)  # noqa: E731
        if not torch.equal(call(), sk.resident_periodic_plain(core, steps)):
            raise AssertionError(f"resident {n}^2 differs from its plain version")
        yield f"resident {n}^2 {steps} steps", device_ms(call, n=runs)
        del core


def trapezoid_sweep(gen):
    """(case, ms) of the deep-trapezoid kernel under the plans of
    ``_march_variants`` (this checkout only), each bit-checked."""
    import torch

    from tpuscratch_torch.ops import common as tc
    from tpuscratch_torch.ops import stencil_kernel as sk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, k in TRAPEZOID_SHAPES:
        lay, tile = _trapezoid_operands(gen, n, k)
        want = sk.deep_trapezoid_plain(tile, lay, k)

        def per_sm_of(levels):
            return sk._trapezoid_per_sm(0, levels, -(-k // levels))

        rule, = tc.march_chain(1, n, n, k, sms, lambda lv, w: sk._trapezoid_per_sm(0, lv, w))

        def plan_of(levels=rule.levels, per_sm=None, width=None, rows=None):
            return tc.march_plan(1, n, n, k, sms, per_sm or per_sm_of(levels), levels=levels,
                                 width=width, rows=rows and min(rows, n))

        for plan in _march_variants(rule, n, per_sm_of, plan_of):
            def call():
                out = torch.empty((n, n), device="cuda")
                sk._trapezoid_call(tile, out, k, JACOBI, plan)
                return out

            if not torch.equal(call(), want):
                raise AssertionError(f"sweep trapezoid {plan} differs from its plain version")
            mark = " (rule)" if plan == rule else ""
            yield (f"sweep trapezoid {n}^2 k={k} levels={plan.levels} width={plan.width} "
                   f"rows={plan.rows} blocks={plan.strips * plan.chunks} "
                   f"per_sm={per_sm_of(plan.levels)}{mark}",
                   device_ms(call, n=20 if n > 1024 else 200))
        del tile, want


def resident_sweep(gen):
    """(case, ms) of the resident kernel under every fold and 1 to its most
    blocks an SM (this checkout only)."""
    import torch

    from tpuscratch_torch.ops import common as tc
    from tpuscratch_torch.ops import stencil_kernel as sk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, steps, runs in RESIDENT_SHAPES:
        core = torch.randn((n, n), generator=gen, device="cuda")
        want = sk.resident_periodic_plain(core, steps)
        most = sk._resident_per_sm(0, tc.ring_vec(n, core.data_ptr()), sk.resident_comb(JACOBI))
        rule = sk.resident_plan(n, n, steps, sms, most)
        for fold in range(1, tc.RING_F + 1):
            for per_sm in range(1, most + 1):
                plan = sk.resident_plan(n, n, steps, sms, per_sm, fold=fold)
                call = lambda: sk._resident_launch(core, steps, JACOBI, lambda _: plan)  # noqa: E731
                if not torch.equal(call(), want):
                    raise AssertionError(f"sweep resident {plan} differs from its plain version")
                mark = " (rule)" if plan == rule else ""
                yield (f"sweep resident {n}^2 fold={fold} blocks={plan.blocks}{mark}",
                       device_ms(call, n=runs))
        del core, want


FIVE_SHAPES = ((1024, 1), (8192, 1))  # core edge, halo
FIVE_SWEEP = FIVE_SHAPES + ((8192, (1, 2)),)  # and a pitch of 8196: 16-byte rows


def _bits_equal(a, b) -> bool:
    import torch

    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def _five_operands(gen, n, halo):
    import torch

    from tpuscratch_torch.halo.layout import TileLayout
    from tpuscratch_torch.halo.stencil import rebuild
    from tpuscratch_torch.ops import stencil_kernel as sk

    lay = TileLayout(n, n, *((halo, halo) if isinstance(halo, int) else halo))
    tile = torch.randn(lay.padded_shape, generator=gen, device="cuda")
    return lay, tile, rebuild(tile, sk.five_point_plain(tile, lay), lay)


def five_cases(gen):
    """(case, ms) of one Jacobi step of the per-step path: the whole
    ``five_point_pallas`` call, and conv2d alone and with rebuild."""
    import torch

    from tpuscratch_torch.halo.stencil import rebuild
    from tpuscratch_torch.ops import stencil_kernel as sk

    torch.backends.cudnn.allow_tf32 = False
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25], [0.0, 0.25, 0.0]],
                          device="cuda").reshape(1, 1, 3, 3)
    conv = torch.nn.functional.conv2d
    for n, halo in FIVE_SHAPES:
        lay, tile, want = _five_operands(gen, n, halo)
        call = lambda: sk.five_point_pallas(tile, lay)  # noqa: E731
        if not _bits_equal(call(), want):
            raise AssertionError(f"five_point_pallas {n}^2 differs from its plain version")
        runs = 20 if n > 1024 else 200
        yield f"five {n + 2}^2", device_ms(call, n=runs)
        yield f"five conv2d {n}^2", device_ms(lambda: conv(tile[None, None], weight), n=runs)
        yield (f"five conv2d+rebuild {n}^2",
               device_ms(lambda: rebuild(tile, conv(tile[None, None], weight)[0, 0], lay), n=runs))
        del tile, want


def five_sweep(gen):
    """(case, ms) of the one-step kernel at every load width the pitch and
    alignment allow (this checkout only), each held bit-equal first."""
    import torch

    from tpuscratch_torch.ops import stencil_kernel as sk

    for n, halo in FIVE_SWEEP:
        lay, tile, want = _five_operands(gen, n, halo)
        ph, pw = lay.padded_shape
        rule = sk.five_plan(pw, tile.data_ptr())
        for vec in (v for v in (4, 2, 1) if v <= rule):
            call = lambda: sk._five_point_launch(tile, lay, JACOBI, "sweep", vec)  # noqa: E731
            if not _bits_equal(call(), want):
                raise AssertionError(f"sweep five vec={vec} differs from its plain version")
            mark = " (rule)" if vec == rule else ""
            yield f"sweep five {ph}x{pw} vec={vec}{mark}", device_ms(call, n=20 if n > 1024 else 200)
        del tile, want


IOTA_SHAPES = (((37, 53), "float32"), ((8192, 8192), "float32"), ((8192, 8192), "bfloat16"))


def iota_cases(gen):
    """(case, ms) of iota2d and torch.arange(h * w).view(h, w)."""
    import importlib

    import torch

    tf = importlib.import_module("tpuscratch_torch.ops.fill")
    for (h, w), name in IOTA_SHAPES:
        dtype = getattr(torch, name)
        if not _bits_equal(tf.iota2d((h, w), dtype), tf.iota2d_plain((h, w), dtype, "cuda")):
            raise AssertionError(f"iota2d {h}x{w} {name} differs from its plain version")
        yield f"iota {h}x{w} {name}", device_ms(lambda: tf.iota2d((h, w), dtype))
        yield (f"iota torch.arange {h}x{w} {name}",
               device_ms(lambda: torch.arange(h * w, dtype=dtype, device="cuda").view(h, w)))


def iota_sweep(gen):
    """(case, ms) of iota2d on smaller grids than the rule's, 1 to 8
    resident blocks an SM striding over the output (this checkout only)."""
    import importlib

    import torch

    tf = importlib.import_module("tpuscratch_torch.ops.fill")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for (h, w), name in IOTA_SHAPES:
        dtype = getattr(torch, name)
        want = tf.iota2d_plain((h, w), dtype, "cuda")
        nbytes = want.numel() * want.element_size()
        rule = tf.fill_blocks(nbytes)
        for blocks in sorted({tf.fill_blocks(nbytes, cap)
                              for cap in (None, n_sm, 2 * n_sm, 4 * n_sm, 8 * n_sm)}):
            call = lambda: tf._iota_launch(torch.empty((h, w), dtype=dtype, device="cuda"),  # noqa: E731
                                           blocks)
            if not _bits_equal(call(), want):
                raise AssertionError(f"sweep iota {h}x{w} on {blocks} blocks differs")
            yield (f"sweep iota {h}x{w} {name} blocks={blocks}{' (rule)' if blocks == rule else ''}",
                   device_ms(call))


ENGINE_BATCHES = (8, 32)


def engine_cases(gen):
    """(case, ms) of config 12's default decode row: the wall time of one
    engine tick at batch 8 and 32, the median of three windows."""
    import dataclasses

    from tpuscratch_torch.bench.decode_bench import bench_decode, default_decode_setup
    from tpuscratch_torch.models.transformer import init_params
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.serve.engine import init_embed

    cfg, scfg, _, kwargs = default_decode_setup(True)
    mesh = make_mesh((1, 1), ("dp", "sp"), "cuda")
    weights = dict(params=init_params(scfg.seed, cfg, "cuda"),
                   embed=init_embed(scfg.seed, scfg.vocab, cfg.d_model, "cuda"))
    for batch in ENGINE_BATCHES:
        ticks = sorted(1e3 * batch / bench_decode(mesh, cfg, dataclasses.replace(
            scfg, n_slots=batch), **kwargs, **weights).tokens_per_s for _ in range(3))
        yield f"engine decode batch {batch} (ms a tick, median of 3)", ticks[1]


GROUPS = {"paged": paged_cases, "hbm": hbm_cases, "dot": dot_cases, "fill": fill_cases,
          "probes": probe_cases, "ring": ring_cases, "stream3d": stream3d_cases,
          "stream2d": stream2d_cases, "deep": deep_cases, "trapezoid": trapezoid_cases,
          "resident": resident_cases, "five": five_cases, "iota": iota_cases,
          "engine": engine_cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import tpuscratch_torch from this checkout")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="time the kernels under other plans (this checkout only)")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated case groups: " + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root or pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path[0] = str(root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import tpuscratch_torch

    if pathlib.Path(tpuscratch_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tpuscratch_torch.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"# {args.label or root}: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    groups = args.only.split(",")
    if args.sweep:
        cases = itertools.chain(plan_sweep(gen) if "paged" in groups else (),
                                dot_fill_sweep(gen) if {"dot", "fill"} & set(groups) else (),
                                probe_sweep(gen) if "probes" in groups else (),
                                ring_sweep(gen) if "ring" in groups else (),
                                stream3d_sweep(gen) if "stream3d" in groups else (),
                                stream2d_sweep(gen) if "stream2d" in groups else (),
                                deep_sweep(gen) if "deep" in groups else (),
                                trapezoid_sweep(gen) if "trapezoid" in groups else (),
                                resident_sweep(gen) if "resident" in groups else (),
                                five_sweep(gen) if "five" in groups else (),
                                iota_sweep(gen) if "iota" in groups else ())
    else:
        cases = itertools.chain.from_iterable(GROUPS[g](gen) for g in groups)
    for case, ms in cases:
        print(json.dumps({"label": args.label or str(root), "case": case, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
