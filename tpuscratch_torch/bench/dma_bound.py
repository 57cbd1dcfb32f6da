"""Copy-rate probes: how fast can the card stream a 256x512x512 f32 array?

The twin of ``tpuscratch.bench.dma_bound``, whose Pallas probes asked how
fast the TPU's DMA engines copy 256 MiB. Here the same four probes are
``csrc/copy_probes.cu`` kernels (bulk asynchronous copies through a ring of
shared-memory stages, one thread issuing the loads and another the stores,
see the source), each a factory returning ``step(x, c) -> y``:

- ``manual_stream(chunk, nbuf, mode)``: one ring a block, ``nbuf`` stages of
  ``chunk`` bytes; ``mode`` "copy" moves each chunk through registers,
  "touch" multiplies it by ``c`` on the way;
- ``hbm2hbm()``: bulk copies in and out of one ring (``HBM2HBM``), no
  thread touches the data;
- ``kway_hbm2hbm(K)``: ``hbm2hbm`` over K disjoint slabs, each slab its own
  launch on its own stream with a K-th of one resident wave, so that the K
  launches run side by side (the TPU's K concurrent DMAs, K semaphores);
- ``lanes_stream(chunk, nbuf, L, mode)``: L independent rings a block;

beside ``xla_touch`` (``x * c``, one torch multiply: the library figure of
the touch, as XLA's fused multiply was on the TPU) and ``copy_`` (one
``Tensor.copy_``, the library figure of the copy). The plain versions are
``x.clone()`` and ``x * c``; a CPU tensor takes them. ``race`` times a probe
by differencing chains of 50 and 250 steps, each step reading the previous
one's output, and reports rd+wr GB/s over 2 x 256 MiB; the best probe is the
card's measured copy rate. A TPU band was a 1 MiB z-plane, past the 227 KB
a block may hold, so chunks are bytes and the probe lists below are the
card's own (the JAX lists beside them). The host plans every grid
(``probe_blocks``) from the occupancy, asked once a configuration and
card; ``ring_chunks`` and ``drawn_chunks`` model which chunks each ring
moves (dealt out, or drawn from the counter with DYNAMIC), ``probe_smem``
the shared memory a block asks for. Every factory takes ``flags``, the
kernel's design switches (``FLAGS`` unless given; ``kernel_ab.py --sweep``
times the others).

``python -m tpuscratch_torch.bench.dma_bound`` runs every probe on the card.
"""

from __future__ import annotations

import ctypes
import functools
import random
import sys

import torch

from tpuscratch_torch.bench.timing import time_device
from tpuscratch_torch.ops.common import (check_status, counters, library, route, smem_optin,
                                         stream_of)
from tpuscratch_torch.runtime.mesh import resolve_device

NZ, CY, CX = 256, 512, 512
BYTES = NZ * CY * CX * 4
MODES = {"direct": 0, "copy": 1, "touch": 2}
#: the kernel's design switches (csrc/copy_probes.cu: Flags): chunks drawn
#: from a counter, else dealt out in turn; an L2 evict_first policy; a
#: programmatic dependent launch
DYNAMIC, EVICT_FIRST, PDL = 1, 2, 4
FLAGS = DYNAMIC | EVICT_FIRST | PDL
#: (chunk bytes, nbuf, mode); the JAX list is (band z-planes, nbuf, mode) in
#: (8, 2), (8, 3), (16, 2), each copy and touch
MANUAL = [(16384, 2, "copy"), (16384, 3, "copy"), (32768, 2, "copy"),
          (16384, 2, "touch"), (16384, 3, "touch"), (32768, 2, "touch")]
#: (chunk bytes, nbuf, L), touch; the JAX list is (band, nbuf, L) in
#: (8, 2, 2), (8, 2, 4), (4, 2, 4), (8, 3, 2)
LANES = [(16384, 2, 2), (8192, 2, 4), (4096, 2, 4), (16384, 3, 2)]
KWAY = (2, 4, 8)
HBM2HBM = (32768, 4)  # (chunk bytes, nbuf) of the untouched ring
SMEM_OPTIN = 232_448  # the H100's opt-in shared memory a block
BAR_BYTES = 3072      # the header ahead of the stages (csrc/copy_probes.cu)
DRAW_BYTES = 32768    # the chunks a DYNAMIC ring draws at a time, in bytes (at least one)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("copy_probes")
    lib.ts_copy_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.ts_copy_probe.restype = ctypes.c_int
    lib.ts_copy_probe_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.ts_copy_probe_occupancy.restype = ctypes.c_int
    lib.ts_copy_probe_smem.argtypes = [ctypes.c_int] * 4
    lib.ts_copy_probe_smem.restype = ctypes.c_longlong
    return lib


def copy_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return x.clone()


def touch_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return x * c


def probe_smem(mode: str, nbuf: int, chunk: int, lanes: int) -> int:
    """Shared memory of a probe's block: the mbarriers, then each ring's
    read stages (and, but for "direct", as many write stages)."""
    return BAR_BYTES + lanes * (1 if mode == "direct" else 2) * nbuf * chunk


def probe_blocks(nbytes: int, chunk: int, lanes: int, n_sm: int, per_sm: int,
                 share: int = 1) -> int:
    """Blocks of a probe's grid: one resident wave (``per_sm`` blocks on
    each of ``n_sm`` SMs), its ``share``-th for one of ``share`` launches
    meant to run side by side, no more than the chunks fill (``lanes``
    rings a block), at least 1."""
    rings = -(-(-(-nbytes // chunk)) // lanes)
    return max(1, min(n_sm * max(1, per_sm) // share, rings))


def ring_chunks(nchunks: int, rings: int) -> list[range]:
    """The chunks each of ``rings`` static rings moves, in its order (ring
    g is block g // lanes, lane g % lanes): chunk i to ring i mod
    ``rings``."""
    return [range(g, nchunks, rings) for g in range(rings)]


def drawn_chunks(nchunks: int, rings: int, chunk: int, seed: int) -> tuple[list[list[int]], int]:
    """The chunks each of ``rings`` DYNAMIC rings moves, the rings reaching
    the counter in an order made from ``seed``, and the counter's value
    after the launch. A draw is ``per`` chunks (DRAW_BYTES' worth, at least
    one): it takes the counter's value d and adds 1, wrapping to 0 from
    ``draws + rings - 1`` (atomicInc), and gives chunks d*per to
    (d+1)*per; a ring stops at its first d past the draws."""
    rng = random.Random(seed)
    per = max(1, DRAW_BYTES // chunk)
    draws = -(-nchunks // per)
    out: list[list[int]] = [[] for _ in range(rings)]
    live, counter, limit = list(range(rings)), 0, draws + rings - 1
    while live:
        g = rng.choice(live)
        d, counter = counter, 0 if counter >= limit else counter + 1
        if d >= draws:
            live.remove(g)
        else:
            out[g].extend(range(d * per, min((d + 1) * per, nchunks)))
    return out, counter


def _plan(x, out, c, chunk: int, nbuf: int, lanes: int, mode: str, name: str, share: int = 1,
          blocks: int | None = None) -> int:
    """The grid of a probe over x (or each of its ``share`` equal slabs),
    ``probe_blocks``' unless given, after the checks the kernel needs:
    float32, contiguous, 16-byte aligned and a multiple of 16 bytes a slab,
    a stage ring that fits the card's opt-in shared memory and an SM."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: wants a contiguous float32 tensor")
    nbytes = x.numel() * 4 // share
    if nbytes % 16 or x.data_ptr() % 16 or out.data_ptr() % 16 or chunk % 16 or chunk <= 0:
        raise ValueError(f"{name}: bulk copies need 16-byte aligned tensors, a size and a chunk "
                         f"that are multiples of 16 bytes (size {nbytes}, chunk {chunk})")
    if mode == "touch" and (c.dtype != torch.float32 or c.device != x.device):
        raise ValueError(f"{name}: c must be a float32 tensor on {x.device}")
    need = _lib().ts_copy_probe_smem(MODES[mode], nbuf, chunk, lanes)
    if need > _optin(x.device):
        raise ValueError(f"{name}: {lanes} lane(s) of {nbuf} x {chunk} B stages need {need} B of "
                         f"shared memory, the card gives a block {_optin(x.device)}")
    n_sm, per_sm = _occupancy(x.device, MODES[mode], nbuf, chunk, lanes)
    if per_sm < 1:
        raise ValueError(f"{name}: {lanes} lane(s) of {nbuf} x {chunk} B stages do not fit an SM")
    return blocks or probe_blocks(nbytes, chunk, lanes, n_sm, per_sm, share)


def _launch(src: int, dst: int, nbytes: int, c, chunk: int, nbuf: int, lanes: int, mode: str,
            blocks: int, flags: int, counter: int | None, stream: int, name: str) -> None:
    """One ``probe_kernel`` launch on ``stream`` (a CUDA stream handle);
    ``counter`` points at the stream's chunk counter (DYNAMIC), else None."""
    lib = _lib()
    check_status(lib, lib.ts_copy_probe(src, dst, nbytes, chunk, nbuf, lanes, MODES[mode],
                                        c.data_ptr(), blocks, flags, counter, stream), name)


_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _counter_for(device: torch.device, stream: int, flags: int) -> int | None:
    """The chunk counter of DYNAMIC rings for one stream of one device (None
    without DYNAMIC): zero between launches (the last draw of each launch
    wraps it back to 0), and launches on one stream never overlap. It is
    zeroed on the current stream, which the launch must follow."""
    if not flags & DYNAMIC:
        return None
    t = _counters.get((device, stream))
    if t is None:
        t = _counters[(device, stream)] = torch.zeros(1, dtype=torch.int32, device=device)
    return t.data_ptr()


@functools.lru_cache(maxsize=None)
def _optin(device: torch.device) -> int:
    """The card's opt-in shared memory a block, in bytes."""
    with torch.cuda.device(device):
        return smem_optin(_lib(), "copy probes")


@functools.lru_cache(maxsize=None)
def _occupancy(device: torch.device, mode: int, nbuf: int, chunk: int,
               lanes: int) -> tuple[int, int]:
    """(SM count, blocks an SM holds) of one probe configuration on one card;
    the call also sets the kernel's shared-memory limit there."""
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(device):
        check_status(lib, lib.ts_copy_probe_occupancy(mode, nbuf, chunk, lanes, ctypes.byref(sms),
                                                      ctypes.byref(per_sm)), "copy probes")
    return sms.value, per_sm.value


def _check_args(nbuf: int, lanes: int, mode: str, flags: int) -> None:
    if nbuf not in (2, 3, 4):
        raise ValueError(f"nbuf must be 2, 3 or 4, got {nbuf}")
    if not 1 <= lanes <= 15:
        raise ValueError(f"lanes must be 1..15, got {lanes}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if flags & ~(DYNAMIC | EVICT_FIRST | PDL):
        raise ValueError(f"unknown flags {flags:#x}")


def _ring(wrapper, chunk: int, nbuf: int, lanes: int, mode: str, flags: int | None,
          blocks: int | None = None):
    """step(x, c) of one ring kernel, counting its launches on ``wrapper``;
    ``blocks`` is ``probe_blocks``' unless given (another grid, as
    ``bench/kernel_ab.py --sweep`` times them)."""
    flags = FLAGS if flags is None else flags
    _check_args(nbuf, lanes, mode, flags)
    plain = touch_plain if mode == "touch" else copy_plain
    name = wrapper.__name__

    def step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if not route(x, name):
            return plain(x, c)
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            grid = _plan(x, out, c, chunk, nbuf, lanes, mode, name, blocks=blocks)
            stream = stream_of(x).value
            _launch(x.data_ptr(), out.data_ptr(), x.numel() * 4, c, chunk, nbuf, lanes, mode,
                    grid, flags, _counter_for(x.device, stream, flags), stream, name)
        wrapper.launches += 1
        return out

    return step


def manual_stream(chunk: int, nbuf: int, mode: str, flags: int | None = None):
    """One ring of ``nbuf`` ``chunk``-byte stages a block; "copy" or "touch"."""
    if mode not in ("copy", "touch"):
        raise ValueError(f"mode must be copy or touch, got {mode!r}")
    return _ring(manual_stream, chunk, nbuf, 1, mode, flags)


def hbm2hbm(chunk: int = HBM2HBM[0], nbuf: int = HBM2HBM[1], flags: int | None = None):
    """Bulk copies in and out of one ring, the data untouched by any thread."""
    return _ring(hbm2hbm, chunk, nbuf, 1, "direct", flags)


def lanes_stream(chunk: int, nbuf: int, L: int, mode: str = "touch", flags: int | None = None):
    """L independent rings a block, each with its own barriers."""
    if mode not in ("copy", "touch"):
        raise ValueError(f"mode must be copy or touch, got {mode!r}")
    return _ring(lanes_stream, chunk, nbuf, L, mode, flags)


def kway_hbm2hbm(K: int, chunk: int = HBM2HBM[0], nbuf: int = HBM2HBM[1],
                 flags: int | None = None):
    """``hbm2hbm`` over K disjoint slabs of the leading dim, one launch a slab
    on its own stream with a K-th of one resident wave, joined back to the
    caller's stream."""
    flags = FLAGS if flags is None else flags
    _check_args(nbuf, 1, "direct", flags)

    def step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if not route(x, "kway_hbm2hbm"):
            return copy_plain(x, c)
        if x.shape[0] % K:
            raise ValueError(f"kway_hbm2hbm: leading dim {x.shape[0]} not divisible by K={K}")
        out = torch.empty_like(x)
        slab = x.numel() * 4 // K
        main = torch.cuda.current_stream(x.device)
        streams, ready, done = _streams(x.device, K)
        with torch.cuda.device(x.device):
            grid = _plan(x, out, c, chunk, nbuf, 1, "direct", "kway_hbm2hbm", share=K)
            counters = [_counter_for(x.device, s.cuda_stream, flags) for s in streams]
            ready.record(main)  # after the counters' first zeroing on main
            for i, s in enumerate(streams):
                s.wait_event(ready)
                _launch(x.data_ptr() + i * slab, out.data_ptr() + i * slab, slab, c, chunk, nbuf,
                        1, "direct", grid, flags, counters[i], s.cuda_stream, "kway_hbm2hbm")
                kway_hbm2hbm.launches += 1
                done[i].record(s)
        # the caller's stream waits for every slab, so x and out need no
        # record_stream: whatever reuses their memory there comes after
        for e in done:
            main.wait_event(e)
        return out

    return step


@functools.lru_cache(maxsize=None)
def _streams(device: torch.device, k: int) -> tuple:
    """K side streams of a device, an event to start them and one each to
    join them (an event may be recorded again once waited on)."""
    return (tuple(torch.cuda.Stream(device) for _ in range(k)), torch.cuda.Event(),
            tuple(torch.cuda.Event() for _ in range(k)))


def xla_touch():
    """``x * c`` in one torch call: the touch's library figure."""
    return touch_plain


def library_copy():
    """One ``Tensor.copy_`` into a fresh tensor: the copy's library figure."""
    return lambda x, c: torch.empty_like(x).copy_(x)


def _chain(step, nsteps: int):
    def run(x, c):
        for _ in range(nsteps):
            x = step(x, c)
        return x

    return run


def race(name: str, step, steps_lo: int = 50, steps_hi: int = 250, iters: int = 3,
         device=None) -> dict:
    """The marginal ms a step (chains of ``steps_hi`` and ``steps_lo`` steps,
    the difference over the step difference) and rd+wr GB/s over twice the
    array's bytes: ``{"name", "ms", "gbps"}``."""
    dev = resolve_device(device)
    x = torch.ones((NZ, CY, CX), dtype=torch.float32, device=dev)
    c = torch.full((1,), 1.0 + 2 ** -20, dtype=torch.float32, device=dev)
    lo = time_device(_chain(step, steps_lo), x, c, iters=iters, warmup=1, name=f"{name}@{steps_lo}")
    hi = time_device(_chain(step, steps_hi), x, c, iters=iters, warmup=1, name=f"{name}@{steps_hi}")
    marg = (hi.p50 - lo.p50) / (steps_hi - steps_lo)
    return {"name": name, "ms": marg * 1e3, "gbps": 2 * x.numel() * 4 / marg / 1e9}


def probes() -> list:
    """(name, step) of every probe, in the JAX module's order, then the
    library figures."""
    out = [("hbm2hbm", hbm2hbm())]
    out += [(f"manual-{mode}-chunk{chunk}-nbuf{nbuf}", manual_stream(chunk, nbuf, mode))
            for chunk, nbuf, mode in MANUAL]
    out += [(f"hbm2hbm-{k}way", kway_hbm2hbm(k)) for k in KWAY]
    out += [(f"lanes{L}-touch-chunk{chunk}-nbuf{nbuf}", lanes_stream(chunk, nbuf, L))
            for chunk, nbuf, L in LANES]
    out += [("xla-touch", xla_touch()), ("copy_", library_copy())]
    return out


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (manual_stream, hbm2hbm, kway_hbm2hbm, lanes_stream)
reset_launches, launch_counts = counters(WRAPPERS)


def main(argv=None) -> int:
    dev = resolve_device(None)
    print(f"# {torch.cuda.get_device_name(dev)}: 256x512x512 f32, marginal ms a step "
          f"(50 -> 250 steps)", flush=True)
    best = None
    for name, step in probes():
        r = race(name, step, device=dev)
        print(f"{name}: marginal {r['ms']:.4f} ms/step ({r['gbps']:.0f} GB/s rd+wr)", flush=True)
        if best is None or r["gbps"] > best["gbps"]:
            best = r
    print(f"measured copy rate: {best['gbps']:.0f} GB/s rd+wr ({best['name']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
