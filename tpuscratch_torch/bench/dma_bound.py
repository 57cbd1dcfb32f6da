"""Copy-rate probes: how fast can the card stream a 256x512x512 f32 array?

The twin of ``tpuscratch.bench.dma_bound``, whose Pallas probes asked how
fast the TPU's DMA engines copy 256 MiB. Here the same four probes are
``csrc/copy_probes.cu`` kernels (bulk asynchronous copies through a ring of
shared-memory stages, see the source), each a factory returning ``step(x,
c) -> y``:

- ``manual_stream(chunk, nbuf, mode)``: one ring a block, ``nbuf`` stages of
  ``chunk`` bytes; ``mode`` "copy" moves each chunk through registers,
  "touch" multiplies it by ``c`` on the way;
- ``hbm2hbm()``: bulk copies in and out of one ring (``HBM2HBM``), no
  thread touches the data;
- ``kway_hbm2hbm(K)``: ``hbm2hbm`` over K disjoint slabs, each slab its own
  launch on its own stream (the TPU's K concurrent DMAs, K semaphores);
- ``lanes_stream(chunk, nbuf, L, mode)``: L independent rings a block;

beside ``xla_touch`` (``x * c``, one torch multiply: the library figure of
the touch, as XLA's fused multiply was on the TPU) and ``copy_`` (one
``Tensor.copy_``, the library figure of the copy). The plain versions are
``x.clone()`` and ``x * c``; a CPU tensor takes them. ``race`` times a probe
by differencing chains of 50 and 250 steps, each step reading the previous
one's output, and reports rd+wr GB/s over 2 x 256 MiB; the best probe is the
card's measured copy rate. A TPU band was a 1 MiB z-plane, past the 227 KB
a block may hold, so chunks are bytes and the probe lists below are the
card's own (the JAX lists beside them).

``python -m tpuscratch_torch.bench.dma_bound`` runs every probe on the card.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from tpuscratch_torch.bench.timing import time_device
from tpuscratch_torch.ops.common import (check_status, counters, library, route, smem_optin,
                                         stream_of)
from tpuscratch_torch.runtime.mesh import resolve_device

NZ, CY, CX = 256, 512, 512
BYTES = NZ * CY * CX * 4
MODES = {"direct": 0, "copy": 1, "touch": 2}
#: (chunk bytes, nbuf, mode); the JAX list is (band z-planes, nbuf, mode) in
#: (8, 2), (8, 3), (16, 2), each copy and touch
MANUAL = [(16384, 2, "copy"), (16384, 3, "copy"), (32768, 2, "copy"),
          (16384, 2, "touch"), (16384, 3, "touch"), (32768, 2, "touch")]
#: (chunk bytes, nbuf, L), touch; the JAX list is (band, nbuf, L) in
#: (8, 2, 2), (8, 2, 4), (4, 2, 4), (8, 3, 2)
LANES = [(16384, 2, 2), (8192, 2, 4), (4096, 2, 4), (16384, 3, 2)]
KWAY = (2, 4, 8)
HBM2HBM = (32768, 4)  # (chunk bytes, nbuf) of the untouched ring


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("copy_probes")
    lib.ts_copy_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.ts_copy_probe.restype = ctypes.c_int
    lib.ts_copy_probe_smem.argtypes = [ctypes.c_int] * 4
    lib.ts_copy_probe_smem.restype = ctypes.c_longlong
    return lib


def copy_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return x.clone()


def touch_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return x * c


def _probe(x, out, c, chunk: int, nbuf: int, lanes: int, mode: str, name: str) -> None:
    """One ``probe_kernel`` launch on the current stream, after the checks the
    kernel needs: float32, contiguous, 16-byte aligned and a multiple of 16
    bytes, a stage ring that fits the card's opt-in shared memory."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: wants a contiguous float32 tensor")
    nbytes = x.numel() * 4
    if nbytes % 16 or x.data_ptr() % 16 or out.data_ptr() % 16 or chunk % 16 or chunk <= 0:
        raise ValueError(f"{name}: bulk copies need 16-byte aligned tensors, a size and a chunk "
                         f"that are multiples of 16 bytes (size {nbytes}, chunk {chunk})")
    if mode == "touch" and (c.dtype != torch.float32 or c.device != x.device):
        raise ValueError(f"{name}: c must be a float32 tensor on {x.device}")
    lib = _lib()
    need = lib.ts_copy_probe_smem(MODES[mode], nbuf, chunk, lanes)
    if need > _optin(x.device):
        raise ValueError(f"{name}: {lanes} lane(s) of {nbuf} x {chunk} B stages need {need} B of "
                         f"shared memory, the card gives a block {_optin(x.device)}")
    check_status(lib, lib.ts_copy_probe(x.data_ptr(), out.data_ptr(), nbytes, chunk, nbuf, lanes,
                                        MODES[mode], c.data_ptr(), stream_of(x)), name)


@functools.lru_cache(maxsize=None)
def _optin(device: torch.device) -> int:
    """The card's opt-in shared memory a block, in bytes."""
    with torch.cuda.device(device):
        return smem_optin(_lib(), "copy probes")


def _check_args(nbuf: int, lanes: int, mode: str) -> None:
    if nbuf not in (2, 3, 4):
        raise ValueError(f"nbuf must be 2, 3 or 4, got {nbuf}")
    if not 1 <= lanes <= 15:
        raise ValueError(f"lanes must be 1..15, got {lanes}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")


def _ring(wrapper, chunk: int, nbuf: int, lanes: int, mode: str):
    """step(x, c) of one ring kernel, counting its launches on ``wrapper``."""
    _check_args(nbuf, lanes, mode)
    plain = touch_plain if mode == "touch" else copy_plain

    def step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if not route(x, wrapper.__name__):
            return plain(x, c)
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            _probe(x, out, c, chunk, nbuf, lanes, mode, wrapper.__name__)
        wrapper.launches += 1
        return out

    return step


def manual_stream(chunk: int, nbuf: int, mode: str):
    """One ring of ``nbuf`` ``chunk``-byte stages a block; "copy" or "touch"."""
    if mode not in ("copy", "touch"):
        raise ValueError(f"mode must be copy or touch, got {mode!r}")
    return _ring(manual_stream, chunk, nbuf, 1, mode)


def hbm2hbm():
    """Bulk copies in and out of one ring, the data untouched by any thread."""
    return _ring(hbm2hbm, *HBM2HBM, 1, "direct")


def lanes_stream(chunk: int, nbuf: int, L: int, mode: str = "touch"):
    """L independent rings a block, each with its own barriers."""
    if mode not in ("copy", "touch"):
        raise ValueError(f"mode must be copy or touch, got {mode!r}")
    return _ring(lanes_stream, chunk, nbuf, L, mode)


def kway_hbm2hbm(K: int):
    """``hbm2hbm`` over K disjoint slabs of the leading dim, one launch a slab
    on its own stream, joined back to the caller's stream."""

    def step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if not route(x, "kway_hbm2hbm"):
            return copy_plain(x, c)
        if x.shape[0] % K:
            raise ValueError(f"kway_hbm2hbm: leading dim {x.shape[0]} not divisible by K={K}")
        out = torch.empty_like(x)
        slab = x.shape[0] // K
        main = torch.cuda.current_stream(x.device)
        ready = main.record_event()
        done = []
        with torch.cuda.device(x.device):
            for i, s in enumerate(_streams(x.device, K)):
                s.wait_event(ready)
                with torch.cuda.stream(s):
                    _probe(x[i * slab:(i + 1) * slab], out[i * slab:(i + 1) * slab], c,
                           *HBM2HBM, 1, "direct", "kway_hbm2hbm")
                    kway_hbm2hbm.launches += 1
                    done.append(s.record_event())
                x.record_stream(s)
                out.record_stream(s)
        for e in done:
            main.wait_event(e)
        return out

    return step


@functools.lru_cache(maxsize=None)
def _streams(device: torch.device, k: int) -> tuple:
    return tuple(torch.cuda.Stream(device) for _ in range(k))


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
