"""Device-side initialisation kernels (``csrc/fill.cu``).

The twin of ``tpuscratch.ops.fill``: the reference's ``init_vector``
(filling a vector on the device, so no host-to-device copy is paid) and
``InitKernel`` (the row-major linear index per cell, a test pattern).

- ``fill(shape, value, dtype)``: every element is ``value`` cast to
  ``dtype`` on the host as ``jnp.asarray([value], dtype)`` casts it; the
  kernel writes that bit pattern, so one kernel serves every dtype.
- ``iota2d(shape, dtype)``: ``r * w + c`` computed in the dtype (two
  rounded ops in float types; integers, 1 to 8 bytes, wrap), bit-equal
  to the TPU kernel.

Entry points run on the card unless ``device='cpu'`` is passed, which runs
the plain torch versions (``fill_plain``, ``iota2d_plain``); the card-side
checks compare the kernels with those. Each wrapper counts its launches.
Both kernels take one grid, a host rule: ``fill_blocks`` (a block a 256
16-byte units of the output); ``fill_writes`` and ``iota_writes`` model
which bytes and which elements their kernels write on a grid.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tpuscratch_torch.ops.common import check_status, counters, library, route, stream_of
from tpuscratch_torch.runtime.mesh import resolve_device

#: dtype -> the kernel's dtype code (``csrc/fill.cu``: ts_iota2d)
IOTA_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3, torch.int64: 4, torch.int8: 5, torch.uint8: 6,
               torch.int16: 7}
_BITS_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
FILL_THREADS = 256  # threads a block of fill's kernel (csrc/fill.cu), a 16-byte unit each


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("fill")
    lib.ts_fill.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ts_iota2d.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ts_fill.restype = lib.ts_iota2d.restype = ctypes.c_int
    return lib


def _host_value(value, dtype: torch.dtype) -> torch.Tensor:
    """``value`` cast to ``dtype`` on the host (one element). A float into
    an integer dtype truncates and saturates at the dtype's range (NaN
    gives 0), as the JAX package's conversion does."""
    if isinstance(value, float) and not (dtype.is_floating_point or dtype.is_complex
                                         or dtype == torch.bool):
        info = torch.iinfo(dtype)
        v = 0.0 if math.isnan(value) else min(max(math.trunc(value), info.min), info.max)
        return torch.tensor([v], dtype=dtype)
    return torch.tensor([value], dtype=dtype)


def _shape(shape) -> tuple[int, ...]:
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"negative dim in {shape}")
    return shape


def fill_plain(shape, value, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``fill``'s plain torch version."""
    host = _host_value(value, dtype)
    return host.to(device).expand(_shape(shape)).contiguous()


def fill_blocks(nbytes: int, cap: int | None = None) -> int:
    """The grid of ``fill`` and ``iota2d`` for an output of ``nbytes``: a
    block a FILL_THREADS 16-byte units of the body (each thread one store),
    at most ``cap`` (the blocks then stride over the body), at least 1. The
    tail under 16 bytes goes to block 0's first threads, byte by byte
    (``fill``) or element by element (``iota2d``)."""
    blocks = max(1, -(-(nbytes // 16) // FILL_THREADS))
    return blocks if cap is None else max(1, min(cap, blocks))


def fill_writes(blocks: int, nbytes: int) -> np.ndarray:
    """How many times the kernel writes each of ``nbytes`` bytes on a grid
    of ``blocks``: the index arithmetic of ``csrc/fill.cu``, in numpy."""
    n16, ntail = nbytes // 16, nbytes % 16
    count = np.zeros(nbytes, np.int64)
    body = count[:16 * n16].reshape(n16, 16)
    stride = blocks * FILL_THREADS
    for t in range(min(stride, n16)):   # thread t: units t, t + stride, ...
        body[t::stride] += 1
    count[16 * n16:] += 1               # block 0's threads 0 .. ntail - 1
    return count


def iota_writes(blocks: int, h: int, w: int, esize: int) -> np.ndarray:
    """How many times ``iota2d``'s kernel writes each element of an (h, w)
    output of ``esize``-byte elements on a grid of ``blocks``: the index
    arithmetic of ``csrc/fill.cu`` in numpy. Thread t takes the 16-byte
    units t, t + stride, ...; a unit finds its first row and column by one
    division and walks ``16 // esize`` elements, across a row end where it
    meets one; block 0's first threads write the tail element by element.
    A write lands at the (r, c) the walk holds, and is counted there."""
    per = 16 // esize
    n = h * w
    n16, ntail = n // per, n % per
    count = np.zeros((h, w), np.int64)
    stride = blocks * FILL_THREADS
    for t in range(min(stride, n16)):
        q = np.arange(t, n16, stride)
        r, c = q * per // w, q * per % w
        for _ in range(per):
            np.add.at(count, (r, c), 1)
            c = c + 1
            wrap = c == w
            r, c = np.where(wrap, r + 1, r), np.where(wrap, 0, c)
    i = n16 * per + np.arange(ntail)
    np.add.at(count, (i // w, i % w), 1)
    return count


def fill(shape, value, dtype=torch.float32, device=None) -> torch.Tensor:
    """An array of ``shape`` holding ``value`` in ``dtype``, written on the
    device (no host-to-device copy of the array)."""
    out = torch.empty(_shape(shape), dtype=dtype, device=resolve_device(device))
    if not route(out, "fill"):
        return out.copy_(fill_plain(out.shape, value, dtype))
    return _fill_launch(out, value)


def _fill_launch(out: torch.Tensor, value, blocks: int | None = None) -> torch.Tensor:
    """One fill launch into the CUDA tensor ``out``; ``blocks`` is
    ``fill_blocks``'s grid unless given (another grid, as
    ``bench/kernel_ab.py --sweep`` times them)."""
    host = _host_value(value, out.dtype)
    size = host.element_size()
    if size not in _BITS_OF_SIZE:
        raise TypeError(f"fill: no bit pattern for {out.dtype}")
    bits = int(host.view(_BITS_OF_SIZE[size]).item()) & ((1 << (8 * size)) - 1)
    nbytes = out.numel() * size
    with torch.cuda.device(out.device):
        check_status(_lib(), _lib().ts_fill(
            out.data_ptr(), nbytes, bits, size, blocks or fill_blocks(nbytes), stream_of(out)),
            "fill")
    fill.launches += 1
    return out


def iota2d_plain(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``iota2d``'s plain torch version: the same two rounded ops in the dtype."""
    h, w = _shape(shape)
    r = torch.arange(h, device=device).to(dtype)[:, None]
    c = torch.arange(w, device=device).to(dtype)[None, :]
    return r * torch.tensor(w, device=device).to(dtype) + c  # w in the dtype (inf past f16's range)


def iota2d(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Row-major linear index per cell of a (rows, cols) array: ``r * w + c``
    in ``dtype``, the InitKernel test pattern."""
    shape = _shape(shape)
    if len(shape) != 2:
        raise ValueError(f"iota2d wants (rows, cols), got {shape}")
    out = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    if not route(out, "iota2d"):
        return out.copy_(iota2d_plain(shape, dtype))
    if dtype not in IOTA_DTYPES:
        raise TypeError(f"iota2d: the CUDA kernel takes {list(IOTA_DTYPES)}, got {dtype}")
    return _iota_launch(out)


def _iota_launch(out: torch.Tensor, blocks: int | None = None) -> torch.Tensor:
    """One iota2d launch into the CUDA tensor ``out``; ``blocks`` is
    ``fill_blocks``'s grid unless given (another grid, as
    ``bench/kernel_ab.py --sweep`` times them)."""
    h, w = out.shape
    blocks = blocks or fill_blocks(out.numel() * out.element_size())
    with torch.cuda.device(out.device):
        check_status(_lib(), _lib().ts_iota2d(
            out.data_ptr(), h, w, IOTA_DTYPES[out.dtype], blocks, stream_of(out)), "iota2d")
    iota2d.launches += 1
    return out


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (fill, iota2d)
reset_launches, launch_counts = counters(WRAPPERS)
