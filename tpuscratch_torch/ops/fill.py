"""Device-side initialisation kernels (``csrc/fill.cu``).

The twin of ``tpuscratch.ops.fill``: the reference's ``init_vector``
(filling a vector on the device, so no host-to-device copy is paid) and
``InitKernel`` (the row-major linear index per cell, a test pattern).

- ``fill(shape, value, dtype)``: every element is ``value`` cast to
  ``dtype`` on the host as ``jnp.asarray([value], dtype)`` casts it; the
  kernel writes that bit pattern, so one kernel serves every dtype.
- ``iota2d(shape, dtype)``: ``r * w + c`` computed in the dtype (two
  rounded ops in float types), bit-equal to the TPU kernel.

Entry points run on the card unless ``device='cpu'`` is passed, which runs
the plain torch versions (``fill_plain``, ``iota2d_plain``); the card-side
checks compare the kernels with those. Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuscratch_torch.ops.common import check_status, counters, library, route, stream_of
from tpuscratch_torch.runtime.mesh import resolve_device

#: dtype -> the kernel's dtype code (``csrc/fill.cu``: ts_iota2d)
IOTA_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3, torch.int64: 4}
_BITS_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("fill")
    lib.ts_fill.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                            ctypes.c_int, ctypes.c_void_p]
    lib.ts_iota2d.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_void_p]
    lib.ts_fill.restype = lib.ts_iota2d.restype = ctypes.c_int
    return lib


def _host_value(value, dtype: torch.dtype) -> torch.Tensor:
    """``value`` cast to ``dtype`` on the host (one element)."""
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


def fill(shape, value, dtype=torch.float32, device=None) -> torch.Tensor:
    """An array of ``shape`` holding ``value`` in ``dtype``, written on the
    device (no host-to-device copy of the array)."""
    out = torch.empty(_shape(shape), dtype=dtype, device=resolve_device(device))
    if not route(out, "fill"):
        return out.copy_(fill_plain(out.shape, value, dtype))
    host = _host_value(value, dtype)
    size = host.element_size()
    if size not in _BITS_OF_SIZE:
        raise TypeError(f"fill: no bit pattern for {dtype}")
    bits = int(host.view(_BITS_OF_SIZE[size]).item()) & ((1 << (8 * size)) - 1)
    with torch.cuda.device(out.device):
        check_status(_lib(), _lib().ts_fill(
            out.data_ptr(), out.numel() * size, bits, size, stream_of(out)), "fill")
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
    with torch.cuda.device(out.device):
        check_status(_lib(), _lib().ts_iota2d(
            out.data_ptr(), shape[0], shape[1], IOTA_DTYPES[dtype], stream_of(out)), "iota2d")
    iota2d.launches += 1
    return out


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (fill, iota2d)
reset_launches, launch_counts = counters(WRAPPERS)
