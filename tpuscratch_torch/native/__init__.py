"""ctypes binding for the native halo planner (``native/src/halo_geometry.cpp``)
and the pooled host allocator (``native/src/host_pool.cpp``, bound in
``native.hostpool``).

The twin of ``tpuscratch.native``. The JAX package loads a library that
``make -C native`` or its wheel left on disk, and falls back to the
pure-Python planner when there is none. The port builds its own, as it
builds its kernels (``ops.common``): at first use, ``g++`` compiles both
sources with the Makefile's flags into ``build/tpuscratch_torch/`` beside
the package, a library a source hash, so an edited source rebuilds. A
failed build raises with the compiler's message; nothing falls back. The
planner mirrors ``runtime.topology`` and ``halo.layout`` one for one (the
tests hold the two equal, transfer for transfer); the halo plans of
``halo.exchange`` and ``halo.halo3d`` take it, and the pure-Python planner
stays as their plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
#: the kernels' build directory (``ops.common.BUILD_DIR``; ``ops`` imports
#: the halo package, which imports this one)
BUILD_DIR = _ROOT / "build" / "tpuscratch_torch"
#: the native sources, in the repository beside the package
SOURCES = tuple(_ROOT / "native" / "src" / name for name in ("halo_geometry.cpp", "host_pool.cpp"))
#: the Makefile's flags (warnings aside) and the shared-library link
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
#: the 3D planner's signature (``ts_abi_version``): prototypes below match it
ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpuscratch_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source hash is built; its path.
    Written to a per-process temporary file and renamed into place, so a
    concurrent build never loads a half-written library."""
    out = _target()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (CXX, g++, c++) to build the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the native library: cannot run {cxx}: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at first use, its prototypes set. Raises
    when it cannot be built or its 3D planner's ABI is not ABI_VERSION."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32 = ctypes.c_int32
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.ts_neighbor.restype = i32
        lib.ts_neighbor.argtypes = [i32] * 7
        lib.ts_send_permutation.restype = i32
        lib.ts_send_permutation.argtypes = [i32] * 6 + [p32, p32]
        lib.ts_halo_rect.restype = None
        lib.ts_halo_rect.argtypes = [i32] * 6 + [p32]
        lib.ts_send_rect.restype = None
        lib.ts_send_rect.argtypes = [i32] * 6 + [p32]
        lib.ts_build_plan.restype = i32
        lib.ts_build_plan.argtypes = [i32] * 9 + [p32] * 6
        lib.ts_neighbor3d.restype = i32
        lib.ts_neighbor3d.argtypes = [i32] * 10
        lib.ts_build_plan3d.restype = i32
        lib.ts_build_plan3d.argtypes = [i32] * 13 + [p32] * 6
        lib.ts_abi_version.restype = i32
        lib.ts_abi_version.argtypes = []
        if lib.ts_abi_version() != ABI_VERSION:
            raise RuntimeError(f"native library ABI {lib.ts_abi_version()}, "
                               f"the binding wants {ABI_VERSION}")
        _lib = lib
        return lib


def has_plan3d() -> bool:
    """Whether the library's 3D planner has this binding's ABI (always, for
    the library the port builds: ``load`` refuses another)."""
    return load().ts_abi_version() == ABI_VERSION


def _rect(fn, core_h: int, core_w: int, hy: int, hx: int, dr: int, dc: int):
    out = (ctypes.c_int32 * 4)()
    fn(core_h, core_w, hy, hx, dr, dc, out)
    return tuple(out)


def neighbor(dims, periodic, rank: int, offset) -> Optional[int]:
    got = load().ts_neighbor(dims[0], dims[1], int(periodic[0]), int(periodic[1]),
                             rank, offset[0], offset[1])
    return None if got < 0 else got


def send_permutation(dims, periodic, offset) -> list[tuple[int, int]]:
    n = dims[0] * dims[1]
    src = (ctypes.c_int32 * n)()
    dst = (ctypes.c_int32 * n)()
    count = load().ts_send_permutation(dims[0], dims[1], int(periodic[0]), int(periodic[1]),
                                       offset[0], offset[1], src, dst)
    return [(src[i], dst[i]) for i in range(count)]


def halo_rect(core_h, core_w, hy, hx, offset):
    return _rect(load().ts_halo_rect, core_h, core_w, hy, hx, *offset)


def send_rect(core_h, core_w, hy, hx, offset):
    return _rect(load().ts_send_rect, core_h, core_w, hy, hx, *offset)


def _perms(src, dst, counts, n: int, stride: int) -> list:
    # bulk views + tolist(): element-wise ctypes indexing would dominate the
    # call on large meshes (8 x ranks entries)
    s = np.ctypeslib.as_array(src).reshape(-1, stride)
    d = np.ctypeslib.as_array(dst).reshape(-1, stride)
    return [list(zip(s[i, :counts[i]].tolist(), d[i, :counts[i]].tolist())) for i in range(n)]


def build_plan(dims, periodic, core_h, core_w, hy, hx, neighbors=8):
    """The full 2D plan in one native call: a dict a direction, {direction,
    send_rect, recv_rect, perm}, in ALL_DIRECTIONS order (EDGE_DIRECTIONS'
    at 4 neighbors); rects are (y, x, h, w) in padded coordinates."""
    ndir_max, stride = 8, dims[0] * dims[1]
    dirs = (ctypes.c_int32 * (2 * ndir_max))()
    send_rects = (ctypes.c_int32 * (4 * ndir_max))()
    recv_rects = (ctypes.c_int32 * (4 * ndir_max))()
    perm_src = (ctypes.c_int32 * (ndir_max * stride))()
    perm_dst = (ctypes.c_int32 * (ndir_max * stride))()
    counts = (ctypes.c_int32 * ndir_max)()
    ndirs = load().ts_build_plan(dims[0], dims[1], int(periodic[0]), int(periodic[1]),
                                 core_h, core_w, hy, hx, neighbors,
                                 dirs, send_rects, recv_rects, perm_src, perm_dst, counts)
    if ndirs < 0:
        raise ValueError(f"native planner rejected dims={dims} core=({core_h},{core_w}) "
                         f"halo=({hy},{hx}) neighbors={neighbors}")
    perms = _perms(perm_src, perm_dst, counts, ndirs, stride)
    return [{"direction": (dirs[2 * i], dirs[2 * i + 1]),
             "send_rect": tuple(send_rects[4 * i:4 * i + 4]),
             "recv_rect": tuple(recv_rects[4 * i:4 * i + 4]),
             "perm": perms[i]} for i in range(ndirs)]


def build_plan3d(dims, periodic, core, halo, neighbors: int = 6):
    """The full 3D plan (6 faces or all 26 directions) in one native call:
    a dict a direction, {offset, send_rect, recv_rect, perm}, in
    ``halo3d.OFFSETS26`` order; rects are (o0, o1, o2, e0, e1, e2) in
    padded coordinates."""
    nranks = dims[0] * dims[1] * dims[2]
    nd = 26
    offs = (ctypes.c_int32 * (3 * nd))()
    send_rects = (ctypes.c_int32 * (6 * nd))()
    recv_rects = (ctypes.c_int32 * (6 * nd))()
    perm_src = (ctypes.c_int32 * (nd * nranks))()
    perm_dst = (ctypes.c_int32 * (nd * nranks))()
    counts = (ctypes.c_int32 * nd)()
    nfaces = load().ts_build_plan3d(
        dims[0], dims[1], dims[2], int(periodic[0]), int(periodic[1]), int(periodic[2]),
        core[0], core[1], core[2], halo[0], halo[1], halo[2], neighbors,
        offs, send_rects, recv_rects, perm_src, perm_dst, counts)
    if nfaces < 0:
        raise ValueError(f"native 3D planner rejected dims={dims} core={core} "
                         f"halo={halo} neighbors={neighbors}")
    perms = _perms(perm_src, perm_dst, counts, nfaces, nranks)
    return [{"offset": tuple(offs[3 * i:3 * i + 3]),
             "send_rect": tuple(send_rects[6 * i:6 * i + 6]),
             "recv_rect": tuple(recv_rects[6 * i:6 * i + 6]),
             "perm": perms[i]} for i in range(nfaces)]
