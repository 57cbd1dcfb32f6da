"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. Nothing is built when a module is imported: the first kernel
launch builds every source (one ``nvcc`` per source, all started
together) into ``build/tpuscratch_torch/`` beside the package, and a
library is rebuilt when its source's hash changes. A failed build raises
with nvcc's stderr. There is no fallback: a wrapper given a CUDA tensor
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuscratch_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale source in parallel; return name -> library path.

    Each nvcc writes a per-process temporary file that is renamed into
    place, so a concurrent build never loads a half-written library. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in _sources()}
    stale = {name: st for name, st in targets.items() if not st[1].exists()}
    if stale:
        nvcc = nvcc_path()
        procs = {}
        for name, (src, out) in stale.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{stderr}")
                continue
            Path(str(out) + ".log").write_text(stdout + stderr)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def build_log(name: str) -> str:
    """The compiler report of ``csrc/<name>.cu``'s current build."""
    log = Path(str(_target(CSRC / f"{name}.cu")) + ".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def check_cuda(t: torch.Tensor, name: str, ndim: int,
               dtypes: tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """What every kernel wrapper requires of a CUDA input tensor: one of
    the ``dtypes`` its kernel takes, at least ``ndim`` dims, contiguous."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got {t.dtype}")
    if t.ndim < ndim:
        raise ValueError(f"{name}: need >= {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def route(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def check_status(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise on a launcher's nonzero CUDA status (``lib`` exports
    ``ts_error_string``, as every source does)."""
    if err != 0:
        lib.ts_error_string.argtypes = [ctypes.c_int]
        lib.ts_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.ts_error_string(err).decode()})")


def taps_args(taps) -> list:
    """The launcher arguments ``(n, c[9], dy[9], dx[9])`` of the ``Taps``
    (``csrc/stencil_taps.cuh``) for ``taps``, a sequence of ``(dy, dx,
    coefficient)`` in the order the kernel sums them."""
    n = len(taps)
    if not 1 <= n <= 9:
        raise ValueError(f"a 3x3 stencil has 1 to 9 taps, got {n}")
    pad = [(0, 0, 0.0)] * (9 - n)
    dy, dx, c = zip(*(list(taps) + pad))
    return [n, (ctypes.c_float * 9)(*c), (ctypes.c_int * 9)(*dy), (ctypes.c_int * 9)(*dx)]


def smem_optin(lib: ctypes.CDLL, name: str) -> int:
    """The card's opt-in shared memory per block, in bytes, through
    ``lib``'s ``ts_smem_optin``."""
    lib.ts_smem_optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ts_smem_optin.restype = ctypes.c_int
    optin = ctypes.c_int(0)
    check_status(lib, lib.ts_smem_optin(ctypes.byref(optin)), name)
    return optin.value


def trapezoid_tile(optin: int, depth: int, name: str) -> int:
    """Output tile edge of a shared-memory trapezoid of ``depth`` substeps:
    the largest of 64, 32, 16 or 8 whose two (tile + 2*depth)^2 f32
    windows fit ``optin`` bytes. Raises when none does."""
    for tile in (64, 32, 16, 8):
        if 2 * (tile + 2 * depth) ** 2 * 4 <= optin:
            return tile
    raise ValueError(
        f"{name}: depth {depth} is too deep for one block's shared memory "
        f"({optin} B holds no (8 + 2*{depth})^2 window pair)"
    )


def counters(wrappers):
    """``(reset_launches, launch_counts)`` over kernel wrappers, each of
    which counts its kernel's launches in a ``launches`` attribute."""
    for w in wrappers:
        w.launches = 0

    def reset_launches() -> None:
        for w in wrappers:
            w.launches = 0

    def launch_counts() -> dict[str, int]:
        return {w.__name__: w.launches for w in wrappers}

    return reset_launches, launch_counts


LANES = 128  # the TPU lane width: last dim of the JAX package's blocked operands


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` -> ``(..., rows, 128)``, zero-padding n to whole 8x128
    tiles (the JAX package's ``to_lanes``, batched over leading dims). Zero
    padding is neutral for sum-reductions; the CUDA kernels take the flat
    vector and need no padding themselves."""
    n = x.shape[-1]
    quantum = LANES * 8
    padded = (n + quantum - 1) // quantum * quantum
    if padded != n:
        x = torch.nn.functional.pad(x, (0, padded - n))
    return x.reshape(*x.shape[:-1], -1, LANES)
