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
import dataclasses
import functools
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


#: The row march of ``csrc/stencil_taps.cuh`` (``stream2d_kernel``,
#: ``dma_deep_kernel``, ``deep_trapezoid_kernel``): columns a lane
#: (``march::CX``), window columns a strip (``march::WIN``), stages a block
#: at most (``march::MAX_WARPS``), input rows in flight (``march::AHEAD``),
#: rows of the input ring and of a hand-over ring (``march::RING``,
#: ``march::HAND``) and the levels a stage may hold.
MARCH_CX, MARCH_WARPS, MARCH_AHEAD, MARCH_RING, MARCH_HAND = 8, 8, 6, 8, 4
MARCH_WIN = 32 * MARCH_CX
MARCH_LEVELS = (1, 4)
#: Registers a thread of the march may take at most: its launch bounds
#: state only the block's threads, 32 a stage and the I/O warp's 32, at most
#: 288, which leave a thread 224.
MARCH_REGS = 224
#: Tap positions p = 3 (dy + 1) + (dx + 1) with an instantiation of their
#: own (``march::MASK_*``: the paths' Jacobi and 8 points without the
#: centre); any other set runs under a runtime mask (template mask 0).
MARCH_MASKS = (0x0AA, 0x1EF)


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """One launch of the row march: ``depth`` substeps in stages of
    ``levels`` levels, ``warps`` stages a block (and an I/O warp); a block
    owns a strip of ``width`` output columns (the window less an
    ``apron`` a side) and a chunk of ``rows`` output rows; ``strips *
    chunks`` blocks a grid, of ``smem`` bytes of shared memory each."""

    depth: int
    levels: int
    warps: int
    apron: int
    width: int
    rows: int
    strips: int
    chunks: int
    smem: int


def march_levels(depth: int) -> int:
    """Levels a stage for a launch of ``depth`` substeps: 1 for one, else
    4 (the most a warp holds in registers without spilling; the stage's
    last levels idle where ``depth`` is not a multiple of 4). Four a stage
    read faster than two on the H100 at the paths' depths 8 and 16
    (PERF.md, rows 8 and 10b)."""
    return 1 if depth == 1 else 4


def march_depth(levels: int = 4) -> int:
    """The most substeps one launch runs at ``levels`` levels a stage;
    a deeper pass is chained."""
    return MARCH_WARPS * levels


#: The march's time model, fitted to the H100's chunk sweeps of the paths'
#: shapes (PERF.md, rows 8 and 10b): warps an SM must hold to issue every
#: cycle (its 4 schedulers with 3 warps each); the tail of a grid of more
#: than one wave of resident blocks, in marches of one block (such blocks
#: start and end staggered, and the last ones end with their SM part
#: idle); and the time of a row read or written, in level rows (an SM's
#: share of the memory rate).
MARCH_SAT_WARPS, MARCH_TAIL, MARCH_ROW_IO = 12, 1.5, 0.5


def march_cost(nb: int, out_h: int, strips: int, depth: int, levels: int, rows: int,
               n_sm: int, per_sm: int) -> float:
    """The march's time model, in level rows of one warp. A grid of at most
    one wave of resident blocks (``per_sm`` an SM) runs the blocks of its
    fullest SM at once; a larger grid streams through the SMs, each taking
    an even share, and ends in a tail. An SM's time is the longest of its
    blocks' work (a level of a block computes its chunk's rows plus the
    apron rows it still needs) over its 4 schedulers at an issue rate that
    grows with the warps resident (full at ``MARCH_SAT_WARPS``), the rows
    its blocks read (the chunk and its apron rows) and write, and the
    march of one block (a step costs a stage's levels)."""
    warps = -(-depth // levels)
    blocks = nb * strips * -(-out_h // rows)
    stream = blocks > n_sm * per_sm
    per = blocks / n_sm if stream else -(-blocks // n_sm)
    issue = 4 * min(1.0, min(per, per_sm) * warps / MARCH_SAT_WARPS)
    path = (rows + 2 * depth + warps - 1) * levels
    cost = max(per * depth * (rows + depth) / issue,
               blocks / n_sm * 2 * (rows + depth) * MARCH_ROW_IO, path)
    return cost + MARCH_TAIL * path if stream else cost


def march_chunks(out_h: int) -> list[int]:
    """The chunk heights that cut ``out_h`` rows into even chunks (all but
    the last of one height, the last at most as tall), tallest first, each
    the shortest height of its number of chunks."""
    return sorted({-(-out_h // c) for c in range(1, out_h + 1)}, reverse=True)


@functools.lru_cache(maxsize=None)
def march_plan(nb: int, out_h: int, out_w: int, depth: int, n_sm: int, per_sm: int,
               levels: int | None = None, width: int | None = None,
               rows: int | None = None) -> MarchPlan:
    """The host rule of the row march: ``depth`` substeps writing ``nb``
    grids of ``out_h`` x ``out_w`` on ``n_sm`` SMs that hold ``per_sm``
    blocks each. The strip is the widest the window leaves (unless
    ``width`` is given), the levels a stage :func:`march_levels`' (unless
    ``levels`` is), and the chunk of :func:`march_chunks` that
    :func:`march_cost` finds cheapest, the taller on a tie (unless ``rows``
    is given); at most 65,535 chunks, the grid's limit."""
    levels = march_levels(depth) if levels is None else levels
    if levels not in MARCH_LEVELS:
        raise ValueError(f"the march holds 1 or 4 levels a stage, got {levels}")
    if not 1 <= depth <= march_depth(levels):
        raise ValueError(f"a launch of {levels} levels a stage runs 1 to "
                         f"{march_depth(levels)} substeps, got {depth}")
    apron = -(-depth // 4) * 4
    most = MARCH_WIN - 2 * apron
    width = most if width is None else width
    if not (4 <= width <= most and width % 4 == 0):
        raise ValueError(f"strip width {width}: want a multiple of 4 in [4, {most}]")
    strips = -(-out_w // width)
    low = -(-out_h // 65535)
    if rows is None:
        rows = min((c for c in march_chunks(out_h) if c >= low),
                   key=lambda c: march_cost(nb, out_h, strips, depth, levels, c, n_sm, per_sm))
    if not low <= rows <= max(out_h, low):
        raise ValueError(f"chunk of {rows} rows: want [{low}, {out_h}]")
    warps = -(-depth // levels)
    return MarchPlan(depth, levels, warps, apron, width, rows, strips, -(-out_h // rows),
                     march_smem(warps))


def march_chain(nb: int, H: int, W: int, depth: int, n_sm: int, per_sm_of) -> list[MarchPlan]:
    """The launches of a row march of ``depth`` substeps over ``nb`` (H, W)
    grids (the streamed 2D pass, the deep trapezoid): one of at most
    ``march_depth()`` substeps each, every launch but the last writing the
    dense grid its successor reads, ``depth - done - j`` rings beyond the
    (H, W) grid. ``per_sm_of(levels, warps)`` gives the blocks an SM holds
    of a launch's instantiation."""
    plans, done = [], 0
    while done < depth:
        j = min(depth - done, march_depth())
        go = depth - done - j
        levels = march_levels(j)
        plans.append(march_plan(nb, H + 2 * go, W + 2 * go, j, n_sm,
                                per_sm_of(levels, -(-j // levels))))
        done += j
    return plans


def march_smem(warps: int) -> int:
    """Shared memory of a block of ``warps`` stages (``march::smem_bytes``):
    the column table, the input ring, a hand-over ring a boundary and the
    two output rows."""
    return (MARCH_WIN + (MARCH_RING + MARCH_HAND * (warps - 1) + 2) * MARCH_WIN) * 4


#: The folded ring of ``csrc/stencil_taps.cuh`` (namespace ``ring``:
#: ``dma_ring_kernel``, ``resident_periodic_kernel``): warps a block
#: (``WARPS``), the deepest fold and a strip window's side apron (``F``),
#: the window's columns (``WIN``) and the output columns of a strip
#: (``OUT``)
RING_WARPS, RING_F, RING_WIN = 4, 4, 128
RING_OUT = RING_WIN - 2 * RING_F
#: blocks of a ring kernel an H100 SM holds with 16-byte rows: its launch
#: bounds' 3 (2 with scalar loads)
RING_PER_SM = 3


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """One launch of a ring kernel: ``fold`` steps between grid barriers
    in ``rounds`` rounds, on ``blocks`` persistent blocks."""

    fold: int
    rounds: int
    blocks: int


def ring_rows(R: int, C: int, H: int, W: int) -> int:
    """The strip rows a ring kernel's warps share: the torus's (R*H) rows
    in each of its ceil(C*W / RING_OUT) column strips."""
    return -(-(C * W) // RING_OUT) * R * H


def ring_plan(R: int, C: int, H: int, W: int, steps: int, n_sm: int,
              per_sm: int = RING_PER_SM, fold: int | None = None) -> RingPlan:
    """The ring kernels' host rule over the torus of ``R`` x ``C`` ranks'
    ``H`` x ``W`` cores (1 x 1 for one grid): ``fold`` steps a round (the
    deepest, RING_F, unless given) on as many blocks as ``n_sm`` SMs hold
    at ``per_sm`` each (one cooperative wave), and never more warps than
    strip rows, so that every warp has one (a block at least)."""
    fold = min(RING_F, steps) if fold is None else fold
    if not 1 <= fold <= RING_F:
        raise ValueError(f"a ring kernel folds 1 to {RING_F} steps a round, got {fold}")
    most = max(1, ring_rows(R, C, H, W) // RING_WARPS)
    return RingPlan(fold, -(-steps // fold), min(n_sm * per_sm, most))


def ring_vec(W: int, *data_ptrs: int) -> int:
    """A ring kernel's load width: 4 columns as one 16-byte vector where
    every row starts 16-byte aligned (``W % 4 == 0`` and the buffers
    16-byte aligned), else 4 scalar loads."""
    return 4 if W % 4 == 0 and all(p % 16 == 0 for p in data_ptrs) else 1


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The SMs of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def tap_mask(c9) -> int:
    """The 9-bit mask of the nonzero coefficients (by tap position)."""
    return sum(1 << p for p, v in enumerate(c9) if v != 0.0)


def march_mask(c9) -> int:
    """The template mask a launch takes: its tap set where that has an
    instantiation (``MARCH_MASKS``), else 0 (a runtime mask)."""
    m = tap_mask(c9)
    return m if m in MARCH_MASKS else 0


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
