"""Dot-product reduction kernels (``csrc/reduction.cu``) and their wrappers.

The twin of ``tpuscratch.ops.reduction``: the reference's CUDA strategies
(mpicuda2.cu:84-100 two-phase partials, mpicuda4.cu:157-185 single-kernel
full reduction), f32 accumulation for float32 and bfloat16 operands.

- ``dot_partials_prepped``: one launch: the partials one a chunk (the
  TPU kernel's output, summed outside its kernel by the JAX package), and
  the block that draws the last atomic ticket sums them in a fixed order.
  A block a chunk, its size a host rule, ``dot_partials_threads``.
- ``dot_full_prepped``: one launch, one scalar: per-block partials, an
  atomic ticket, and the last block sums the partials in a fixed order.
  Its grid is a host rule, ``dot_full_plan``.

Neither uses float atomics, so the same inputs give the same bits every
run.

Every function takes a batch: ``x``, ``y`` are ``(*batch, n)`` (or, prepped,
``(*batch, k*block, 128)``) and the result is ``(*batch)`` -- the stacked
ranks of a mesh in one launch. ``offset`` is None, a number, or a float32
tensor of one value or of one value per batch entry; the kernels read it
through a device pointer, so a loop-carried offset costs no host sync.

The kernels take the operands as flat vectors: ``dot_full`` and
``dot_partials`` pass them unpadded (the TPU's 8x128 padding adds only
zeros), and ``prep`` keeps the JAX package's ``(k*block, 128)`` contract
for callers that iterate. On a CPU tensor every function runs the plain
versions (``dot_partials_plain``, ``dot_full_plain``). Each kernel
wrapper counts its launches in ``launches``; ``dot_full`` and
``dot_partials`` launch the same kernels and count there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.ops.common import (
    LANES, check_cuda, check_status, counters, library, route, stream_of, to_lanes,
)

DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take
_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("reduction")
    lib.ts_dot_partials.argtypes = [_P, _P, _I, _I, _I, _P, _I, _L, _L, _L, _I, _P, _P, _P, _I,
                                    _P]
    lib.ts_dot_full_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.ts_dot_partials_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                                              _I]
    lib.ts_dot_full.argtypes = [_P, _P, _I, _I, _I, _P, _I, _L, _L, _I, _P, _P, _P, _P]
    for fn in (lib.ts_dot_partials, lib.ts_dot_full_occupancy, lib.ts_dot_partials_occupancy,
               lib.ts_dot_full):
        fn.restype = _I
    return lib


# ---------------------------------------------------------------------------
# offsets and plain versions


def _offset_plain(offset, batch: torch.Size, device) -> torch.Tensor | float:
    """The offset broadcastable against ``(*batch, n)``."""
    if offset is None:
        return 0.0
    if not isinstance(offset, torch.Tensor):
        return float(torch.tensor(offset, dtype=torch.float32))
    o = offset.to(device=device, dtype=torch.float32)
    if o.numel() == 1:
        return o.reshape(())
    if o.shape != batch:
        raise ValueError(f"offset {tuple(o.shape)} is neither one value nor the batch {tuple(batch)}")
    return o[..., None]


def dot_partials_plain(x: torch.Tensor, y: torch.Tensor, chunk: int, offset=None) -> torch.Tensor:
    """Per-chunk partials of sum((x + o) * y), ``(*batch, ceil(n/chunk))``."""
    p = (x.float() + _offset_plain(offset, x.shape[:-1], x.device)) * y.float()
    n = x.shape[-1]
    k = -(-n // chunk)
    if k * chunk != n:
        p = torch.nn.functional.pad(p, (0, k * chunk - n))
    return p.reshape(*p.shape[:-1], k, chunk).sum(-1)


def dot_full_plain(x: torch.Tensor, y: torch.Tensor, offset=None) -> torch.Tensor:
    """sum((x + o) * y) over the last dim, ``(*batch)``."""
    return ((x.float() + _offset_plain(offset, x.shape[:-1], x.device)) * y.float()).sum(-1)


# ---------------------------------------------------------------------------
# kernel launches


def _operands(x: torch.Tensor, y: torch.Tensor, name: str):
    check_cuda(x, name, 1, DTYPES)
    check_cuda(y, name, 1, DTYPES)
    if y.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, y on {y.device}")
    batch = math.prod(x.shape[:-1])
    if batch > 65535:
        raise ValueError(f"{name}: at most 65535 batch entries, got {batch}")
    return batch, x.shape[-1]


def _offset_arg(offset, x: torch.Tensor, name: str) -> tuple[int | None, int, object]:
    """(device pointer or None, stride, tensor to keep alive)."""
    if offset is None:
        return None, 0, None
    if not isinstance(offset, torch.Tensor):
        o = torch.tensor([float(offset)], dtype=torch.float32, device=x.device)
    else:
        if offset.device != x.device:
            raise ValueError(f"{name}: offset on {offset.device}, operands on {x.device}")
        o = offset.to(torch.float32).contiguous()
    if o.numel() == 1:
        return o.data_ptr(), 0, o
    if o.shape != x.shape[:-1]:
        raise ValueError(f"{name}: offset {tuple(o.shape)} is neither one value "
                         f"nor the batch {tuple(x.shape[:-1])}")
    return o.data_ptr(), 1, o


def _vec(x: torch.Tensor, y: torch.Tensor, n: int, chunk: int = 8) -> int:
    """8-element (16-byte) loads where pointers and lengths allow them."""
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    return 8 if aligned and n % 8 == 0 and chunk % 8 == 0 else 1


DOT_THREADS = 256  # threads a block (csrc/reduction.cu: THREADS)
DOT_UNROLL = 2     # 16-byte groups of each operand a thread keeps in flight (UNROLL)


def dot_full_plan(n: int, batch: int, vec: int, n_sm: int, per_sm: int) -> int:
    """Blocks a batch entry of ``dot_full``'s grid: one resident wave
    (``per_sm`` blocks on each of ``n_sm`` SMs) shared out over the batch,
    no more than the work fills (DOT_UNROLL groups of ``vec`` elements a
    thread), at least 1."""
    need = -(-n // (DOT_THREADS * vec * DOT_UNROLL))
    return max(1, min(n_sm * max(1, per_sm) // batch, need))


PARTIALS_WIDE = 512  # dot_partials' block where a chunk fills it (csrc/reduction.cu)


def dot_partials_threads(chunk: int, vec: int) -> int:
    """Threads of a ``dot_partials`` block (a block a chunk): PARTIALS_WIDE
    where the chunk gives each of them a full step (DOT_UNROLL groups of
    ``vec`` elements), else DOT_THREADS."""
    return PARTIALS_WIDE if chunk >= PARTIALS_WIDE * vec * DOT_UNROLL else DOT_THREADS


def partials_schedule(nchunks: int, blocks: int) -> list[range]:
    """The chunks each of ``blocks`` blocks of a batch entry sums, in its
    order (``dot_partials_kernel``'s loop ``c = blockIdx.x + k*G``; the
    rule's grid is a block a chunk)."""
    return [range(g, nchunks, blocks) for g in range(blocks)]


def tail_order(nparts: int, threads: int = DOT_THREADS) -> list[range]:
    """The partials each thread of the last block sums, in its order,
    before ``block_sum``'s fixed tree (``sum_partials``)."""
    return [range(t, nparts, threads) for t in range(threads)]


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, kernel: str, dx: int, dy: int, vec: int,
               threads: int = DOT_THREADS) -> tuple[int, int]:
    """(SM count, blocks of dot_``kernel`` an SM holds) on card ``device_index``."""
    sms, per_sm = _I(0), _I(0)
    lib = _lib()
    with torch.cuda.device(device_index):
        if kernel == "full":
            err = lib.ts_dot_full_occupancy(dx, dy, vec, ctypes.byref(sms), ctypes.byref(per_sm))
        else:
            err = lib.ts_dot_partials_occupancy(dx, dy, vec, ctypes.byref(sms),
                                                ctypes.byref(per_sm), threads)
        check_status(lib, err, f"dot_{kernel}")
    return sms.value, per_sm.value


_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tickets_for(device: torch.device, stream: int, batch: int) -> torch.Tensor:
    """The ticket counters of one stream of one device: zero between
    launches (the last block of each launch wraps its counter back to 0).
    dot_full and dot_partials share them: launches on one stream never
    overlap."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < batch:
        t = torch.zeros(max(batch, 64), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = t
    return t


def _partials_dot(x, y, chunk: int, offset, name: str, blocks: int | None = None,
                  threads: int | None = None):
    """One dot_partials launch: ``(sums (*batch), partials (*batch,
    nchunks))``; a block a chunk of ``dot_partials_threads`` threads unless
    ``blocks`` or ``threads`` are given (other grids, as
    ``bench/kernel_ab.py --sweep`` times them)."""
    batch, n = _operands(x, y, name)
    nchunks = -(-n // chunk)
    partials = torch.empty(x.shape[:-1] + (nchunks,), dtype=torch.float32, device=x.device)
    if nchunks == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device), partials
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    vec = _vec(x, y, n, chunk)
    dx, dy = _CODE[x.dtype], _CODE[y.dtype]
    blocks = blocks or nchunks
    threads = threads or dot_partials_threads(chunk, vec)
    off, stride, keep = _offset_arg(offset, x, name)
    stream = stream_of(x)
    tickets = _tickets_for(x.device, stream.value, batch)
    with torch.cuda.device(x.device):
        check_status(_lib(), _lib().ts_dot_partials(
            x.data_ptr(), y.data_ptr(), dx, dy, vec, off, stride, n, chunk, batch, blocks,
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), threads, stream), name)
    del keep  # the launch is queued; the caching allocator orders any reuse
    dot_partials_prepped.launches += 1
    return out, partials


def _partials_launch(x, y, chunk: int, offset, name: str) -> torch.Tensor:
    """The per-chunk partials of one dot_partials launch, ``(*batch, nchunks)``."""
    return _partials_dot(x, y, chunk, offset, name)[1]


def _full_launch(x, y, offset, name: str, blocks: int | None = None) -> torch.Tensor:
    """One dot_full launch; ``blocks`` is ``dot_full_plan``'s unless given
    (another grid, as ``bench/kernel_ab.py --sweep`` times them)."""
    batch, n = _operands(x, y, name)
    vec = _vec(x, y, n)
    dx, dy = _CODE[x.dtype], _CODE[y.dtype]
    if blocks is None:
        blocks = dot_full_plan(n, batch, vec, *_occupancy(x.device.index, "full", dx, dy, vec))
    scratch = torch.empty(batch * blocks, dtype=torch.float32, device=x.device)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    off, stride, keep = _offset_arg(offset, x, name)
    stream = stream_of(x)
    tickets = _tickets_for(x.device, stream.value, batch)
    with torch.cuda.device(x.device):
        check_status(_lib(), _lib().ts_dot_full(
            x.data_ptr(), y.data_ptr(), dx, dy, vec, off, stride, n, batch, blocks,
            scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream), name)
    del keep
    dot_full_prepped.launches += 1
    return out


# ---------------------------------------------------------------------------
# the JAX package's functions


def _blocked(x: torch.Tensor, y: torch.Tensor, block_rows: int):
    """Block two (batches of) vectors as the JAX package does: pad to the
    8x128 tile quantum, clamp the block to the data, pad the rows to a
    whole number of blocks."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    x2, y2 = to_lanes(x), to_lanes(y)
    rows = x2.shape[-2]
    block = min(block_rows, rows)
    grid = (rows + block - 1) // block
    pad_rows = grid * block - rows
    if pad_rows:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, pad_rows))
        y2 = torch.nn.functional.pad(y2, (0, 0, 0, pad_rows))
    return x2, y2, grid, block


def prep(x: torch.Tensor, y: torch.Tensor, block_rows: int = 512):
    """Block two vectors once for repeated prepped-kernel calls:
    ``(x2, y2, grid, block)`` with x2, y2 ``(*batch, grid*block, 128)``."""
    return _blocked(x, y, block_rows)


def _check_prepped(x2: torch.Tensor, y2: torch.Tensor, block: int) -> None:
    if x2.shape != y2.shape:
        raise ValueError(f"prepped shape mismatch {tuple(x2.shape)} vs {tuple(y2.shape)}")
    if x2.ndim < 2 or x2.shape[-1] != LANES or x2.shape[-2] % block:
        raise ValueError(
            f"prepped operands must be (k*{block}, {LANES}), got {tuple(x2.shape)} "
            "-- use prep() with the same block_rows"
        )


def _chunk(n: int, block_rows: int) -> int:
    """The elements of one JAX grid step for an n-vector: block rows of 128."""
    rows = -(-n // (LANES * 8)) * 8
    return max(1, min(block_rows, rows)) * LANES


def dot_partials_prepped(x2: torch.Tensor, y2: torch.Tensor, block: int, offset=None) -> torch.Tensor:
    _check_prepped(x2, y2, block)
    x, y = x2.flatten(-2), y2.flatten(-2)
    if route(x2, "dot_partials_prepped"):
        return _partials_dot(x, y, block * LANES, offset, "dot_partials_prepped")[0]
    return dot_partials_plain(x, y, block * LANES, offset).sum(-1)


def dot_full_prepped(x2: torch.Tensor, y2: torch.Tensor, block: int, offset=None) -> torch.Tensor:
    _check_prepped(x2, y2, block)
    x, y = x2.flatten(-2), y2.flatten(-2)
    if route(x2, "dot_full_prepped"):
        return _full_launch(x, y, offset, "dot_full_prepped")
    return dot_full_plain(x, y, offset)


def dot_partials(x: torch.Tensor, y: torch.Tensor, block_rows: int = 512, offset=None) -> torch.Tensor:
    """Two-phase reduction: per-chunk partials, then one sum (parity:
    partial_dot_product_kernel + the host accumulate, mpicuda2.cu:277-279,
    the finish on the device, in the same launch)."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    chunk = _chunk(x.shape[-1], block_rows)
    if route(x, "dot_partials"):
        return _partials_dot(x, y, chunk, offset, "dot_partials")[0]
    return dot_partials_plain(x, y, chunk, offset).sum(-1)


def dot_full(x: torch.Tensor, y: torch.Tensor, block_rows: int = 512, offset=None) -> torch.Tensor:
    """Single-kernel full reduction (dot_product_full_kernel parity,
    mpicuda4.cu:157-185). ``block_rows`` is the TPU kernel's block,
    accepted for its signature; the CUDA grid is sized by the SM count."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    if route(x, "dot_full"):
        return _full_launch(x, y, offset, "dot_full")
    return dot_full_plain(x, y, offset)


def dot_prepped(x2, y2, block: int, method: str = "full", offset=None) -> torch.Tensor:
    """Strategy dispatch over pre-blocked operands (see ``prep``): the one
    method-string table, shared with iterating callers like dot_bench."""
    if method == "full":
        return dot_full_prepped(x2, y2, block, offset=offset)
    if method == "partials":
        return dot_partials_prepped(x2, y2, block, offset=offset)
    raise ValueError(f"unknown prepped dot method {method!r}")


def _xla_dot(x: torch.Tensor, y: torch.Tensor, offset) -> torch.Tensor:
    """The JAX package's non-kernel path: one library dot in float32."""
    xf, yf = x.float(), y.float()
    if offset is not None:
        xf = xf + _offset_plain(offset, x.shape[:-1], x.device)
    if x.ndim == 1:
        return torch.dot(xf, yf)
    return torch.matmul(xf.unsqueeze(-2), yf.unsqueeze(-1))[..., 0, 0]


def dot(x: torch.Tensor, y: torch.Tensor, method: str = "full", block_rows: int = 512, offset=None) -> torch.Tensor:
    """Dot product with strategy selection (REDUCE_GPU/REDUCE_CPU parity,
    mpicuda4.cu:347-355): 'full' (single kernel), 'partials' (two-phase),
    'xla' (the library dot, the CPU-oracle analogue)."""
    if method == "full":
        return dot_full(x, y, block_rows, offset=offset)
    if method == "partials":
        return dot_partials(x, y, block_rows, offset=offset)
    if method == "xla":
        if x.shape != y.shape:
            raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        return _xla_dot(x, y, offset)
    raise ValueError(f"unknown dot method {method!r}")


def local_dot_psum(x_shard, y_shard, axis, method: str = "full", block_rows: int = 512, offset=None):
    """SPMD body: every rank's shard reduced in one batched launch, then one
    ``allreduce_sum`` over ``axis`` (MPI_Reduce at mpicuda2.cu:293 -> psum).
    Call inside ``run_spmd``."""
    return allreduce_sum(dot(x_shard, y_shard, method, block_rows, offset=offset), axis)


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (dot_partials_prepped, dot_full_prepped)
reset_launches, launch_counts = counters(WRAPPERS)
