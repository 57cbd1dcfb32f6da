"""ctypes binding for the native pooled host-staging allocator
(native/src/host_pool.cpp) — the twin of ``tpuscratch.native.hostpool``,
the counterpart of the reference's pinned ``host_allocator<T>``
(host_allocator.h:58-93).

Page-aligned, size-class-pooled host buffers with optional mlock(2)
page-locking. Used by the pingpong staging ablation
(``bench.pingpong.native_pool_staging_roundtrip``, the role host_allocator
plays in mpi-pingpong-gpu-async.cpp:43-49) and by the async checkpointer's
staging (``runtime.async_ckpt.AsyncCheckpointer(pool=...)``).

``HostBuffer.view()`` exposes the buffer as a zero-copy numpy array and
``HostBuffer.tensor()`` as a CPU tensor over the same bytes
(``torch.from_numpy``), so staging is ``buf.tensor(...).copy_(x)`` in and
``.to(device)`` out. mlock keeps the pages resident; it does not make
them page-locked for the card's copy engines, which only
``cudaHostRegister`` does (``register_with_card``).
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Optional

import numpy as np

import torch

from tpuscratch_torch import native

_STATS_FIELDS = (
    "bytes_in_use",
    "bytes_cached",
    "high_water",
    "alloc_calls",
    "reuse_hits",
    "locked_bytes",
    "lock_failures",
    "page_class",
)

_configured = False


def _check_cudart(err, what: str) -> None:
    code = int(err)
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def _lib():
    lib = native.load()
    global _configured
    if not _configured:
        u64 = ctypes.c_uint64
        vp = ctypes.c_void_p
        lib.ts_pool_create.restype = vp
        lib.ts_pool_create.argtypes = [ctypes.c_int32]
        lib.ts_pool_alloc.restype = vp
        lib.ts_pool_alloc.argtypes = [vp, u64]
        lib.ts_pool_free.restype = None
        lib.ts_pool_free.argtypes = [vp, vp]
        lib.ts_pool_trim.restype = None
        lib.ts_pool_trim.argtypes = [vp]
        lib.ts_pool_stats.restype = None
        lib.ts_pool_stats.argtypes = [vp, ctypes.POINTER(u64)]
        lib.ts_pool_destroy.restype = None
        lib.ts_pool_destroy.argtypes = [vp]
        _configured = True
    return lib


class HostBuffer:
    """One pooled buffer. Returns to the pool on ``free()``/``with`` exit;
    views become invalid afterwards (the buffer may be reused)."""

    def __init__(self, pool: "HostPool", ptr: int, nbytes: int):
        self._pool = pool
        self._ptr: Optional[int] = ptr
        self.nbytes = nbytes
        self._views: list[weakref.ref] = []
        self._registered = False

    @property
    def ptr(self) -> int:
        if self._ptr is None:
            raise ValueError("buffer already returned to the pool")
        return self._ptr

    def view(self, dtype=np.uint8, shape: Optional[tuple] = None) -> np.ndarray:
        """Zero-copy numpy view of (a prefix of) the buffer.

        Views are tracked (by weakref): ``free()`` refuses to return the
        buffer to the pool while any view is still alive, because writes
        through a stale view would silently corrupt whichever allocation
        reuses the memory."""
        dtype = np.dtype(dtype)
        if shape is None:
            shape = (self.nbytes // dtype.itemsize,)
        need = int(np.prod(shape)) * dtype.itemsize
        if need > self.nbytes:
            raise ValueError(f"view of {need} B exceeds buffer {self.nbytes} B")
        raw = (ctypes.c_byte * need).from_address(self.ptr)
        # anchor the buffer (and through its pool reference, the pool) on
        # the ctypes block at the view's base: a live view must keep the
        # pool's finalizer from destroying the pages under it, even when
        # the caller dropped every other reference
        raw._tpuscratch_buffer = self
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        self._views.append(weakref.ref(arr))
        return arr

    def tensor(self, dtype: torch.dtype = torch.uint8, shape: Optional[tuple] = None) -> torch.Tensor:
        """Zero-copy CPU tensor over (a prefix of) the buffer: a tracked
        ``view`` behind ``torch.from_numpy``, so ``free()`` refuses while
        the tensor lives."""
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return torch.from_numpy(self.view(np_dtype, shape))

    def register_with_card(self) -> None:
        """Page-lock the buffer for the card (``cudaHostRegister``), so a
        copy between it and the card runs asynchronously on the copy
        engines; ``unregister_from_card`` undoes it, before ``free``."""
        _check_cudart(torch.cuda.cudart().cudaHostRegister(self.ptr, self.nbytes, 0),
                      "cudaHostRegister")
        self._registered = True

    def unregister_from_card(self) -> None:
        if self._registered:
            _check_cudart(torch.cuda.cudart().cudaHostUnregister(self.ptr), "cudaHostUnregister")
            self._registered = False

    def live_views(self) -> int:
        """Number of still-referenced views of this buffer."""
        self._views = [r for r in self._views if r() is not None]
        return len(self._views)

    def free(self) -> None:
        if self._ptr is not None:
            if self.live_views():
                # dead-but-uncollected reference cycles hold views alive
                # until gc clears them
                import gc

                gc.collect()
            if self.live_views():
                raise ValueError(
                    f"freeing buffer with {self.live_views()} live view(s); "
                    "drop the numpy references first"
                )
            self.unregister_from_card()
            self._pool._free(self._ptr)
            self._ptr = None

    def __enter__(self) -> "HostBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.free()


class HostPool:
    """Pooled page-aligned (optionally page-locked) host buffers.

    ``retry`` (an ``ft.RetryPolicy``) makes :meth:`alloc` absorb
    transient exhaustion: a failed allocation trims the pool's cached
    free lists back to the OS and retries under the policy's backoff —
    the RLIMIT_MEMLOCK budget is shared process-wide, so another pool
    releasing between attempts is a real recovery path.  ``None`` (the
    default) keeps the fail-fast contract."""

    def __init__(self, lock_pages: bool = True, retry=None):
        lib = _lib()
        self._retry = retry
        # lifecycle counters cross threads under async checkpointing
        # (alloc on the step loop, free on the background writer):
        # += / -= are non-atomic read-modify-writes, so lock them
        self._stats_lock = threading.Lock()
        self._live = 0        # buffers handed out and not yet freed
        self._live_hw = 0     # high-water of live buffers
        self._trims = 0       # trim() calls (retry pressure + manual)
        self._spill_bytes = 0     # D2H traffic noted by paging tiers
        self._prefetch_bytes = 0  # H2D traffic noted by paging tiers
        self._handle = lib.ts_pool_create(1 if lock_pages else 0)
        if not self._handle:
            raise MemoryError("ts_pool_create failed")
        # reclaim abandoned pools (buffers + mlock'd pages) even without
        # close(): RLIMIT_MEMLOCK is tiny in containers, so leaked locked
        # pages starve later pools
        self._finalizer = weakref.finalize(
            self, lib.ts_pool_destroy, self._handle
        )

    def alloc(self, nbytes: int) -> HostBuffer:
        if nbytes <= 0:
            raise ValueError(f"alloc of {nbytes} bytes")
        ptr = _lib().ts_pool_alloc(self._handle, nbytes)
        if not ptr and self._retry is not None:
            from tpuscratch_torch.ft.retry import retry as _ft_retry

            def attempt() -> int:
                self.trim()  # cached free lists back to the OS first
                p = _lib().ts_pool_alloc(self._handle, nbytes)
                if not p:
                    raise MemoryError(
                        f"host pool exhausted allocating {nbytes} B"
                    )
                return p

            ptr = _ft_retry(attempt, self._retry, op="hostpool.alloc")
        if not ptr:
            raise MemoryError(f"host pool exhausted allocating {nbytes} B")
        with self._stats_lock:
            self._live += 1
            self._live_hw = max(self._live_hw, self._live)
        return HostBuffer(self, ptr, nbytes)

    def alloc_pages(self, n_pages: int, page_nbytes: int) -> HostBuffer:
        """One buffer covering ``n_pages`` page-shaped records of
        ``page_nbytes`` each — the KV paging tier's spill-batch shape
        (serve/kvcache.HostPageStore): a spill of k cold pages costs ONE
        pool allocation, not k, so the size-class free lists see a few
        large batch buffers instead of thousands of page-sized ones."""
        if n_pages < 1:
            raise ValueError(f"alloc_pages of {n_pages} pages")
        return self.alloc(n_pages * page_nbytes)

    def note_spill(self, nbytes: int) -> None:
        """Record device→host paging traffic (lock-guarded: spill runs
        on the engine loop, concurrent pools/threads may share this)."""
        with self._stats_lock:
            self._spill_bytes += int(nbytes)

    def note_prefetch(self, nbytes: int) -> None:
        """Record host→device paging traffic (see :meth:`note_spill`)."""
        with self._stats_lock:
            self._prefetch_bytes += int(nbytes)

    def _free(self, ptr: int) -> None:
        if self._handle:
            _lib().ts_pool_free(self._handle, ptr)
            with self._stats_lock:
                self._live -= 1

    def trim(self) -> None:
        """Release cached (free-listed) buffers back to the OS."""
        _lib().ts_pool_trim(self._handle)
        with self._stats_lock:
            self._trims += 1

    def stats(self) -> dict:
        """Native pool counters plus the Python-side lifecycle view
        (``live_buffers``: handed-out and unfreed, ``trim_calls``) — the
        snapshot ``obs`` surfaces so a staging path's host-buffer
        footprint is observable rather than silent."""
        out = (ctypes.c_uint64 * len(_STATS_FIELDS))()
        _lib().ts_pool_stats(self._handle, out)
        stats = dict(zip(_STATS_FIELDS, (int(v) for v in out)))
        with self._stats_lock:
            stats["live_buffers"] = self._live
            stats["live_buffers_hw"] = self._live_hw
            stats["trim_calls"] = self._trims
            stats["spill_bytes"] = self._spill_bytes
            stats["prefetch_bytes"] = self._prefetch_bytes
        return stats

    def close(self) -> None:
        if self._handle:
            self._finalizer()  # runs ts_pool_destroy once, then detaches
            self._handle = None

    def __enter__(self) -> "HostPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_default: Optional[HostPool] = None


def default_pool() -> HostPool:
    """Process-wide pool (page-locking on, falling back silently where
    RLIMIT_MEMLOCK forbids — see ``stats()['lock_failures']``)."""
    global _default
    if _default is None or _default._handle is None:
        _default = HostPool(lock_pages=True)
    return _default
