"""Asynchronous checkpointing: device-to-pinned-host snapshot, background
publish.

The twin of ``tpuscratch.runtime.async_ckpt``. The blocking save path
(``runtime.checkpoint.save`` called inline by the trainer, the halo
driver and the solver runner) holds the step loop for the full
copy+serialize+publish wall. This module splits it in two:

- **snapshot** (cheap for the host): an event is recorded on the
  compute stream, and a side stream waits on it and copies every CUDA
  leaf into pinned host memory (``non_blocking``; PyTorch's caching host
  allocator pools those buffers across snapshots; with ``pool=``, a
  native ``HostPool``'s buffers, registered with the card
  (``cudaHostRegister``) so the copy stays asynchronous, and kept, size by
  size, for the next snapshot until ``close``, which unregisters them and
  returns them to the pool: like a pinned allocation, a registration
  waits for the device, so only a run's first snapshot pays it). The compute stream
  then waits on the copy's own event, so the next chunk's kernels, in
  place or not, and any reuse of a freed source's memory, cannot write
  the snapshotted storage before the copy has read it. That wait puts
  the copy's device time in front of the next chunk: the writer reports
  it, timed between the two events, as ``copy_device_s``. CPU leaves
  are copied at once.
- **write** (background): one daemon thread waits for the copy's event,
  then serializes the host snapshot through the unchanged
  crash-consistent aside-rename protocol of ``runtime.checkpoint.save``
  (so published checkpoints are byte-identical to the blocking path's),
  under ``ft.retry`` with the per-attempt stall watchdog, then prunes.

Concurrency contract: **at most one write in flight**. ``snapshot``
drains the previous write before staging the next; the chunk runtimes
drain at preemption points and at exit, so a ``Preempted`` run hands its
successor a fully-published directory. A writer failure (post-retry) is
re-raised at the next barrier.

Telemetry: the runtimes emit the blocking half as ``ckpt/snapshot``; the
writer emits ``ckpt/write`` (with ``copy_device_s``) from its own
thread at completion. Chaos
sites: ``ckpt/snapshot`` (before the copy) and ``ckpt/write`` (the named
stages inside the background save).
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpuscratch_torch.ft.retry import RetryPolicy, retry
from tpuscratch_torch.runtime import checkpoint

__all__ = ["DEFAULT_WRITE_RETRY", "AsyncCheckpointer"]

#: the background writer's policy: absorb transient IO faults fast (the
#: DEFAULT_SAVE_RETRY curve) and abandon a stalled attempt via the
#: thread watchdog — a hung filesystem must surface at the next barrier
#: as a retryable failure, never wedge the drain
DEFAULT_WRITE_RETRY = RetryPolicy(max_attempts=3, base_s=0.01, max_s=0.1,
                                  attempt_timeout_s=60.0)


class AsyncCheckpointer:
    """Snapshot-then-publish checkpointing with one background writer.

    ``pool``: a ``native.hostpool.HostPool`` for the staging buffers
    (default: PyTorch's pinned caching allocator), held until ``close``;
    a leaf the pool cannot serve (zero bytes, or the pool exhausted) takes
    a pinned buffer.
    ``retry``: the writer's ``ft.RetryPolicy`` (default
    :data:`DEFAULT_WRITE_RETRY`).  ``chaos``: an ``ft.ChaosPlan`` —
    plugs the ``ckpt/snapshot`` / ``ckpt/write`` injection sites in.
    ``sink``: receives one ``ckpt/write`` event per completed
    background write (emitted from the writer thread at its true end
    stamp).  ``metrics``: a ``MetricsRegistry`` — each snapshot sets
    ``ckpt/snapshot_bytes`` (and, with a pool, the ``hostpool/*`` gauges
    from ``HostPool.stats()``), each write counts ``ckpt/async_writes``.
    """

    def __init__(self, *, pool=None, retry: Optional[RetryPolicy] = None,
                 chaos=None, sink=None, metrics=None,
                 log: Callable[[str], None] = lambda s: None):
        self._pool = pool
        self._held: dict = {}    # nbytes -> registered pool buffers free for reuse
        self._retry = retry if retry is not None else DEFAULT_WRITE_RETRY
        self._chaos = chaos
        self._sink = sink
        self._metrics = metrics
        self._log = log
        self._streams: dict = {}  # device -> its copy stream
        # ONE persistent daemon writer + a one-slot handoff
        self._jobs: Optional[queue.SimpleQueue] = None
        self._worker: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._done.set()
        self._error: Optional[BaseException] = None
        self.writes = 0          # completed background writes
        self.snapshot_bytes = 0  # bytes staged by the LAST snapshot

    def _worker_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                job()
            finally:
                self._done.set()

    def _submit(self, job: Callable[[], None]) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._jobs = queue.SimpleQueue()
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True, name="ckpt-writer"
            )
            self._worker.start()
        self._done.clear()
        self._jobs.put(job)

    # ---- the barrier ---------------------------------------------------

    def in_flight(self) -> bool:
        return not self._done.is_set()

    def drain(self) -> None:
        """Block until the in-flight write (if any) finishes; re-raise
        its failure here — the caller's thread is the step loop, whose
        failure surface the supervisor already owns."""
        self._done.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Drain, then retire the worker thread and return the held
        staging buffers to the pool."""
        try:
            self.drain()
        finally:
            if self._worker is not None and self._worker.is_alive():
                self._jobs.put(None)
            self._worker = None
            held, self._held = self._held, {}
            for buf in (b for bufs in held.values() for b in bufs):
                buf.free()

    def abandon(self) -> None:
        """Close, but SWALLOW a write failure (logged) — the exit path
        of a loop already unwinding on a primary exception, which a
        secondary writer error must not mask."""
        try:
            self.close()
        except BaseException as exc:  # noqa: BLE001 — logged, not lost
            self._log(f"ckpt/write failed during unwind: "
                      f"{type(exc).__name__}: {exc}")

    # ---- snapshot + background publish ---------------------------------

    def _host_buffer(self, src: torch.Tensor):
        """(host tensor for ``src``'s copy, its pool buffer or None): a
        pool buffer registered with the card, else a pinned tensor."""
        nbytes = src.numel() * src.element_size()
        if self._pool is not None and nbytes > 0:
            held = self._held.get(nbytes)
            buf = held.pop() if held else None
            if buf is None:
                try:
                    buf = self._pool.alloc(nbytes)
                except MemoryError:
                    buf = None
                if buf is not None:
                    buf.register_with_card()
            if buf is not None:
                return buf.tensor(src.dtype, tuple(src.shape)), buf
        return torch.empty(src.shape, dtype=src.dtype, pin_memory=True), None

    def _stage(self, leaves: list) -> tuple[list, list, list]:
        """Every leaf to host memory. Returns (host tensors or arrays, a
        (ready, done) event pair per device bracketing its copy, the pool
        buffers used)."""
        staged: list = [None] * len(leaves)
        bufs: list = []
        events = []
        by_device: dict = {}
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                by_device.setdefault(leaf.device, []).append(i)
            elif isinstance(leaf, torch.Tensor):
                staged[i] = leaf.detach().clone()
            else:
                staged[i] = np.array(leaf, copy=True)
        for device, idx in by_device.items():
            compute = torch.cuda.current_stream(device)
            side = self._streams.get(device)
            if side is None:
                side = self._streams[device] = torch.cuda.Stream(device)
            ready = torch.cuda.Event(enable_timing=True)
            ready.record(compute)
            with torch.cuda.stream(side):
                side.wait_event(ready)
                for i in idx:
                    src = leaves[i].detach()
                    checkpoint._np_dtype(src.dtype)  # refuse before copying
                    host, buf = self._host_buffer(src)
                    host.copy_(src, non_blocking=True)
                    staged[i] = host
                    if buf is not None:
                        bufs.append(buf)
            done = torch.cuda.Event(enable_timing=True)
            done.record(side)
            # later work on the compute stream (an in-place update of a
            # donated state, a reuse of a freed source's memory) waits for
            # the copy to have read the source
            compute.wait_event(done)
            events.append((ready, done))
        return staged, events, bufs

    def snapshot(self, ckpt_dir, step: int, tree, *,
                 metadata: Optional[dict] = None, tag: str = "state",
                 keep: Optional[int] = None) -> float:
        """Stage ``tree`` to host and hand it to the background writer;
        returns the blocking (staging) seconds.  Drains any previous
        write first — at most one in flight."""
        self.drain()
        if self._chaos is not None:
            self._chaos.maybe_fail("ckpt/snapshot", op="ckpt/snapshot")
        t0 = time.perf_counter()
        leaves, _ = checkpoint.tree_flatten(tree)
        staged, events, bufs = self._stage(leaves)
        self.snapshot_bytes = sum(
            (v.numel() * v.element_size()) if isinstance(v, torch.Tensor) else v.nbytes
            for v in staged)
        blocking_s = time.perf_counter() - t0
        self._observe()
        write_hook = (self._chaos.stage_hook("ckpt/write")
                      if self._chaos is not None else None)
        # the closure holds the ONLY references to the host snapshot; a
        # dict box lets the writer drop them
        skeleton = checkpoint.tree_map(lambda _: 0, tree)  # structure only
        box = {"tree": skeleton, "staged": staged, "events": events}

        def write():
            w0 = time.perf_counter()
            copy_s = 0.0
            for ready, done in box["events"]:
                done.synchronize()  # the copy has landed in host memory
                copy_s += ready.elapsed_time(done) / 1e3
            box["host"] = checkpoint.tree_unflatten(
                box["tree"], [v.numpy() if isinstance(v, torch.Tensor) else v
                              for v in box["staged"]])

            def do_save():
                path = checkpoint.save(ckpt_dir, step, box["host"],
                                       metadata=metadata, tag=tag,
                                       hook=write_hook)
                if keep is not None:
                    checkpoint.prune(ckpt_dir, keep)
                return path

            try:
                retry(do_save, self._retry, op="ckpt/write", log=self._log)
            except BaseException as exc:  # surfaced at the next drain
                self._error = exc
                return
            finally:
                # drop the snapshot's references, then keep the pool's
                # buffers for the next snapshot; one a watchdog-abandoned
                # attempt's thread may still view is dropped instead of
                # reused (it leaks to the pool's finalizer)
                box.clear()
                for b in bufs:
                    if b.live_views():
                        gc.collect()
                    if b.live_views():
                        self._log("ckpt/write: leaked a staging buffer "
                                  "still viewed by an abandoned attempt")
                    else:
                        self._held.setdefault(b.nbytes, []).append(b)
            wall = time.perf_counter() - w0
            self.writes += 1
            if self._metrics is not None:
                self._metrics.counter("ckpt/async_writes").inc()
            if self._sink is not None:
                self._sink.emit("ckpt/write", step=step, wall_s=round(wall, 6),
                                bytes=self.snapshot_bytes,
                                copy_device_s=round(copy_s, 6))

        self._submit(write)
        return blocking_s

    def _observe(self) -> None:
        if self._metrics is None:
            return
        self._metrics.gauge("ckpt/snapshot_bytes").set(self.snapshot_bytes)
        if self._pool is not None:
            stats = self._pool.stats()
            for key in ("bytes_in_use", "bytes_cached", "high_water",
                        "live_buffers", "trim_calls", "locked_bytes"):
                self._metrics.gauge(f"hostpool/{key}").set(stats[key])

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abandon()
