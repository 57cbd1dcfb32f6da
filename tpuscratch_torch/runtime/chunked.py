"""The chunked-program runtime: ONE chunk loop for every workload.

The trainer (``models.trainer``), the halo driver (``halo.driver``) and
the solver runner (``solvers.runner``) share one loop: launch a chunk
inside a flight-recorder span, emit a ``<workload>/chunk`` event,
checkpoint the state at the boundary (blocking ``ckpt/save`` under
``ft.retry``, or the snapshot-then-publish split of
``runtime.async_ckpt``), and give chaos its two boundary hooks — a
transient fault before the chunk and a simulated preemption after the
save.  This module is that loop, and the three drivers are thin adapters
over it. The twin of ``tpuscratch.runtime.chunked``, with the same event
stream (``ckpt/save`` and ``ckpt/snapshot`` also carry the state's
``bytes``).

A :class:`ChunkedProgram` is the loop REIFIED: instead of a function
that runs to completion, it is an object that advances one chunk per
``tick()`` — which is exactly what a co-scheduler needs.  Every tick
boundary is a clean preemption point (the state was just published, or
handed to the async writer whose barrier the program drains at its own
exit), so a co-scheduler can interleave ticks of N programs on one mesh
without any of them knowing.  ``run()`` is the
classic blocking form: start, tick until done, finish.

The adapter contract (what the three drivers plug in):

- ``run_chunk(cp, pos)``: launch the chunk and FENCE it (a host read
  of a result, or ``torch.cuda.synchronize``), so the span times the
  device work; return an opaque payload.  The runtime
  brackets the call in a ``{prefix}/chunk`` span.
- ``make_event(cp, pos, payload, span) -> ChunkResult``: fold the
  payload into adapter state and produce the chunk event fields plus
  the new position.  A ``rollback=True`` result (the trainer's guard
  ladder) skips the event/save/preempt tail and resumes from the
  returned position.
- ``snapshot(cp, pos) -> (tree, metadata)``: the state to publish at
  ``pos``.  Async path: staged device→host inside the ``ckpt/snapshot``
  span by the :class:`~tpuscratch_torch.runtime.async_ckpt.AsyncCheckpointer`.
  Blocking path: copied to host numpy arrays and saved under
  ``ft.retry``, both inside the ``ckpt/save`` span, pruned to ``keep``.
- ``epilogue(cp)``: the driver's run summary (its ``*/run`` event,
  phase totals, result value) — runs after the contexts closed, so the
  async barrier has drained.

Every event a program emits is stamped ``workload=<name>`` by
:class:`WorkloadSink` — the tag ``obs.goodput.by_workload`` partitions
one co-scheduled JSONL stream on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Callable, Optional

from tpuscratch_torch.ft.chaos import bind_sink
from tpuscratch_torch.ft.retry import RetryPolicy, retry
from tpuscratch_torch.obs.sink import NullSink
from tpuscratch_torch.obs.trace import FlightRecorder, file_flight_data
from tpuscratch_torch.runtime import checkpoint

__all__ = ["ChunkResult", "ChunkedProgram", "WorkloadSink", "kernel_builds"]


def kernel_builds() -> int:
    """Kernel libraries loaded so far in this process. A chunk (or step)
    during which the count grew paid a kernel's nvcc build and load inside
    its bracket — the drivers book its wall as ``compile_s``, the JAX
    package's compile convention (its jit compiles inside a fresh
    program's first call)."""
    from tpuscratch_torch.ops import common

    return len(common._libs)


class WorkloadSink:
    """A tagging proxy over an ``obs.sink``: every event gains a
    ``workload=<name>`` field, so N programs sharing one JSONL stream
    stay separable (``obs.goodput.by_workload`` splits on the tag).
    Everything else — thread-safety, buffering, ``enabled`` — is the
    wrapped sink's; a wrapped ``NullSink`` still costs a no-op."""

    def __init__(self, inner, workload: str):
        while isinstance(inner, WorkloadSink):  # never stack tags
            inner = inner.inner
        self.inner = inner
        self.workload = workload

    @property
    def enabled(self) -> bool:
        return self.inner.enabled

    def emit(self, event: str, **fields) -> None:
        fields.setdefault("workload", self.workload)
        self.inner.emit(event, **fields)

    def emit_metrics(self, snapshot: dict, event: str = "metrics",
                     scope=None) -> None:
        self.inner.emit_metrics(snapshot, event=event, scope=scope)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):  # path, host, ...
        return getattr(self.inner, name)


@dataclasses.dataclass
class ChunkResult:
    """What one chunk did: the new position, the ``{prefix}/chunk``
    event fields (``None``: emit nothing), whether to checkpoint, and
    the two early exits — ``rollback`` (discard the chunk, resume from
    ``pos``; the trainer's guard ladder) and ``stop`` (converged)."""

    pos: int
    event: Optional[dict] = None
    save: bool = True
    rollback: bool = False
    stop: bool = False


class ChunkedProgram:
    """A checkpointed chunk loop as a steppable object.

    ``workload`` names the program (the event tag and the scheduler
    key); ``prefix`` is the event namespace (``{prefix}/chunk`` spans
    and events — defaults to ``workload``, kept separate so two train
    jobs can share the ``train/chunk`` event kind under distinct tags).
    ``total`` is the terminal position; ``pos`` the (resumed) start.

    Checkpointing: ``ckpt_dir=None`` or ``snapshot=None`` disables it
    (an ephemeral burst job).  ``async_ckpt=True`` builds an
    :class:`AsyncCheckpointer` (``write_retry`` is its writer policy);
    otherwise blocking saves run under ``save_retry`` when set.

    Chaos: ``fail_site`` fires ``maybe_fail`` before each chunk (the
    halo/solver ``comm/*`` sites), ``preempt_site`` fires
    ``maybe_preempt`` after the save; the plan is bound to the tagged
    sink so injected-fault events carry the workload tag.

    ``remake`` is the restart factory: a zero-arg callable returning a
    FRESH program resumed from ``ckpt_dir`` — what
    ``ft.supervisor.supervise_program`` and the scheduler's per-entry
    restart path re-invoke after a ``Preempted``/``CommError``.
    """

    def __init__(
        self,
        *,
        workload: str,
        total: int,
        run_chunk: Callable[["ChunkedProgram", int], Any],
        make_event: Callable[["ChunkedProgram", int, Any, Any], ChunkResult],
        prefix: Optional[str] = None,
        pos: int = 0,
        snapshot: Optional[Callable[["ChunkedProgram", int], tuple]] = None,
        epilogue: Optional[Callable[["ChunkedProgram"], Any]] = None,
        span_args: Optional[Callable[[int], dict]] = None,
        save_span_args: Optional[Callable[[int], dict]] = None,
        on_saved: Optional[Callable[["ChunkedProgram", int], None]] = None,
        post_boundary: Optional[Callable[["ChunkedProgram", int], bool]] = None,
        fail_site: Optional[str] = None,
        fail_op: Optional[str] = None,
        preempt_site: Optional[str] = None,
        ckpt_dir: Optional[str] = None,
        keep: int = 3,
        save_retry: Optional[RetryPolicy] = None,
        write_retry: Optional[RetryPolicy] = None,
        async_ckpt: bool = False,
        sink=None,
        recorder: Optional[FlightRecorder] = None,
        metrics=None,
        chaos=None,
        log: Callable[[str], None] = lambda s: None,
        remake: Optional[Callable[[], "ChunkedProgram"]] = None,
    ):
        self.workload = workload
        self.prefix = prefix if prefix is not None else workload
        self.total = total
        self.pos = pos
        self.sink = (sink if isinstance(sink, WorkloadSink)
                     else WorkloadSink(sink if sink is not None else NullSink(),
                                       workload))
        self.rec = recorder if recorder is not None else FlightRecorder()
        self.metrics = metrics
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.remake = remake
        self.result: Any = None
        self.finished = False
        self._stopped = False
        self._stack: Optional[contextlib.ExitStack] = None
        self._run_chunk = run_chunk
        self._make_event = make_event
        self._snapshot = snapshot
        self._epilogue = epilogue
        self._span_args = span_args
        self._save_span_args = save_span_args
        self._on_saved = on_saved
        self._post_boundary = post_boundary
        self._fail_site = fail_site
        self._fail_op = fail_op
        self._preempt_site = preempt_site
        self._save_retry = save_retry
        self._chaos = chaos
        self._log = log
        self._save_hook = chaos.save_hook() if chaos is not None else None
        if chaos is not None:
            # injected-fault events land in the run's own (tagged) stream
            bind_sink(chaos, self.sink)
        self.ckp = None
        if async_ckpt and snapshot is not None and ckpt_dir is not None:
            from tpuscratch_torch.runtime.async_ckpt import AsyncCheckpointer

            self.ckp = AsyncCheckpointer(retry=write_retry, chaos=chaos,
                                         sink=self.sink, metrics=metrics,
                                         log=log)

    # ---- lifecycle ------------------------------------------------------

    @property
    def started(self) -> bool:
        return self._stack is not None

    @property
    def done(self) -> bool:
        """No more chunks to run (``finish()`` may still be owed)."""
        return self.finished or self._stopped or self.pos >= self.total

    def start(self) -> None:
        """Enter the run contexts: flight-data filing (a failed run
        still files its spans, phase totals and event tail) around the
        async-checkpoint barrier (drain on clean exit, abandon-with-log
        while unwinding) — the nesting all three legacy loops used."""
        if self._stack is not None:
            raise RuntimeError(f"{self.workload}: already started")
        if self.finished:
            raise RuntimeError(f"{self.workload}: already finished")
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(file_flight_data(self.sink, self.rec))
        if self.ckp is not None:
            self._stack.enter_context(self.ckp)

    def ensure_started(self) -> None:
        if self._stack is None and not self.finished:
            self.start()

    def finish(self):
        """Close the contexts (the async barrier drains here — a write
        failure surfaces before the epilogue claims success), then run
        the adapter epilogue and return its result."""
        if self.finished:
            return self.result
        if self._stack is not None:
            stack, self._stack = self._stack, None
            stack.close()
        self.finished = True
        if self._epilogue is not None:
            self.result = self._epilogue(self)
        return self.result

    def abort(self) -> None:
        """Unwind the contexts under the in-flight exception
        (``sys.exc_info()``): flight data is filed, the async writer is
        abandoned-with-log.  The scheduler/supervisor call this before
        re-invoking ``remake``."""
        stack, self._stack = self._stack, None
        if stack is not None:
            stack.__exit__(*sys.exc_info())

    def drain(self) -> None:
        """Barrier on the in-flight async write (no-op when blocking) —
        the adapter rollback path's "what is the last COMMITTED step"
        precondition."""
        if self.ckp is not None:
            self.ckp.drain()

    # ---- the one chunk loop ---------------------------------------------

    def tick(self) -> ChunkResult:
        """Advance one chunk: chaos fail site → ``{prefix}/chunk`` span
        around the fenced dispatch → chunk event → checkpoint →
        ``preempt_site`` → stop rule.  Exactly the legacy loop body; a
        raised ``Preempted``/``CommError`` leaves the program abortable
        and re-makeable."""
        if self.done:
            raise RuntimeError(f"{self.workload}: tick() past the end")
        self.ensure_started()
        pos = self.pos
        if self._chaos is not None and self._fail_site is not None:
            self._chaos.maybe_fail(self._fail_site, index=pos,
                                   op=self._fail_op)
        args = (self._span_args(pos) if self._span_args is not None
                else {"step_begin": pos})
        sp = self.rec.open_span(f"{self.prefix}/chunk", **args)
        payload = self._run_chunk(self, pos)
        self.rec.close_span(sp)
        res = self._make_event(self, pos, payload, sp)
        self.pos = res.pos
        if res.rollback:
            return res
        if res.event is not None:
            self.sink.emit(f"{self.prefix}/chunk", **res.event)
        if res.save and self._snapshot is not None and self.ckpt_dir is not None:
            self._save(res.pos)
        if self._on_saved is not None:
            self._on_saved(self, res.pos)
        if self._chaos is not None and self._preempt_site is not None:
            # AFTER the save: the restarted program resumes exactly
            # here.  No async drain — the checkpointer's context exit
            # completes a carried write before any re-invocation
            self._chaos.maybe_preempt(self._preempt_site, index=res.pos)
        if res.stop or (self._post_boundary is not None
                        and self._post_boundary(self, res.pos)):
            self._stopped = True
        return res

    def _save(self, pos: int) -> None:
        sargs = (self._save_span_args(pos) if self._save_span_args is not None
                 else {"step": pos})
        if self.ckp is not None:
            # async: pay only the device→pinned-host copy here; the
            # serialize+publish runs on the background writer (its
            # ckpt/write event is stamped when it truly finishes)
            sp = self.rec.open_span("ckpt/snapshot", **sargs)
            tree, meta = self._snapshot(self, pos)
            self.ckp.snapshot(self.ckpt_dir, pos, tree, metadata=meta,
                              keep=self.keep)
            self.rec.close_span(sp)
            self.sink.emit("ckpt/snapshot", step=pos,
                           wall_s=round(sp.seconds, 6),
                           bytes=self.ckp.snapshot_bytes)
        else:
            tree, meta = self._snapshot(self, pos)
            sp = self.rec.open_span("ckpt/save", **sargs)
            snap = checkpoint.to_host(tree)
            nbytes = sum(a.nbytes for a in checkpoint.tree_flatten(snap)[0])

            def do_save(at=pos, snap=snap, meta=meta):
                return checkpoint.save(self.ckpt_dir, at, snap,
                                       metadata=meta, hook=self._save_hook)

            if self._save_retry is not None:
                retry(do_save, self._save_retry, op="ckpt/save",
                      log=self._log)
            else:
                do_save()
            checkpoint.prune(self.ckpt_dir, self.keep)
            self.rec.close_span(sp)
            self.sink.emit("ckpt/save", step=pos,
                           wall_s=round(sp.seconds, 6), bytes=nbytes)

    def run(self):
        """The blocking form the three legacy entry points keep: start,
        tick to completion, finish.  A failure aborts (files flight
        data) and re-raises — the supervisor's restart surface."""
        self.ensure_started()
        try:
            while not self.done:
                self.tick()
        except BaseException:
            self.abort()
            raise
        return self.finish()

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        state = ("finished" if self.finished
                 else "running" if self.started else "pending")
        return (f"ChunkedProgram({self.workload!r}, pos={self.pos}/"
                f"{self.total}, {state})")
