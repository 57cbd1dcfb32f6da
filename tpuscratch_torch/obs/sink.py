"""Per-host JSONL event sink with run metadata.

One line per event, one file per host — the structured replacement for
the reference's rank-prefixed printf logging (its per-rank coord-named
dump files, generalized from result arrays to telemetry).  The first
line of every file is a ``run`` event carrying the run metadata
(argv-ish identity: who wrote this file, when, with what config), so a
bare JSONL artifact is self-describing and ``obs.report`` can collapse
it without side channels.

Writes are buffered (``flush_every`` events) and each event costs one
dict build + one ``json.dumps`` — cheap enough to emit per engine tick.
A ``weakref.finalize`` hook (GC + interpreter exit) flushes the buffered
tail, so short runs and crashed runs that never reach ``close()`` don't
silently lose events — and dropped unclosed sinks don't pin their file
descriptors.
``NullSink`` is the disabled path: every emit is a constant-time no-op,
so instrumented layers hold a sink unconditionally instead of
``if sink is not None`` at every site.

The twin of ``tpuscratch.obs.sink``, line for line: the JSONL field
names are the same, so one reader takes either package's files. It
imports no torch; the per-host index is whatever the caller passes
(the trainer passes 0: every rank of the stacked mesh is one process).
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Optional

__all__ = ["NullSink", "Sink", "open_sink"]


def _close_file(f, buf: list, lock) -> None:
    """Flush the buffered tail and close — the finalizer body.  A plain
    function over (file, buffer, lock) so ``weakref.finalize`` holds no
    reference to the Sink itself (a dropped unclosed sink is collectable
    and closes at GC; survivors close at interpreter exit).  Takes the
    sink's emit lock: a background writer thread's in-flight emit must
    not race the close (a dropped line, or a write to a closed file
    raising inside the writer)."""
    with lock:
        if f.closed:
            return
        if buf:
            f.write("\n".join(buf) + "\n")
            buf.clear()
        f.flush()
        f.close()


class NullSink:
    """The disabled sink: accepts every emit, writes nothing."""

    enabled = False
    path = None

    def emit(self, event: str, **fields) -> None:
        pass

    def emit_metrics(self, snapshot: dict, event: str = "metrics",
                     scope=None) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullSink":
        return self

    def __exit__(self, *exc) -> None:
        pass


class Sink:
    """Append-only JSONL event writer.

    ``run`` metadata is written as the file's first event.  ``host``
    disambiguates multi-host runs: a non-zero host suffixes the filename
    (``run.jsonl`` -> ``run.h3.jsonl``) so hosts never interleave writes
    in one file — the per-host half of "per-host JSONL sink"; merging is
    the reader's job (``obs.report`` accepts several files).

    Emits are THREAD-SAFE (one lock around the buffer + file): the async
    checkpointer's background writer stamps its ``ckpt/write`` event
    from its own thread at the moment the write actually finishes — the
    goodput end-stamp convention — while the step loop keeps emitting.

    ``rotate_bytes`` bounds the file: when a flush leaves the active
    segment at or past the threshold, segments shift logrotate-style
    (``path`` -> ``path.1`` -> ... -> ``path.<max_segments>``, the
    oldest dropped) and a fresh active file opens with its own ``run``
    first line, so every segment stays self-describing and total disk
    is bounded by ``(max_segments + 1) * ~rotate_bytes`` instead of
    growing without bound over a long-lived fleet.  0 (the default)
    disables rotation.
    """

    enabled = True

    def __init__(self, path: str, run: Optional[dict] = None,
                 host: int = 0, flush_every: int = 64,
                 rotate_bytes: int = 0, max_segments: int = 8) -> None:
        if host:
            root, ext = os.path.splitext(path)
            path = f"{root}.h{host}{ext or '.jsonl'}"
        self.path = path
        self.host = host
        self._lock = threading.Lock()
        self._buf: list[str] = []
        self._flush_every = max(1, flush_every)
        self._rotate_bytes = max(0, int(rotate_bytes))
        self._max_segments = max(1, int(max_segments))
        self._run_meta = dict(run or {})
        self.rotations = 0
        self._t0 = time.time()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")
        # buffered writes must not be lost by a run that never reaches
        # close(): a short script that just falls off the end, a crashed
        # run whose exception unwinds past the sink, or a sink simply
        # dropped without close().  weakref.finalize fires on GC AND at
        # interpreter exit without pinning the sink (an atexit-bound
        # method would keep every unclosed sink + fd alive for the
        # process lifetime).  SIGKILL still loses the tail — that torn
        # final line is why obs.report tolerates corrupt lines.
        self._finalizer = weakref.finalize(
            self, _close_file, self._f, self._buf, self._lock
        )
        self.emit("run", host=host, **(run or {}))

    def emit(self, event: str, **fields) -> None:
        """One JSONL line: ``{"event": ..., "t": <s since sink open>,
        **fields}``.  Fields must be JSON-serializable."""
        rec = {"event": event, "t": round(time.time() - self._t0, 6)}
        rec.update(fields)
        line = json.dumps(rec)
        with self._lock:
            if self._f.closed:
                # a background writer outliving the sink: drop the line
                # rather than raise inside a daemon thread (the same
                # tolerance the torn-tail reader grants a SIGKILL)
                return
            self._buf.append(line)
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def emit_metrics(self, snapshot: dict, event: str = "metrics",
                     scope=None) -> None:
        """A registry snapshot (``MetricsRegistry.snapshot()``) as one
        event, metrics nested under ``"metrics"``.  ``scope`` (usually
        ``MetricsRegistry.id``) names WHICH registry this is a snapshot
        of: a reader keeps only the newest snapshot per scope (they are
        cumulative) but merges across scopes (distinct registries, e.g.
        one engine per batch size in a sweep)."""
        if scope is None:
            self.emit(event, metrics=snapshot)
        else:
            self.emit(event, metrics=snapshot, scope=scope)

    def _flush_locked(self) -> None:
        if self._f.closed:
            return
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()
        self._f.flush()
        if self._rotate_bytes and self._f.tell() >= self._rotate_bytes:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift segments and reopen — caller holds the lock (so the
        fresh segment's ``run`` line is written directly, not via
        ``emit``, which would deadlock on the non-reentrant lock)."""
        self._finalizer.detach()  # the old finalizer must not re-close
        self._f.close()
        oldest = f"{self.path}.{self._max_segments}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self._max_segments - 1, 0, -1):
            seg = f"{self.path}.{i}"
            if os.path.exists(seg):
                os.replace(seg, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a")
        self.rotations += 1
        self._finalizer = weakref.finalize(
            self, _close_file, self._f, self._buf, self._lock
        )
        rec = {"event": "run", "t": round(time.time() - self._t0, 6),
               "host": self.host, "segment": self.rotations}
        rec.update(self._run_meta)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        self._finalizer()  # runs at most once: flush the tail + close

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_sink(path: Optional[str], run: Optional[dict] = None,
              host: int = 0, **kw):
    """``Sink`` when ``path`` is set, ``NullSink`` otherwise — the one
    construction idiom every instrumented layer uses, so "no obs
    requested" costs a no-op object rather than branches at call sites."""
    if path is None:
        return NullSink()
    return Sink(path, run=run, host=host, **kw)
