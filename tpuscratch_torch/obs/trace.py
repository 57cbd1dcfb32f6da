"""Always-on bounded flight recorder: spans, instants, Chrome trace.

The reference's only timeline is clock() brackets printed per segment
(mpicuda3.cu:176-179, mpi-pingpong-gpu.cpp:51-57); this module is that
idiom grown into what production fleets actually fly with — a
:class:`FlightRecorder` that is cheap enough to leave ON (a thread-safe
ring buffer of begin/end spans and instant events with monotonic
timestamps; the same < 2% budget as the metrics path, asserted in the
train-bench overhead check) and exports Chrome trace-event JSON that
loads directly in Perfetto / ``chrome://tracing``.

Design points:

- **Bounded**: the ring holds the newest ``capacity`` events; a
  continuously-serving engine never grows without bound.  Per-phase
  AGGREGATES (total seconds, count, max) are kept exactly and
  separately, so eviction loses detail, never accounting.
- **One span implementation**: ``runtime/profiling.Timeline`` is now a
  thin delegate over :meth:`FlightRecorder.open_span` /
  :meth:`close_span` — the sync-fencing bracket lives HERE only.
- **Per-host lanes**: each host exports its own trace
  (:meth:`FlightRecorder.chrome_trace` with ``pid=host``);
  :func:`merge_chrome_traces` concatenates them into one file with one
  lane per host.  Cross-host SPAN math stays on the existing machinery:
  feed :func:`span_stamps` into ``obs.metrics.mesh_span`` for the
  max-min merge, and :func:`mesh_straggler` runs the per-phase max/min
  skew through ``mesh_reduce`` to name the slowest rank.

The twin of ``tpuscratch.obs.trace``. A span asked to fence device
values synchronises the CUDA streams of the tensors it is given (the
JAX package's ``block_until_ready``), so it times device work and not
just its launch; tensors on the CPU need no fence.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
import time
import uuid
from typing import Iterable, Mapping, Optional, Sequence, Union

def sync_tensors(values) -> None:
    """Wait for the device work that writes ``values`` (tensors, or trees
    of them: dicts, lists, tuples): each CUDA device they lie on is
    synchronised once. CPU tensors are ready when they exist."""
    import torch

    seen = set()
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, torch.Tensor) and v.is_cuda and v.device not in seen:
            seen.add(v.device)
            torch.cuda.synchronize(v.device)


__all__ = [
    "FlightRecorder",
    "InstantEvent",
    "PhaseStat",
    "SpanEvent",
    "StragglerReport",
    "detect_stragglers",
    "emit_phase_totals",
    "file_flight_data",
    "fold_phase_events",
    "merge_chrome_traces",
    "mesh_straggler",
    "span_stamps",
    "sync_tensors",
    "validate_chrome_trace",
]


class SpanEvent:
    """One begin/end bracket.  ``end`` is ``None`` while open; ``args``
    is a mutable dict exported into the Chrome event's ``args`` (callers
    may add fields between open and close)."""

    __slots__ = ("name", "begin", "end", "tid", "args",
                 "seq_open", "seq_close")

    def __init__(self, name: str, begin: float, tid: int, args: dict):
        self.name = name
        self.begin = begin
        self.end: Optional[float] = None
        self.tid = tid
        self.args = args
        self.seq_open = next(_OP_SEQ)
        self.seq_close = -1  # stamped at close

    @property
    def seconds(self) -> float:
        if self.end is None:
            raise ValueError(f"span {self.name!r} still open")
        return self.end - self.begin


class InstantEvent:
    """A zero-duration mark (a restart, an injected fault, a compile)."""

    __slots__ = ("name", "ts", "tid", "args", "seq")

    def __init__(self, name: str, ts: float, tid: int, args: dict):
        self.name = name
        self.ts = ts
        self.tid = tid
        self.args = args
        self.seq = next(_OP_SEQ)


@dataclasses.dataclass
class PhaseStat:
    """Exact per-phase aggregate — survives ring eviction."""

    seconds: float = 0.0
    count: int = 0
    max_s: float = 0.0


#: process-unique recorder ids (the ``MetricsRegistry.id`` convention):
#: ``trace/phase`` events carry one as ``scope`` so several recorders
#: sharing one sink file merge instead of last-wins
_REC_SALT = uuid.uuid4().hex[:8]
_REC_IDS = itertools.count()

#: global operation sequence, stamped at every span open, span close,
#: and instant (``next()`` on a C-level count is atomic under the GIL).
#: The Chrome export sorts ties on it, so equal timestamps — a coarse
#: or injected clock, nested spans opened in one tick — still export in
#: TRUE chronological order (B of the outer span before B of the inner,
#: E of the inner before E of the outer), which the validator's stack
#: pairing requires.
_OP_SEQ = itertools.count()


class FlightRecorder:
    """Thread-safe bounded recorder of spans and instants.

    The hot path is two ``perf_counter`` stamps plus one deque append
    under a lock — cheap enough to bracket every engine tick and train
    chunk unconditionally (the "always-on" half of the contract; the
    "bounded" half is the ring's ``capacity``).
    """

    def __init__(self, capacity: int = 4096,
                 clock=time.perf_counter) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock
        self._ring: "list" = []
        self._capacity = capacity
        self._lock = threading.Lock()
        self._phases: dict[str, PhaseStat] = {}
        self._open: set = set()   # spans opened but not yet closed
        self.t0 = clock()   # export zero point (host-local)
        self.dropped = 0    # events evicted from the ring so far
        self.id = f"rec-{_REC_SALT}-{next(_REC_IDS)}"

    # ---- recording -----------------------------------------------------

    def open_span(self, name: str, sync: Sequence = (), **args) -> SpanEvent:
        """Begin a span.  ``sync`` tensors are waited on first, so queued
        device work cannot leak into the bracket."""
        if sync:
            sync_tensors(sync)
        ev = SpanEvent(name, self._clock(), threading.get_ident(), args)
        with self._lock:
            self._open.add(ev)
        return ev

    def close_span(self, ev: SpanEvent) -> SpanEvent:
        """Stamp the end and commit the span to the ring + aggregates."""
        ev.end = self._clock()
        ev.seq_close = next(_OP_SEQ)
        dur = ev.end - ev.begin
        with self._lock:
            self._open.discard(ev)
            ph = self._phases.get(ev.name)
            if ph is None:
                ph = self._phases[ev.name] = PhaseStat()
            ph.seconds += dur
            ph.count += 1
            if dur > ph.max_s:
                ph.max_s = dur
            self._push(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, sync: Sequence = (), **args):
        """``with recorder.span("phase") as ev: ...`` — THE bracket
        implementation (``Timeline.span`` delegates here)."""
        ev = self.open_span(name, sync=sync, **args)
        try:
            yield ev
        finally:
            self.close_span(ev)

    def close_open_spans(self) -> int:
        """Close every span still open (a crashed invocation's in-flight
        brackets), committing the partial wall to the ring + aggregates;
        returns how many were closed.  Balanced callers never need this
        — it exists for the failure path (:func:`file_flight_data`), so
        a phase that was mid-flight when the run died still counts."""
        with self._lock:
            leaked = sorted(self._open, key=lambda ev: ev.begin)
        n = 0
        for ev in leaked:
            if ev.end is None:  # not raced shut by its owning thread
                self.close_span(ev)
                n += 1
        return n

    def instant(self, name: str, **args) -> InstantEvent:
        ev = InstantEvent(name, self._clock(), threading.get_ident(), args)
        with self._lock:
            self._push(ev)
        return ev

    def _push(self, ev) -> None:  # caller holds the lock
        if len(self._ring) >= self._capacity:
            # drop the OLDEST half in one slice instead of one-at-a-time
            # popleft churn; ``dropped`` keeps the evidence
            keep = self._capacity // 2
            self.dropped += len(self._ring) - keep
            del self._ring[: len(self._ring) - keep]
        self._ring.append(ev)

    # ---- reading -------------------------------------------------------

    def events(self) -> list:
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    def phase_totals(self) -> dict[str, PhaseStat]:
        """Exact cumulative {span name: aggregate} — independent of the
        ring, so a long run's totals are never eviction-truncated."""
        with self._lock:
            return {
                k: PhaseStat(p.seconds, p.count, p.max_s)
                for k, p in self._phases.items()
            }

    # ---- Chrome trace export -------------------------------------------

    def chrome_trace(self, pid: int = 0,
                     label: Optional[str] = None) -> dict:
        """The ring as Chrome trace-event JSON (the dict; ``json.dump``
        it and load the file in Perfetto).  Spans export as paired
        ``B``/``E`` events, instants as ``i``; timestamps are
        microseconds relative to the recorder's ``t0``, host-local —
        merging hosts is lane-merging (:func:`merge_chrome_traces`), not
        clock alignment."""
        tids: dict[int, int] = {}

        def tid_of(raw: int) -> int:
            return tids.setdefault(raw, len(tids))

        out = []  # (tid, ts, op-seq, event)
        for ev in self.events():
            tid = tid_of(ev.tid)
            if isinstance(ev, SpanEvent):
                if ev.end is None:
                    continue  # still open: not exportable as a pair
                base = {"name": ev.name, "pid": pid, "tid": tid}
                out.append((tid, (ev.begin - self.t0) * 1e6, ev.seq_open,
                            dict(base, ph="B",
                                 ts=(ev.begin - self.t0) * 1e6,
                                 args=dict(ev.args))))
                out.append((tid, (ev.end - self.t0) * 1e6, ev.seq_close,
                            dict(base, ph="E",
                                 ts=(ev.end - self.t0) * 1e6)))
            else:
                out.append((tid, (ev.ts - self.t0) * 1e6, ev.seq, {
                    "name": ev.name, "ph": "i", "s": "t",
                    "ts": (ev.ts - self.t0) * 1e6, "pid": pid, "tid": tid,
                    "args": dict(ev.args),
                }))
        meta = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label or f"host{pid}"},
        }]
        # B/E pairs must be time-ordered within each lane for the viewer,
        # and the validator's stack pairing needs TRUE order under equal
        # timestamps (coarse/injected clocks): the op-seq counter was
        # stamped in real open/close order, so it is the exact tiebreak
        out.sort(key=lambda e: e[:3])
        return {
            "traceEvents": meta + [e[3] for e in out],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }


def merge_chrome_traces(
    traces: Union[Mapping[int, dict], Iterable[dict]]
) -> dict:
    """Merge per-host Chrome traces into one file, one lane (pid) per
    host.  ``traces`` is {host: trace} or an iterable (hosts numbered in
    order).  Events are re-pid'ed; timestamps stay host-local — the
    viewer shows each host's lane on its own clock, which is exactly the
    per-rank dump-file layout of the reference, merged for one screen."""
    if isinstance(traces, Mapping):
        items = sorted(traces.items())
    else:
        items = list(enumerate(traces))
    events = []
    dropped = 0
    for host, tr in items:
        for ev in tr.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = host
            events.append(ev)
        other = tr.get("otherData", {})
        dropped += int(other.get("dropped_events", 0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": dropped},
    }


def validate_chrome_trace(trace: dict) -> int:
    """The golden schema check: JSON-serializable, every ``B`` paired
    with a same-name ``E`` in stack order per (pid, tid) lane, async
    ``b``/``e`` pairs nested per (pid, id), flow chains (``s`` →
    ``t``* → ``f``) complete per flow id with pid AND tid on every
    step, and timestamps non-decreasing per lane.  Returns the number
    of data events checked; raises ``ValueError`` on the first
    violation.  Equal timestamps rely on the writer's op-seq tiebreak
    (``FlightRecorder.chrome_trace`` sorts on it), so TRUE record
    order survives coarse clocks — the stack pairing here is what that
    rule protects."""
    import json

    json.dumps(trace)  # must be serializable as-is
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    stacks: dict[tuple, list] = {}
    async_stacks: dict[tuple, list] = {}
    # flow id -> state: "open" after s (t keeps it open), closed = gone
    flows: dict = {}
    last_ts: dict[tuple, float] = {}
    n = 0
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            continue
        lane = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            raise ValueError(f"event without numeric ts: {ev!r}")
        if ts < last_ts.get(lane, -math.inf):
            raise ValueError(
                f"non-monotonic ts in lane {lane}: {ts} after "
                f"{last_ts[lane]}"
            )
        last_ts[lane] = ts
        if ph == "B":
            stacks.setdefault(lane, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(lane) or []
            if not stack:
                raise ValueError(f"unmatched E event in lane {lane}: {ev!r}")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(
                    f"mispaired span in lane {lane}: E {ev['name']!r} "
                    f"closes B {top!r}"
                )
        elif ph in ("b", "e"):
            # async-nestable pair: matched per (pid, id), names must
            # pair in stack order (a request's root span in obs.reqtrace)
            if "id" not in ev:
                raise ValueError(f"async event without id: {ev!r}")
            key = (ev.get("pid"), ev["id"])
            if ph == "b":
                async_stacks.setdefault(key, []).append(ev["name"])
            else:
                stack = async_stacks.get(key) or []
                if not stack:
                    raise ValueError(
                        f"unmatched async e for id {ev['id']!r}: {ev!r}"
                    )
                top = stack.pop()
                if top != ev["name"]:
                    raise ValueError(
                        f"mispaired async span id {ev['id']!r}: "
                        f"e {ev['name']!r} closes b {top!r}"
                    )
        elif ph in ("s", "t", "f"):
            # flow chain: starts with s, continues with t, ends with f;
            # every step needs BOTH pid and tid (the viewer anchors flow
            # arrows to lane points — an unpaired step renders nowhere)
            if ev.get("pid") is None or ev.get("tid") is None:
                raise ValueError(f"flow event without pid/tid: {ev!r}")
            if "id" not in ev:
                raise ValueError(f"flow event without id: {ev!r}")
            fid = ev["id"]
            if ph == "s":
                if fid in flows:
                    raise ValueError(f"flow id {fid!r} started twice")
                flows[fid] = "open"
            else:
                if flows.get(fid) != "open":
                    raise ValueError(
                        f"flow {ph!r} for id {fid!r} without open s"
                    )
                if ph == "f":
                    del flows[fid]
        elif ph not in ("i", "I", "X"):
            raise ValueError(f"unknown phase {ph!r}: {ev!r}")
        n += 1
    for lane, stack in stacks.items():
        if stack:
            raise ValueError(f"unclosed span(s) in lane {lane}: {stack}")
    for key, stack in async_stacks.items():
        if stack:
            raise ValueError(
                f"unclosed async span(s) for id {key[1]!r}: {stack}"
            )
    if flows:
        raise ValueError(
            f"unterminated flow chain(s): {sorted(map(repr, flows))}"
        )
    return n


def emit_phase_totals(sink, recorder: FlightRecorder) -> None:
    """One cumulative ``trace/phase`` event per span name — the per-host
    phase aggregates the straggler table (``obs.report``) and the
    goodput straggler-wait carve-out read.  Cumulative semantics: a
    reader keeps the NEWEST event per (file, host, scope, phase) —
    ``scope`` is the recorder's id, so several recorders sharing one
    sink file (a sweep's per-engine recorders, supervised restarts'
    fresh per-invocation recorders) ADD instead of last-wins, like
    scoped metric snapshots.  Shared by the trainer, the halo driver,
    and the serving engine (``sink`` is duck-typed: anything with
    ``.enabled``/``.emit``)."""
    if not getattr(sink, "enabled", False):
        return
    host = getattr(sink, "host", 0) or 0
    for name, ph in sorted(recorder.phase_totals().items()):
        sink.emit("trace/phase", phase=name, host=host,
                  scope=recorder.id,
                  seconds=round(ph.seconds, 6), count=ph.count,
                  max_s=round(ph.max_s, 6))


@contextlib.contextmanager
def file_flight_data(sink, recorder: FlightRecorder):
    """Guarantee a failed invocation still files its flight data: when
    the body raises (preemption, an injected CommError, a genuine
    crash), close the recorder's in-flight spans — a chunk that was
    mid-step when the run died still counts its partial wall — then
    emit the cumulative ``trace/phase`` totals and flush the sink's
    buffered tail before re-raising.  The happy path files nothing;
    callers emit their totals at the natural end-of-run point.  THE
    shared failure-path block of the trainer and the halo driver."""
    try:
        yield recorder
    except BaseException:
        recorder.close_open_spans()
        emit_phase_totals(sink, recorder)
        sink.flush()
        raise


def fold_phase_events(
    events: Iterable[Mapping],
) -> dict[str, dict[int, float]]:
    """``{phase: {host: cumulative seconds}}`` from loaded ``trace/phase``
    event dicts — THE fold both readers share (``obs.report.stragglers``
    and the goodput straggler-wait carve-out must agree on the same
    artifact).  Cumulative semantics, mirroring scoped metric snapshots:
    the newest event per (file, host, scope, phase) wins (a recorder
    re-emits growing totals), the same (host, scope, phase) seen in
    several files keeps the larger total (a duplicated artifact must not
    double-count), and DISTINCT scopes — different recorders: a sweep's
    per-engine ones, supervised restarts' fresh ones — add, so one host
    running several instrumented components is still one host with all
    its work counted."""
    latest: dict[tuple, float] = {}
    for rec in events:
        if rec.get("event") != "trace/phase":
            continue
        secs = rec.get("seconds")
        if isinstance(secs, bool) or not isinstance(secs, (int, float)) \
                or not math.isfinite(secs):
            continue
        key = (rec.get("_file"), rec.get("host", 0), rec.get("scope"),
               rec.get("phase"))
        latest[key] = float(secs)
    by_scope: dict[tuple, float] = {}
    for (_file, host, scope, phase), secs in latest.items():
        k = (host, scope, phase)
        by_scope[k] = max(by_scope.get(k, 0.0), secs)
    per_phase: dict[str, dict[int, float]] = {}
    for (host, _scope, phase), secs in by_scope.items():
        cur = per_phase.setdefault(phase, {})
        cur[host] = cur.get(host, 0.0) + secs
    return per_phase


def span_stamps(recorder: FlightRecorder,
                name: str) -> tuple[list[float], list[float]]:
    """(begins, ends) of every closed ``name`` span in the ring — the
    per-rank stamp lists ``obs.metrics.mesh_span`` merges with the
    max-min convention."""
    begins, ends = [], []
    for ev in recorder.events():
        if isinstance(ev, SpanEvent) and ev.name == name \
                and ev.end is not None:
            begins.append(ev.begin)
            ends.append(ev.end)
    return begins, ends


# ---- straggler detection ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    """One phase's cross-host skew: who was slowest, by how much."""

    phase: str
    slowest: int      # host / mesh-position index
    fastest: int
    max_s: float
    min_s: float

    @property
    def skew(self) -> float:
        """slowest / fastest time ratio (inf when the fastest is 0)."""
        if self.min_s <= 0:
            return math.inf if self.max_s > 0 else 1.0
        return self.max_s / self.min_s

    def summary(self) -> str:
        return (
            f"{self.phase}: host {self.slowest} slowest "
            f"({self.max_s * 1e3:.3f} ms vs host {self.fastest} "
            f"{self.min_s * 1e3:.3f} ms, skew {self.skew:.2f}x)"
        )


def detect_stragglers(
    per_host: Mapping[str, Mapping[int, float]],
    min_skew: float = 1.2,
) -> list[StragglerReport]:
    """Pure host-side straggler scan: ``{phase: {host: seconds}}`` →
    one report per phase whose max/min ratio reaches ``min_skew``
    (phases seen on < 2 hosts carry no skew signal and are skipped).
    The ``merge_snapshots`` twin of :func:`mesh_straggler`."""
    out = []
    for phase, hosts in sorted(per_host.items()):
        if len(hosts) < 2:
            continue
        slowest = max(hosts, key=lambda h: hosts[h])
        fastest = min(hosts, key=lambda h: hosts[h])
        rep = StragglerReport(phase, slowest, fastest,
                              float(hosts[slowest]), float(hosts[fastest]))
        if rep.skew >= min_skew:
            out.append(rep)
    return out


def mesh_straggler(mesh, phase: str,
                   per_rank_seconds: Sequence[float]) -> StragglerReport:
    """Per-phase skew THROUGH the mesh collectives: one ``mesh_reduce``
    finds max/min seconds device-side (the mpicuda3 gather), a second
    runs the MAXLOC/MINLOC trick — each rank contributes its index only
    where its time ties the extremum — so the report NAMES the slow rank,
    not just the gap.  ``per_rank_seconds`` is row-major over the mesh
    positions (the ``mesh_reduce`` contract)."""
    from tpuscratch_torch.obs.metrics import mesh_reduce

    secs = [float(s) for s in per_rank_seconds]
    red = mesh_reduce(mesh, [[s, -s] for s in secs], ops=("max",))["max"]
    max_s, min_s = float(red[0]), -float(red[1])
    # f32 device round trip: ties need a tolerance proportional to scale
    tol = max(1e-6, 1e-4 * abs(max_s))
    loc_rows = [
        [i if s >= max_s - tol else -1, i if s <= min_s + tol else -1]
        for i, s in enumerate(secs)
    ]
    loc = mesh_reduce(mesh, loc_rows, ops=("max",))["max"]
    return StragglerReport(phase, slowest=int(loc[0]), fastest=int(loc[1]),
                           max_s=max_s, min_s=min_s)
