"""Goodput / badput accounting and MFU over a run's JSONL event stream.

The twin of ``tpuscratch.obs.goodput``: the same partition of the same
event stream, so one JSONL artifact reads alike in both packages.

The ROADMAP north star is "as fast as the hardware allows"; the two
numbers that make that claim auditable are **MFU** (model FLOPs actually
retired per second over the chip's peak — the PaLM convention) and the
**goodput fraction** (what share of wall time was spent computing
committed steps, vs the badput taxonomy a production run bleeds into:
compile, checkpoint IO, rollback replay, restart backoff, straggler
wait).  This module computes both from the artifact alone — the per-host
JSONL stream every instrumented layer already writes — plus the static
``obs.ledger`` FLOP count for the MFU numerator.

Accounting contract (the part a report must PROVE, not eyeball): every
event that carries a duration is emitted at the END of its activity, so
``[t - duration, t]`` is an interval on the sink's clock.  The report
lays all attributed intervals on the ``[first event, last event]``
window, clips overlaps (earliest claim wins), scales down in the
(measurement-slop) case where attributions exceed the window, and calls
the remainder ``other`` — so the buckets **sum to the wall time
exactly, by construction**.  ``straggler_wait`` is carved out of
``other`` from the cross-host ``trace/phase`` skew when per-host data
exists (a fast host's idle time hides in its unattributed wall).

Duration sources (event kind → field → bucket):

==============  ============  ==========
train/chunk     chunk_s       step  (its ``compile_s`` share → compile)
halo/chunk      wall_s        step  (its ``compile_s`` share → compile)
solver/chunk    wall_s        step  (its ``compile_s`` share → compile)
serve/tick      tick_s        step  (compile-ticked ticks → compile)
ckpt/save       wall_s        checkpoint
ckpt/snapshot   wall_s        checkpoint
ft/rollback     lost_s        rollback
ft/restart      backoff_s     restart
==============  ============  ==========

The async-checkpoint split (``runtime.async_ckpt``): ``ckpt/snapshot``
is the BLOCKING cost the step loop actually paid — the device→host
copy plus, crucially, the barrier drain of a still-running previous
write (the snapshot bracket opens before the drain), so a write too
slow to hide behind the next chunk books here automatically.
``ckpt/write`` is deliberately NOT an interval in the partition: it
runs on a background thread CONCURRENTLY with whatever the loop does
next, so its wall is not the loop's wall — counting it would book time
the run never lost.  The event exists for visibility (count, wall, the
config-16 write totals); the partition sees the async path only
through what it blocked.

Compile detection is per layer: the trainer brackets each step and sums
the walls of steps whose ``CompileCounter`` ticked into ``compile_s``;
the halo driver stamps a chunk whose program was freshly built (its
kernels' first launches, nvcc builds included, fire inside that chunk,
so the bracket is build-dominated — the same convention at chunk
granularity); a
``serve/tick`` whose cumulative ``decode_compiles``/``prefill_compiles``
counters moved books its whole ``tick_s`` to compile (the engine's
zero-steady-state-recompile contract makes such ticks rare and
compile-dominated).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

__all__ = ["BUCKETS", "GoodputReport", "WorkloadGoodput", "by_workload",
           "goodput_report"]

#: the wall-time partition, in report order.  ``step`` is the goodput
#: bucket; everything else is badput (``other`` = unattributed host
#: time: setup, dispatch, readback, restart re-init).
BUCKETS = ("step", "compile", "checkpoint", "rollback", "restart",
           "straggler_wait", "other")

#: event kind -> (duration field, bucket)
_DURATION_EVENTS = {
    "train/chunk": ("chunk_s", "step"),
    "halo/chunk": ("wall_s", "step"),
    "solver/chunk": ("wall_s", "step"),
    "serve/tick": ("tick_s", "step"),
    "ckpt/save": ("wall_s", "checkpoint"),
    "ckpt/snapshot": ("wall_s", "checkpoint"),
    "ft/rollback": ("lost_s", "rollback"),
    "ft/restart": ("backoff_s", "restart"),
}


@dataclasses.dataclass(frozen=True)
class GoodputReport:
    """The answer to "what did the wall time buy".

    ``buckets`` partitions ``wall_s`` (multi-host streams sum to
    host-seconds): ``sum(buckets.values()) == wall_s`` exactly.  ``mfu``
    / ``model_flops_per_s`` are set when the caller supplied the FLOP
    side (``flops_per_step`` or ``flops_per_token`` from the ledger, and
    a peak for the fraction)."""

    wall_s: float
    buckets: dict[str, float]
    steps: int
    tokens: int
    mfu: Optional[float] = None
    model_flops_per_s: Optional[float] = None

    @property
    def goodput_fraction(self) -> float:
        return self.buckets["step"] / self.wall_s if self.wall_s else 0.0

    @property
    def badput(self) -> dict[str, float]:
        """The non-goodput buckets, nonzero ones only."""
        return {k: v for k, v in self.buckets.items()
                if k != "step" and v > 0}

    def check(self, tol: float = 1e-6) -> None:
        """Assert the partition invariant (tests call this; it should
        never fire — the construction guarantees it)."""
        total = sum(self.buckets.values())
        if abs(total - self.wall_s) > tol * max(1.0, self.wall_s):
            raise AssertionError(
                f"buckets sum {total} != wall {self.wall_s}"
            )

    def summary(self) -> str:
        lines = [
            f"wall {self.wall_s:.3f} s: goodput "
            f"{100 * self.goodput_fraction:.1f}% "
            f"({self.steps} steps, {self.tokens} tokens)"
        ]
        if self.mfu is not None:
            lines[0] += f", MFU {100 * self.mfu:.2f}%"
        elif self.model_flops_per_s is not None:
            lines[0] += f", {self.model_flops_per_s / 1e12:.3f} TFLOP/s model"
        for k in BUCKETS:
            v = self.buckets.get(k, 0.0)
            if v <= 0 and k != "step":
                continue
            share = 100 * v / self.wall_s if self.wall_s else 0.0
            lines.append(f"  {k:<15} {v:9.3f} s  {share:5.1f}%")
        return "\n".join(lines)


def _num(rec: dict, key: str) -> Optional[float]:
    v = rec.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    if not math.isfinite(v):
        return None
    return float(v)


def _account_group(events: Sequence[dict]) -> tuple[float, dict, int, int]:
    """One host file's partition: (wall, buckets, steps, tokens)."""
    ts = [t for t in (_num(r, "t") for r in events) if t is not None]
    if not ts:
        return 0.0, {k: 0.0 for k in BUCKETS}, 0, 0
    t0, t1 = min(ts), max(ts)
    wall = t1 - t0
    # attributed intervals: (start, end, {bucket: seconds})
    intervals = []
    steps = tokens = 0
    seen_cc: Optional[float] = None  # last cumulative serve compile count
    for rec in events:
        kind = rec.get("event")
        src = _DURATION_EVENTS.get(kind)
        if src is None:
            continue
        field, bucket = src
        dur = _num(rec, field)
        end = _num(rec, "t")
        if dur is None or end is None or dur <= 0:
            continue
        start = max(t0, end - dur)
        parts = {bucket: end - start}
        if kind in ("train/chunk", "halo/chunk", "solver/chunk"):
            comp = _num(rec, "compile_s") or 0.0
            comp = min(comp, parts["step"])
            if comp > 0:
                parts = {"step": parts["step"] - comp, "compile": comp}
        elif kind == "serve/tick":
            # the tick events carry CUMULATIVE compile counters; a tick
            # where they moved is a compile-dominated bracket (any
            # change counts: a fresh engine in the same file resets
            # the cumulative counts downward and recompiles)
            cc = ((_num(rec, "decode_compiles") or 0.0)
                  + (_num(rec, "prefill_compiles") or 0.0))
            ticked = cc > 0 if seen_cc is None else cc != seen_cc
            seen_cc = cc
            if ticked:
                parts = {"compile": parts.pop("step")}
        if kind == "train/chunk":
            steps += int(_num(rec, "steps") or 0)
            tk = _num(rec, "tokens")
            if tk is None:
                rate, cs = _num(rec, "tokens_per_s"), _num(rec, "chunk_s")
                tk = rate * cs if rate is not None and cs is not None else 0
            tokens += int(tk)
        intervals.append((start, end, parts))
    # sweep: clip overlaps (earliest claim wins) so attributed <= wall
    intervals.sort(key=lambda iv: iv[0])
    buckets = {k: 0.0 for k in BUCKETS}
    cursor = t0
    for start, end, parts in intervals:
        s = max(start, cursor)
        e = min(end, t1)
        if e <= s:
            continue
        frac = (e - s) / (end - start)
        for b, v in parts.items():
            buckets[b] += v * frac
        cursor = max(cursor, e)
    attributed = sum(buckets.values())
    if attributed > wall > 0:
        # durations can overhang the event window by measurement slop;
        # scale down so the partition stays exact
        scale = wall / attributed
        buckets = {k: v * scale for k, v in buckets.items()}
        attributed = wall
    buckets["other"] = wall - attributed
    return wall, buckets, steps, tokens


def _straggler_wait(events: Sequence[dict]) -> float:
    """Cross-host idle time from ``trace/phase`` events: per phase, the
    fast hosts' shortfall against the slowest (the time they spent
    waiting at the collective).  The cumulative-event fold is
    ``obs.trace.fold_phase_events`` — the same one the
    ``obs.report.stragglers`` table reads, so the bucket and the table
    always agree on one artifact."""
    from tpuscratch_torch.obs.trace import fold_phase_events

    per_phase = fold_phase_events(events)
    wait = 0.0
    for hosts in per_phase.values():
        if len(hosts) < 2:
            continue
        slowest = max(hosts.values())
        wait += sum(slowest - v for v in hosts.values())
    return wait


def goodput_report(
    events: Sequence[dict],
    *,
    wall_s: Optional[float] = None,
    flops_per_step: Optional[float] = None,
    flops_per_token: Optional[float] = None,
    peak_flops_per_s: Optional[float] = None,
) -> GoodputReport:
    """Build a :class:`GoodputReport` from a loaded event stream
    (``obs.report.load_events`` output, or any list of event dicts).

    Events are grouped per source file (``_file``, present when loaded
    through ``load_events``; absent ⇒ one group) AND per sink session
    within the file — every ``run`` metadata event after the first marks
    a reopened sink with a fresh clock (a crashed run resumed by a new
    process appends to the same path), so each session's timestamps are
    only compared with themselves; session walls and buckets sum.
    ``wall_s`` overrides the measured window (single-group streams only
    — e.g. an external fence around the run); the ``other`` bucket
    absorbs the difference so the partition stays exact.

    MFU: ``flops_per_step`` (the ledger's ``analyze(step).flops``) ×
    committed steps, or ``flops_per_token`` × tokens, over ``wall_s`` —
    and over ``peak_flops_per_s`` for the fraction."""
    groups: dict = {}
    seen: dict = {}     # file -> events seen (any kind)
    session: dict = {}  # file -> current sink-session ordinal
    for rec in events:
        f = rec.get("_file")
        if rec.get("event") == "run" and seen.get(f):
            # a reopened sink: its "run" header restarts the clock, so
            # this file's subsequent events are a NEW accounting window
            session[f] = session.get(f, 0) + 1
        seen[f] = seen.get(f, 0) + 1
        groups.setdefault((f, session.get(f, 0)), []).append(rec)
    wall = 0.0
    buckets = {k: 0.0 for k in BUCKETS}
    steps = tokens = 0
    for recs in groups.values():
        w, b, s, t = _account_group(recs)
        wall += w
        for k, v in b.items():
            buckets[k] += v
        steps += s
        tokens += t
    if wall_s is not None:
        if len(groups) > 1:
            raise ValueError(
                "wall_s override only applies to a single-host, "
                f"single-session stream (got {len(groups)} groups)"
            )
        buckets["other"] += wall_s - wall
        if buckets["other"] < 0:
            # the external fence was shorter than the stream window —
            # trust the stream, which is what the buckets partition
            buckets["other"] = 0.0
            wall_s = sum(buckets.values())
        wall = wall_s
    # straggler wait is already inside somebody's unattributed time:
    # carve it from ``other`` so the partition stays a partition
    sw = min(_straggler_wait(events), buckets["other"])
    buckets["straggler_wait"] = sw
    buckets["other"] -= sw
    total_flops = None
    if flops_per_step is not None:
        total_flops = flops_per_step * steps
    elif flops_per_token is not None:
        total_flops = flops_per_token * tokens
    rate = total_flops / wall if total_flops is not None and wall > 0 else None
    mfu = (rate / peak_flops_per_s
           if rate is not None and peak_flops_per_s else None)
    return GoodputReport(wall_s=wall, buckets=buckets, steps=steps,
                         tokens=tokens, mfu=mfu, model_flops_per_s=rate)


# ---- per-workload partitioning (the co-scheduled stream) ----------------


@dataclasses.dataclass(frozen=True)
class WorkloadGoodput:
    """One co-scheduled stream split into per-workload reports.

    ``wall_s`` is the scheduler's arbitration window (first
    ``sched/switch`` to ``sched/run``); the per-workload ``reports``
    each account only that workload's OWN time slices, so their walls
    partition ``wall_s`` exactly — :meth:`check` asserts it, plus each
    report's own bucket invariant.  Switch overhead books to the
    INCOMING workload's slice (``sched/switch`` is stamped before the
    tick), where it lands in ``other``."""

    wall_s: float
    reports: dict[str, GoodputReport]
    switches: int
    slices: dict[str, int]   # workload -> number of scheduling slices
    targets: Optional[dict] = None

    @property
    def shares(self) -> dict[str, float]:
        """Each workload's fraction of the scheduler wall."""
        return {k: (r.wall_s / self.wall_s if self.wall_s else 0.0)
                for k, r in self.reports.items()}

    def check(self, tol: float = 1e-6) -> None:
        """Assert the two-level partition: every per-workload report's
        buckets sum to its wall, and the walls sum to the scheduler
        wall."""
        for rep in self.reports.values():
            rep.check(tol)
        total = math.fsum(r.wall_s for r in self.reports.values())
        if abs(total - self.wall_s) > tol * max(1.0, self.wall_s):
            raise AssertionError(
                f"per-workload walls sum {total} != scheduler wall "
                f"{self.wall_s}"
            )

    def table(self) -> list[dict]:
        """The arbitration table: one row per workload — slices, wall,
        achieved share (vs the policy ``target`` and its ``share_err``
        when targets are known), goodput fraction."""
        shares = self.shares
        rows = []
        for name, rep in self.reports.items():
            row = {
                "workload": name,
                "slices": self.slices.get(name, 0),
                "wall_s": round(rep.wall_s, 6),
                "share": round(shares[name], 6),
                "goodput_fraction": round(rep.goodput_fraction, 6),
            }
            if self.targets and name in self.targets:
                row["target"] = round(float(self.targets[name]), 6)
                row["share_err"] = round(
                    abs(shares[name] - float(self.targets[name])), 6)
            rows.append(row)
        return rows

    def summary(self) -> str:
        lines = [f"scheduler wall {self.wall_s:.3f} s, "
                 f"{self.switches} switch(es)"]
        for row in self.table():
            line = (f"  {row['workload']:<10} {row['slices']:3d} slices  "
                    f"wall {row['wall_s']:8.3f} s  "
                    f"share {100 * row['share']:5.1f}%  "
                    f"goodput {100 * row['goodput_fraction']:5.1f}%")
            if "target" in row:
                line += (f"  target {100 * row['target']:5.1f}% "
                         f"(err {100 * row['share_err']:.1f}pt)")
            lines.append(line)
        return "\n".join(lines)


def _parse_intervals(events: Sequence[dict]):
    """``_account_group``'s per-event parse with the start stamp
    UNCLAMPED (slice clipping owns the window): returns
    ``([(start, end, parts, dur)], steps, tokens)``."""
    intervals = []
    steps = tokens = 0
    seen_cc: Optional[float] = None
    for rec in events:
        kind = rec.get("event")
        src = _DURATION_EVENTS.get(kind)
        if src is None:
            continue
        field, bucket = src
        dur = _num(rec, field)
        end = _num(rec, "t")
        if dur is None or end is None or dur <= 0:
            continue
        parts = {bucket: dur}
        if kind in ("train/chunk", "halo/chunk", "solver/chunk"):
            comp = _num(rec, "compile_s") or 0.0
            comp = min(comp, parts["step"])
            if comp > 0:
                parts = {"step": parts["step"] - comp, "compile": comp}
        elif kind == "serve/tick":
            cc = ((_num(rec, "decode_compiles") or 0.0)
                  + (_num(rec, "prefill_compiles") or 0.0))
            ticked = cc > 0 if seen_cc is None else cc != seen_cc
            seen_cc = cc
            if ticked:
                parts = {"compile": parts.pop("step")}
        if kind == "train/chunk":
            steps += int(_num(rec, "steps") or 0)
            tk = _num(rec, "tokens")
            if tk is None:
                rate, cs = _num(rec, "tokens_per_s"), _num(rec, "chunk_s")
                tk = rate * cs if rate is not None and cs is not None else 0
            tokens += int(tk)
        intervals.append((end - dur, end, parts, dur))
    return intervals, steps, tokens


def _account_slices(events: Sequence[dict],
                    slices: Sequence[tuple[float, float]]) -> GoodputReport:
    """One workload's report over ITS scheduling slices: every
    attributed interval is clipped to the slices (an interval spilling
    over a switch boundary only books the part inside — the rest of
    that wall belongs to whoever held the mesh), overlaps clipped
    earliest-claim-first, the remainder ``other`` — buckets sum to the
    slice wall exactly, by the same construction as the whole-stream
    report."""
    wall = math.fsum(e - s for s, e in slices)
    intervals, steps, tokens = _parse_intervals(events)
    pieces = []
    for start, end, parts, dur in intervals:
        for s, e in slices:
            cs, ce = max(start, s), min(end, e)
            if ce > cs:
                pieces.append((cs, ce, parts, dur))
    pieces.sort(key=lambda p: p[0])
    buckets = {k: 0.0 for k in BUCKETS}
    cursor = None
    for cs, ce, parts, dur in pieces:
        s = cs if cursor is None else max(cs, cursor)
        if ce <= s:
            continue
        frac = (ce - s) / dur
        for b, v in parts.items():
            buckets[b] += v * frac
        cursor = ce if cursor is None else max(cursor, ce)
    attributed = sum(buckets.values())
    if attributed > wall > 0:
        scale = wall / attributed
        buckets = {k: v * scale for k, v in buckets.items()}
        attributed = wall
    buckets["other"] = max(wall - attributed, 0.0)
    return GoodputReport(wall_s=wall, buckets=buckets, steps=steps,
                         tokens=tokens)


def by_workload(events: Sequence[dict], *,
                targets: Optional[dict] = None) -> WorkloadGoodput:
    """Split one (co-scheduled) event stream into per-workload goodput
    reports, keyed on the ``workload=`` tag
    ``runtime.chunked.WorkloadSink`` stamps.

    With ``sched/switch`` events present, the scheduler's arbitration
    window [first switch, ``sched/run``] is cut into slices — each
    switch opens the named workload's slice, closed by the next switch
    — and every workload is accounted ONLY inside its own slices, so
    the per-workload walls partition the scheduler wall exactly
    (:meth:`WorkloadGoodput.check`).  Without switches (solo or
    back-to-back runs in one stream), each workload accounts its own
    event window and the walls sum.  ``targets`` (workload -> intended
    share) defaults to the ``sched/run`` event's ``targets`` field when
    the policy published one; it feeds the ``table()`` ``share_err``
    column."""
    sw = [r for r in events
          if r.get("event") == "sched/switch"
          and _num(r, "t") is not None and isinstance(r.get("workload"), str)]
    sw.sort(key=lambda r: _num(r, "t"))
    runs = [r for r in events if r.get("event") == "sched/run"]
    run_ev = runs[-1] if runs else None
    if targets is None and run_ev is not None:
        tg = run_ev.get("targets")
        if isinstance(tg, dict):
            targets = {str(k): float(v) for k, v in tg.items()}
    if not sw:
        # no arbitration in the stream: account each workload over its
        # own window (the back-to-back solo baseline)
        names: list[str] = []
        for rec in events:
            w = rec.get("workload")
            if isinstance(w, str) and w not in names:
                names.append(w)
        reports = {}
        for name in names:
            w_, b, s, t = _account_group(
                [r for r in events if r.get("workload") == name])
            reports[name] = GoodputReport(wall_s=w_, buckets=b, steps=s,
                                          tokens=t)
        wall = math.fsum(r.wall_s for r in reports.values())
        return WorkloadGoodput(wall_s=wall, reports=reports, switches=0,
                               slices={k: 1 for k in reports},
                               targets=targets)
    end = _num(run_ev, "t") if run_ev is not None else None
    if end is None:
        ts = [t for t in (_num(r, "t") for r in events) if t is not None]
        end = max(ts)
    bounds = [_num(r, "t") for r in sw]
    bounds.append(max(end, bounds[-1]))
    slices: dict[str, list[tuple[float, float]]] = {}
    for i, rec in enumerate(sw):
        s, e = bounds[i], bounds[i + 1]
        if e > s:
            slices.setdefault(rec["workload"], []).append((s, e))
    reports = {}
    nslices = {}
    for name, sl in slices.items():
        reports[name] = _account_slices(
            [r for r in events if r.get("workload") == name], sl)
        nslices[name] = len(sl)
    switches = run_ev.get("switches") if run_ev is not None else None
    if not isinstance(switches, int) or isinstance(switches, bool):
        switches = max(len(sw) - 1, 0)
    return WorkloadGoodput(wall_s=bounds[-1] - bounds[0], reports=reports,
                           switches=switches, slices=nslices,
                           targets=targets)


#: the classmethod-style spelling the satellite names:
#: ``GoodputReport.by_workload(events)``
GoodputReport.by_workload = staticmethod(by_workload)
