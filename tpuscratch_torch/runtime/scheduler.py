"""The mesh co-scheduler: N chunked programs time-slicing ONE mesh.

The twin of ``tpuscratch.runtime.scheduler``. The reference repo's L0
layer is PBS/SLURM job scripts — a scheduler over SPMD programs one level
above the runtime. Here the unit of preemption is the CHUNK boundary of a
``runtime.chunked.ChunkedProgram`` — the state was just published (or
handed to the async writer, whose barrier the program drains at its own
exit), so switching workloads there is exactly as safe as a SLURM
walltime kill landing between checkpoints, minus the kill.

:class:`MeshScheduler` holds N programs and, each iteration, asks a
:class:`Policy` which one ticks next.  All programs target the SAME
card: their chunks are launched in turn from the host thread, so
interleaving ticks IS time-slicing the card; no program needs to know.
Context switches emit ``sched/switch`` events, the run summary
``sched/run``; both feed ``obs.goodput.by_workload``, which partitions
the one JSONL stream into per-workload goodput reports whose walls sum
to the scheduler's wall exactly.

Busy seconds are the host wall of a ``tick()``. On a card that is the
device time the tick launched only if the tick ends with the device
idle: every chunk ends on a host read, but an async checkpoint's
snapshot leaves its device-to-host copy running on a side stream, which
the shared compute stream waits for, so the NEXT workload's chunk would
pay for it. So the scheduler synchronizes the card at the end of each
tick, and a workload's copies are booked to that workload.

Policies (pluggable — ``pick(ready, current, run_len)``):

- :class:`RoundRobin`: equal quantum (in ticks) per workload.
- :class:`Priority`: strict priority classes, round-robin within the
  top class — a serving-burst job added mid-run with higher priority
  PREEMPTS background training at the next chunk boundary.
- :class:`GoodputShare`: deficit scheduling toward busy-second share
  targets — pick the workload furthest below its target share.

Failure handling is the supervisor's restart discipline, per entry: a
``RESTARTABLE`` failure aborts the program (its flight data files, the
async writer is abandoned-with-log), backs off, and re-invokes the
program's ``remake`` factory — which resumes from ``ckpt_dir`` and
replays bit-identically while the OTHER workloads keep ticking.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from tpuscratch_torch.ft.supervisor import RESTARTABLE, RestartBudget, RestartsExhausted
from tpuscratch_torch.obs.sink import NullSink
from tpuscratch_torch.runtime.chunked import ChunkedProgram

__all__ = ["GoodputShare", "MeshScheduler", "Priority", "RoundRobin"]


def _fence_card() -> None:
    """Wait for every stream of the current card, when one is in use."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Entry:
    """One scheduled workload: the live program + its arbitration and
    accounting state."""

    def __init__(self, name, program, remake, priority, share, budget,
                 order):
        self.name = name
        self.program = program
        self.remake = remake
        self.priority = priority
        self.share = share
        self.budget = budget
        self.order = order       # insertion order: the deterministic tie-break
        self.busy_s = 0.0        # scheduler wall spent ticking this workload
        self.ticks = 0
        self.restarts = 0
        self.last_pick = -1      # iteration this entry last ran
        self.finished = False


class RoundRobin:
    """Equal time: rotate through the ready workloads, ``quantum``
    consecutive ticks each."""

    def __init__(self, quantum: int = 1):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = quantum

    def pick(self, ready: list, current: Optional[str], run_len: int) -> str:
        names = [e.name for e in ready]
        if current in names and run_len < self.quantum:
            return current
        # least-recently-run first; insertion order breaks the tie
        return min(ready, key=lambda e: (e.last_pick, e.order)).name


class Priority:
    """Strict priority classes (higher ``priority`` wins), round-robin
    within the top class.  A higher-priority arrival preempts the
    current workload at its next chunk boundary — the serving-burst
    -over-background-training policy."""

    def __init__(self, quantum: int = 1):
        self._rr = RoundRobin(quantum)

    def pick(self, ready: list, current: Optional[str], run_len: int) -> str:
        top = max(e.priority for e in ready)
        top_ready = [e for e in ready if e.priority == top]
        cur = current if current in [e.name for e in top_ready] else None
        return self._rr.pick(top_ready, cur, run_len if cur else 0)


class GoodputShare:
    """Deficit scheduling toward busy-share targets: each pick goes to
    the ready workload FURTHEST below its normalized target share of
    the busy seconds so far.  ``targets`` maps workload name to weight
    (missing names fall back to the entry's ``share``, else 1.0);
    weights are normalized over the READY set, so a finished workload's
    share is redistributed."""

    def __init__(self, targets: Optional[dict] = None):
        self.targets = dict(targets) if targets else {}

    def _weight(self, entry) -> float:
        w = self.targets.get(entry.name)
        if w is None:
            w = entry.share if entry.share is not None else 1.0
        return max(float(w), 0.0)

    def pick(self, ready: list, current: Optional[str], run_len: int) -> str:
        total_w = sum(self._weight(e) for e in ready) or float(len(ready))
        busy = sum(e.busy_s for e in ready)

        def deficit(e):
            target = self._weight(e) / total_w
            have = (e.busy_s / busy) if busy > 0 else 0.0
            return target - have

        # max deficit wins; least-recently-run then insertion order
        # break the tie deterministically
        return max(ready, key=lambda e: (deficit(e), -e.last_pick,
                                         -e.order)).name


class MeshScheduler:
    """Co-schedule N :class:`ChunkedProgram`\\ s on one mesh.

    ``policy`` defaults to :class:`RoundRobin`.  Every tick ends with
    ``torch.cuda.synchronize()`` when a card is in use, so ``busy_s``
    holds all the device work the tick launched (module docstring).  ``sink`` receives the
    ``sched/switch``/``sched/finish``/``sched/run`` stream (untagged —
    scheduler events belong to no workload; each program keeps writing
    its OWN workload-tagged events through its own sink, normally the
    same underlying JSONL file).  ``on_tick(scheduler)`` runs after
    every tick — the mid-run arrival hook (``add`` a burst job from it).

    ``run()`` returns ``{name: result}`` of every program's
    ``finish()``.  A restartable failure in one workload restarts THAT
    workload (per-entry ``RestartBudget``) while the others keep
    ticking; past its budget, the scheduler aborts the remaining
    programs (flight data files) and raises ``RestartsExhausted``.
    """

    def __init__(self, *, policy=None, sink=None, recorder=None,
                 restartable: tuple = RESTARTABLE,
                 log: Callable[[str], None] = lambda s: None,
                 sleep: Callable[[float], None] = time.sleep,
                 on_tick: Optional[Callable[["MeshScheduler"], None]] = None):
        self.policy = policy if policy is not None else RoundRobin()
        self.sink = sink if sink is not None else NullSink()
        self.rec = recorder
        self.restartable = restartable
        self.log = log
        self.sleep = sleep
        self.on_tick = on_tick
        self.entries: dict[str, _Entry] = {}
        self.ticks = 0
        self.switches = 0
        self.current: Optional[str] = None
        self.results: dict = {}
        self._run_len = 0

    def add(self, program_or_factory, *, name: Optional[str] = None,
            priority: int = 0, share: Optional[float] = None,
            restarts: Optional[RestartBudget] = None) -> str:
        """Register a workload (mid-run arrivals welcome — the policy
        sees it at the next boundary).  ``program_or_factory`` is a
        built :class:`ChunkedProgram` or a zero-arg factory; ``name``
        defaults to the program's ``workload`` and must be unique.
        ``restarts=None`` disables per-entry restarts (a failure
        propagates)."""
        if callable(program_or_factory) and not isinstance(
                program_or_factory, ChunkedProgram):
            remake = program_or_factory
            program = remake()
        else:
            program = program_or_factory
            remake = program.remake
        name = name if name is not None else program.workload
        if name in self.entries:
            raise ValueError(f"duplicate workload {name!r}")
        self.entries[name] = _Entry(name, program, remake, priority, share,
                                    restarts, len(self.entries))
        return name

    # ---- the arbitration loop -------------------------------------------

    def _ready(self) -> list:
        return [e for e in self.entries.values() if not e.finished]

    def _restart_or_raise(self, entry: _Entry, exc: BaseException) -> None:
        entry.program.abort()
        retryable = (entry.budget is not None
                     and isinstance(exc, self.restartable)
                     and entry.remake is not None)
        if retryable and entry.restarts >= entry.budget.max_restarts:
            entry.program.sink.emit(
                "ft/give_up", restarts=entry.restarts,
                error=f"{type(exc).__name__}: {exc}")
            self._abort_others(entry.name)
            raise RestartsExhausted(
                f"{entry.name}: restart budget "
                f"{entry.budget.max_restarts} exhausted") from exc
        if not retryable:
            self._abort_others(entry.name)
            raise exc
        entry.restarts += 1
        op = getattr(exc, "op", None) or getattr(exc, "site", None)
        self.log(f"sched restart {entry.name} "
                 f"{entry.restarts}/{entry.budget.max_restarts}: "
                 f"{type(exc).__name__}: {exc}")
        d = entry.budget.delay(entry.restarts)
        if d > 0:
            self.sleep(d)
        # AFTER the backoff — duration-carrying events are end-stamped
        # (the goodput convention), so [t - backoff_s, t] is the slept
        # window, booked to THIS workload by its tagged sink
        entry.program.sink.emit(
            "ft/restart", restart=entry.restarts,
            error=f"{type(exc).__name__}: {exc}", backoff_s=round(d, 6),
            **({"op": op} if op else {}),
        )
        entry.program = entry.remake()

    def _abort_others(self, failed: str) -> None:
        for other in self.entries.values():
            if other.name != failed and other.program.started \
                    and not other.program.finished:
                other.program.abort()

    def run(self) -> dict:
        """Arbitrate until every workload finished; return their
        results by name."""
        t0 = time.perf_counter()
        try:
            while self.tick() is not None:
                pass
        except BaseException:
            self._emit_run(t0, failed=True)
            raise
        self._emit_run(t0)
        self.sink.flush()
        return self.results

    def tick(self) -> Optional[str]:
        """One arbitration step (the non-blocking form — compose the
        scheduler itself under an outer loop).  Returns the workload
        ticked, or ``None`` when all are finished.  A restartable
        failure restarts that entry in place (backoff slept here)."""
        ready = self._ready()
        if not ready:
            return None
        name = self.policy.pick(ready, self.current, self._run_len)
        entry = self.entries[name]
        if name != self.current:
            if self.current is not None:
                self.switches += 1
            self.sink.emit("sched/switch", workload=name,
                           prev=self.current, tick=self.ticks)
            self.current = name
            self._run_len = 0
        tick_t0 = time.perf_counter()
        try:
            entry.program.ensure_started()
            if not entry.program.done:
                entry.program.tick()
            if entry.program.done:
                self.results[name] = entry.program.finish()
                entry.finished = True
            _fence_card()
        except BaseException as exc:  # noqa: BLE001 — dispatched below
            entry.busy_s += time.perf_counter() - tick_t0
            entry.ticks += 1
            entry.last_pick = self.ticks
            self.ticks += 1
            self._run_len += 1
            self._restart_or_raise(entry, exc)
            return name
        entry.busy_s += time.perf_counter() - tick_t0
        entry.ticks += 1
        entry.last_pick = self.ticks
        self.ticks += 1
        self._run_len += 1
        if entry.finished:
            self.sink.emit("sched/finish", workload=name,
                           ticks=entry.ticks, busy_s=round(entry.busy_s, 6))
        if self.on_tick is not None:
            self.on_tick(self)
        return name

    def _emit_run(self, t0: float, failed: bool = False) -> None:
        wall = time.perf_counter() - t0
        busy = sum(e.busy_s for e in self.entries.values())
        fields = {
            "wall_s": round(wall, 6), "ticks": self.ticks,
            "switches": self.switches,
            "workloads": len(self.entries),
            "overhead_s": round(max(wall - busy, 0.0), 6),
            "policy": type(self.policy).__name__,
        }
        targets = self._targets()
        if targets:
            fields["targets"] = targets
        if failed:
            fields["error"] = True
        self.sink.emit("sched/run", **fields)

    def _targets(self) -> dict:
        """The policy's share targets (for the goodput arbitration
        table): GoodputShare's weights, else any per-entry shares."""
        if isinstance(self.policy, GoodputShare):
            out = {}
            for e in self.entries.values():
                out[e.name] = self.policy._weight(e)
            total = sum(out.values())
            return ({k: v / total for k, v in out.items()} if total > 0
                    else {})
        shares = {e.name: e.share for e in self.entries.values()
                  if e.share is not None}
        total = sum(shares.values())
        return ({k: v / total for k, v in shares.items()} if total > 0
                else {})
