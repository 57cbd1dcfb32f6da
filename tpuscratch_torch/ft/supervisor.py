"""The preemption supervisor: restart, restore, replay — bounded.

``mpierr.h``'s ABORT policy ends the job on the first failure; the
supervisor is the inverse contract for failures that are the STEADY
state of large runs (preempted slices, transient comm faults, flaky
checkpoint IO): catch the restartable class, back off, re-invoke — and
let the checkpoint layer's resume-from-``latest_step`` plus the
trainer's bit-identical replay contract turn "the job died" into "the
job continued".  The restart budget is the supervisor's own bounded
rung: a failure that keeps recurring past it escalates to the caller
(``RestartsExhausted``), the same discipline as ``guards``.

Events + metrics flow through ``obs``: one ``ft/restart`` per caught
failure, ``ft/run`` on completion, counters in the (optional) registry.

The twin of ``tpuscratch.ft.supervisor``. "Devices" in the elastic forms
are the ranks of a stacked mesh: on one card, a run preempted on 4
stacked ranks may resume on 2 (``train(reshard=True)`` regroups its
state), which is the JAX package's shrunk slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, TypeVar

from tpuscratch_torch.ft.chaos import Preempted
from tpuscratch_torch.ft.retry import jittered_backoff
from tpuscratch_torch.obs.metrics import MetricsRegistry
from tpuscratch_torch.obs.sink import NullSink
from tpuscratch_torch.runtime.errors import CommError

T = TypeVar("T")

#: failures worth re-invoking for, by default: preemptions (the run was
#: healthy), comm-layer faults (transient by assumption — the bounded
#: budget is what makes that assumption safe), and IO errors (flaky
#: filesystem under the checkpoint dir).  GuardFailure is deliberately
#: absent: a poisoned data stream does not heal by restarting.
RESTARTABLE = (Preempted, CommError, OSError)

#: "not passed" sentinel for supervise_program's obs kwargs — ``None``
#: is a meaningful value there (supervise's own defaults), while an
#: omitted kwarg derives from the program itself
_UNSET = object()


class RestartsExhausted(RuntimeError):
    """The restart budget is spent — chained to the last failure."""


@dataclasses.dataclass(frozen=True)
class RestartBudget:
    """How many re-invocations, and how fast: exponential backoff from
    ``backoff_s`` capped at ``max_backoff_s``, jittered deterministically
    from ``seed`` (``ft.retry.jittered_backoff`` — the same formula the
    retry policy sleeps on)."""

    max_restarts: int = 3
    backoff_s: float = 0.0
    max_backoff_s: float = 5.0
    jitter: float = 0.1
    seed: int = 0

    def delay(self, restart: int) -> float:
        return jittered_backoff(self.seed, restart - 1, self.backoff_s,
                                2.0, self.max_backoff_s, self.jitter)


def supervise(
    fn: Callable[[], T],
    *,
    budget: RestartBudget = RestartBudget(),
    restartable: tuple = RESTARTABLE,
    sink=None,
    metrics: Optional[MetricsRegistry] = None,
    recorder=None,
    log: Callable[[str], None] = lambda s: None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn()`` under the restart loop; return its result.

    ``fn`` must be RE-INVOCABLE: each call picks up where the last left
    off (the trainer does, via ``ckpt_dir`` resume — that is the whole
    design of the checkpoint layer).  Failures outside ``restartable``
    propagate immediately; restartable ones are counted, emitted as
    ``ft/restart`` events (with the ``backoff_s`` about to be slept —
    the goodput report's "restart" badput bucket), backed off, and
    re-invoked until the budget runs out (``RestartsExhausted``).
    ``recorder`` (an ``obs.trace.FlightRecorder``) additionally marks
    each restart as an instant on the flight-recorder timeline."""
    sink = sink if sink is not None else NullSink()
    metrics = metrics if metrics is not None else MetricsRegistry()
    restarts = 0
    t0 = time.perf_counter()
    while True:
        try:
            out = fn()
        except restartable as exc:
            if restarts >= budget.max_restarts:
                # a give-up is NOT a restart: fn() will not be re-invoked,
                # so neither the counter nor an ft/restart event fires
                sink.emit("ft/give_up", restarts=restarts,
                          error=f"{type(exc).__name__}: {exc}")
                sink.flush()
                raise RestartsExhausted(
                    f"restart budget {budget.max_restarts} exhausted"
                ) from exc
            restarts += 1
            metrics.counter("ft/restarts").inc()
            op = getattr(exc, "op", None) or getattr(exc, "site", None)
            log(f"supervisor restart {restarts}/{budget.max_restarts}: "
                f"{type(exc).__name__}: {exc}")
            d = budget.delay(restarts)
            if recorder is not None:
                recorder.instant("ft/restart", restart=restarts,
                                 error=type(exc).__name__)
            if d > 0:
                sleep(d)
            # emitted AFTER the backoff: duration-carrying events are
            # stamped at the END of their activity (the goodput
            # convention), so [t - backoff_s, t] is the slept window
            sink.emit(
                "ft/restart", restart=restarts,
                error=f"{type(exc).__name__}: {exc}",
                backoff_s=round(d, 6),
                **({"op": op} if op else {}),
            )
            continue
        sink.emit(
            "ft/run", restarts=restarts,
            wall_s=round(time.perf_counter() - t0, 6),
        )
        sink.flush()
        return out


def supervise_program(
    program_or_factory,
    *,
    budget: Optional[RestartBudget] = None,
    restartable: Optional[tuple] = None,
    sink=_UNSET,
    metrics=_UNSET,
    recorder=_UNSET,
    log: Callable[[str], None] = lambda s: None,
    sleep: Callable[[float], None] = time.sleep,
):
    """:func:`supervise` around a ``runtime.chunked.ChunkedProgram`` —
    the restart-loop glue the three chunked drivers used to re-plumb
    individually (each wiring its own attempt closure + sink/metrics/
    recorder kwargs through ``supervise``).

    ``program_or_factory`` is either a built program (its ``remake``
    factory provides the restart re-invocation — resumed from
    ``ckpt_dir``, chaos plan persisting across restarts) or a zero-arg
    factory returning a fresh program per attempt.  The obs kwargs
    default to the PROGRAM'S OWN sink/metrics/recorder when omitted, so
    ``supervise_program(train_program(...))`` emits its ``ft/restart``
    events into the same (workload-tagged) stream the program writes —
    pass them explicitly (``None`` included) to override.  Returns the
    completing attempt's ``run()`` result."""
    from tpuscratch_torch.runtime.chunked import ChunkedProgram  # lazy: cycle

    if isinstance(program_or_factory, ChunkedProgram):
        first = program_or_factory
        remake = first.remake
        if remake is None:
            raise ValueError(
                f"supervise_program: program {first.workload!r} has no "
                "remake factory — restarts cannot re-invoke it"
            )
    else:
        remake = program_or_factory
        first = remake()
    if sink is _UNSET:
        sink = first.sink
    if metrics is _UNSET:
        metrics = first.metrics
    if recorder is _UNSET:
        recorder = first.rec
    box = {"program": first}

    def attempt():
        program = box["program"]
        if program is None:
            program = remake()
        box["program"] = None  # consumed: a failed attempt remakes
        return program.run()

    return supervise(attempt, budget=budget or RestartBudget(),
                     restartable=(restartable if restartable is not None
                                  else RESTARTABLE),
                     sink=sink, metrics=metrics, recorder=recorder,
                     log=log, sleep=sleep)


def supervise_elastic(
    make_attempt: Callable[[list], T],
    *,
    devices_fn: Callable[[], list],
    budget: RestartBudget = RestartBudget(),
    restartable: tuple = RESTARTABLE,
    sink=None,
    metrics: Optional[MetricsRegistry] = None,
    recorder=None,
    log: Callable[[str], None] = lambda s: None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """:func:`supervise` for PREEMPTED-AND-SHRUNK capacity: each
    (re)invocation first re-queries ``devices_fn()`` for the SURVIVING
    devices and rebuilds the attempt on them via
    ``make_attempt(devices)`` — so a run that lost part of its slice
    restarts on what is left instead of failing its mesh build forever.
    A capacity change between attempts is emitted as one ``ft/elastic``
    event (and counted in ``ft/elastic_reshards``); the attempt body is
    responsible for making the shrunk resume legal (the trainer's
    ``reshard=True`` restore-time regroup)."""
    sink_ = sink if sink is not None else NullSink()
    metrics_ = metrics if metrics is not None else MetricsRegistry()
    seen = {"n": None}

    def attempt():
        devices = list(devices_fn())
        if not devices:
            raise RuntimeError("supervise_elastic: no surviving devices")
        if seen["n"] is not None and len(devices) != seen["n"]:
            metrics_.counter("ft/elastic_reshards").inc()
            sink_.emit("ft/elastic", devices=len(devices),
                       previous=seen["n"])
            log(f"elastic restart: {seen['n']} -> {len(devices)} "
                f"device(s)")
        seen["n"] = len(devices)
        return make_attempt(devices)

    return supervise(attempt, budget=budget, restartable=restartable,
                     sink=sink_, metrics=metrics_, recorder=recorder,
                     log=log, sleep=sleep)


def supervise_train_elastic(cfg, steps: int, ckpt_dir: str, *,
                            mesh_of: Optional[Callable] = None,
                            devices_fn: Optional[Callable] = None,
                            budget: RestartBudget = RestartBudget(),
                            restartable: tuple = RESTARTABLE,
                            sink=None,
                            metrics: Optional[MetricsRegistry] = None,
                            recorder=None,
                            log: Callable[[str], None] = lambda s: None,
                            sleep: Callable[[float], None] = time.sleep,
                            **train_kw):
    """The elastic ``supervise_train``: each restart rebuilds the mesh
    from the surviving ranks (``mesh_of(devices)``: ``devices`` is one
    device per rank, e.g. ``["cuda"] * 2``; default: an all-dp ``(n, 1)``
    dp x sp stacked mesh on ``devices[0]``; ``devices_fn`` defaults to
    the one card, a single rank) and resumes training on it with
    ``reshard=True`` — a preempted-and-shrunk slice continues from
    ``latest_step`` with the ZeRO moment shards regrouped onto the
    shrunk plan instead of dying on the mesh-mismatch ``CommError``.

    The data trajectory must survive the mesh change, so ``batch`` and
    ``seq`` are pinned up front: from an existing checkpoint's metadata
    when one is present, else from the INITIAL mesh's defaults — a
    shrunk restart then replays the same stream (global batch constant;
    it must stay divisible by every surviving ``|dp|``)."""
    from tpuscratch_torch.runtime import checkpoint
    from tpuscratch_torch.runtime.mesh import make_mesh, resolve_device

    if devices_fn is None:
        def devices_fn():
            return [resolve_device(None)]
    if mesh_of is None:
        def mesh_of(devices):
            return make_mesh((len(devices), 1), ("dp", "sp"), devices[0])
    train_kw.setdefault("reshard", True)
    if recorder is not None:
        train_kw.setdefault("recorder", recorder)
    if "batch" not in train_kw or "seq" not in train_kw:
        if checkpoint.latest_step(ckpt_dir) is not None:
            _, meta = checkpoint.peek_metadata(ckpt_dir)
            batch, seq = meta.get("batch"), meta.get("seq")
        else:
            first = mesh_of(list(devices_fn()))
            shape = dict(zip(first.axis_names, first.shape))
            batch = 2 * shape.get("dp", 1)
            seq = 8 * shape.get("sp", 1)
        if batch is not None:
            train_kw.setdefault("batch", batch)
        if seq is not None:
            train_kw.setdefault("seq", seq)

    from tpuscratch_torch.models.trainer import train  # lazy: avoids the cycle

    def make_attempt(devices):
        return train(mesh_of(devices), cfg, steps, ckpt_dir, **train_kw)

    return supervise_elastic(make_attempt, devices_fn=devices_fn,
                             budget=budget, restartable=restartable,
                             sink=sink, metrics=metrics,
                             recorder=recorder, log=log, sleep=sleep)


def supervise_train(mesh, cfg, steps: int, ckpt_dir: str, *,
                    budget: RestartBudget = RestartBudget(),
                    restartable: tuple = RESTARTABLE,
                    sink=None, metrics: Optional[MetricsRegistry] = None,
                    recorder=None,
                    log: Callable[[str], None] = lambda s: None,
                    sleep: Callable[[float], None] = time.sleep,
                    **train_kw):
    """:func:`supervise` around ``models.trainer.train`` — each restart
    re-invokes ``train`` with the same arguments, which resumes from
    ``latest_step(ckpt_dir)`` and replays deterministically (the
    bit-identical contract the trainer keeps).  A chaos
    plan passed via ``train_kw['chaos']`` persists ACROSS restarts, so a
    ``times``-bounded fault consumed before the preemption stays
    consumed in the replay.  A ``recorder`` is shared with the trainer
    (every restart's chunks land on ONE flight-recorder timeline, with
    the restart instants between them).  Returns
    ``(params, TrainReport)`` of the completing invocation."""
    from tpuscratch_torch.models.trainer import train_program  # lazy: cycle

    if recorder is not None:
        train_kw.setdefault("recorder", recorder)

    def factory():
        return train_program(mesh, cfg, steps, ckpt_dir, **train_kw)

    return supervise_program(factory, budget=budget,
                             restartable=restartable, sink=sink,
                             metrics=metrics, recorder=recorder,
                             log=log, sleep=sleep)
