"""Seeded, deterministic fault injection — the chaos harness.

A :class:`ChaosPlan` is a pure description of WHICH faults fire WHERE
and WHEN: every firing decision is a function of ``(seed, fault, site,
occurrence index)``, so the same plan produces the same fault schedule
on every run — the property that lets a chaos test assert bit-identical
recovery instead of "it probably survived".  Instrumented layers query
the plan through small hooks (``corrupt_batch``, ``maybe_fail``,
``maybe_preempt``, ``save_hook``, ``wrap_collective``); a layer given no
plan runs zero hook code, so the uninstrumented path is unchanged — the
same contract as the obs grad-norm output.

Site vocabulary (what the instrumented layers query):

- ``"train/grad"``    — corrupt a step's batch so its gradients go
  NaN/Inf through the unmodified compiled step (``kind="nan"|"inf"``).
- ``"train/preempt"`` / ``"halo/preempt"`` / ``"solver/preempt"`` —
  simulated scheduler preemption at a chunk boundary, AFTER the save
  (``kind="preempt"``).
- ``"ckpt/save"``     — checkpoint IO: fail (``"error"``), stall
  (``"stall"``), or SIGKILL the process (``"kill"``) at a named stage
  inside :func:`runtime.checkpoint.save` (``stage=``).
- ``"ckpt/snapshot"`` — the BLOCKING device→host staging half of an
  async checkpoint (:class:`runtime.async_ckpt.AsyncCheckpointer`):
  fail/stall/SIGKILL before the copy (occurrences auto-counted per
  snapshot).
- ``"ckpt/write"``    — the BACKGROUND writer half of an async
  checkpoint: the same named-stage vocabulary as ``ckpt/save``
  (``begin``/``leaf_<i>``/``manifest``/``swap``/``publish``/``end``),
  fired from inside the writer thread's ``checkpoint.save`` — so the
  async path gets the same deterministic kill-mid-save matrix coverage
  the blocking path has.
- ``"serve/prefill"`` — fail a request's prefill admission
  (``key=rid`` targets one request; ``times`` bounds transience).
- ``"serve/replica"`` — REPLICA-scoped fleet chaos: the
  fleet router queries this site once per (fleet tick, replica) with
  ``index=tick`` and ``key=replica``.  ``kind="kill"`` tears the whole
  ``ServeEngine`` down mid-stream (``ServeEngine.evacuate``) and the
  router re-admits its in-flight + queued requests elsewhere with
  deterministic replay; ``kind="stall"`` freezes the replica (no
  ticks, no dispatches) without losing its state.  ``down_ticks``
  sizes the outage in fleet ticks before the elastic re-join
  (``None``: the router's ``rejoin_ticks`` default).  Explicit
  ``index=tick`` keeps the schedule a pure function of the plan — the
  chaos-vs-clean bit-identity runs fire at the same ticks.
  ``Fault(domain=(0, 1, 2))`` makes the clause a CORRELATED fault
  domain (replicas sharing a rack/power feed/switch): one
  seeded ignition at an occurrence index fires the clause for EVERY
  key in the domain at that index, consuming ONE ``times`` budget per
  ignition rather than one per member — a rack dies whole, in the
  same fleet tick, off one draw.
- ``"comm/<op>"``     — a transient :class:`InjectedFault` (a
  ``CommError``) raised from a collective wrapper around a compiled
  program (:meth:`ChaosPlan.wrap_collective`); the chunked drivers
  query ``comm/halo_chunk`` / ``comm/solver_chunk`` before each
  compiled chunk.

The reference has nothing to compare: its faults all funnel into
``MPI_Abort`` (mpierr.h:37-43).  This module is the part of fault
tolerance the reference could not even test — injecting the failure on
purpose, deterministically.

The twin of ``tpuscratch.ft.chaos``: the same draws (numpy and
``zlib``), so a plan fires at the same places in both packages.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
import zlib
from typing import Callable, Optional, Sequence

import numpy as np

from tpuscratch_torch.obs.sink import NullSink
from tpuscratch_torch.runtime.errors import CommError


class Preempted(RuntimeError):
    """A (simulated or real) scheduler preemption: the run must stop NOW
    and be re-invoked — the supervisor's restartable signal."""

    def __init__(self, site: str, index: Optional[int] = None):
        self.site = site
        self.index = index
        super().__init__(f"preempted at {site}"
                         + (f" (index {index})" if index is not None else ""))


class InjectedFault(CommError):
    """A chaos-injected transient failure.  A ``CommError`` so the
    raise-vs-abort policy layer and the supervisor's restartable set both
    treat it like a real comm-layer fault; constructed WITHOUT an op when
    the injection site doesn't know which op wraps it — ``guarded``
    attaches the name (``CommError.with_op``) so retry logs name the
    failing op."""


def bind_sink(plan: Optional["ChaosPlan"], sink) -> None:
    """Point ``plan``'s ``ft/fault`` events at the instrumented layer's
    sink — the one binding rule trainer and halo driver share: only an
    unbound plan (still on the NullSink) is rebound, and only to an
    enabled sink, so a caller-chosen sink is never overridden."""
    if plan is not None and isinstance(plan.sink, NullSink) and sink.enabled:
        plan.sink = sink


def bind_tracer(plan: Optional["ChaosPlan"], tracer) -> None:
    """The ``bind_sink`` rule for the per-request tracer
    (:mod:`tpuscratch_torch.obs.reqtrace`): a rid-keyed firing then drops a
    ``fault`` mark into that request's span tree, so an injected
    handoff/prefill fault shows up INSIDE the victim's causal trace
    rather than only in the fleet-wide ``ft/fault`` stream.  Only an
    unbound plan is rebound, and only to an enabled tracer."""
    if plan is not None and plan.tracer is None and tracer is not None \
            and tracer.enabled:
        plan.tracer = tracer


@dataclasses.dataclass
class Fault:
    """One fault clause of a plan.

    ``at`` names explicit occurrence indices (a step number, a save
    count, a per-rid attempt index — whatever the site passes); ``p``
    instead fires at a seeded rate per occurrence.  ``times`` bounds the
    TOTAL number of firings (``None`` = unlimited: a deterministic,
    never-healing fault — the quarantine test case); ``key`` restricts
    the clause to one site key (e.g. a request rid, a replica index);
    ``stage`` restricts ``ckpt/save`` clauses to one named stage inside
    ``save``.  ``down_ticks`` sizes a ``serve/replica`` outage in fleet
    ticks (the tick-denominated twin of ``stall_s``: replica chaos is
    scheduled in ticks so the fault matrix stays deterministic, not
    wall-clocked).  ``domain`` is the CORRELATED twin of ``key``: the
    clause matches every key in the group, and one ignition at an
    occurrence index fires for ALL of them at that index off a single
    ``times`` budget — the rack / power-feed / switch failure unit.
    ``key`` and ``domain`` are mutually exclusive.
    """

    site: str
    at: Optional[Sequence[int]] = None   # explicit occurrence indices
    p: float = 0.0                       # else: seeded firing rate
    times: Optional[int] = 1             # firing budget; None = unlimited
    key: Optional[int] = None            # site key selector (e.g. rid)
    kind: str = "error"                  # error | nan | inf | stall | preempt | kill
    stage: Optional[str] = None          # ckpt/save stage selector
    stall_s: float = 0.0                 # sleep length for kind="stall"
    down_ticks: Optional[int] = None     # serve/replica outage length
    domain: Optional[Sequence[int]] = None  # correlated key group (a rack)

    def __post_init__(self):
        if self.key is not None and self.domain is not None:
            raise ValueError("Fault: key and domain are mutually exclusive")


def rack_domains(n_replicas: int, rack_size: int) -> tuple[tuple[int, ...], ...]:
    """Partition ``range(n_replicas)`` into contiguous racks of
    ``rack_size`` — the conventional domain layout for ``Fault(domain=)``
    clauses (the last rack may be short)."""
    if rack_size <= 0:
        raise ValueError("rack_domains: rack_size must be positive")
    return tuple(
        tuple(range(lo, min(lo + rack_size, n_replicas)))
        for lo in range(0, n_replicas, rack_size)
    )


class ChaosPlan:
    """A deterministic fault schedule over the site vocabulary.

    Occurrence indices are either passed explicitly by the site (the
    trainer passes the global step, so a rolled-back replay re-queries
    the SAME indices and a ``times``-exhausted fault stays consumed — the
    recover-then-bit-identical property) or auto-counted per
    ``(site, stage, key)`` when the site has no natural index (checkpoint
    saves, prefill attempts).

    ``sink`` (an ``obs.sink.Sink``) receives one ``ft/fault`` event per
    firing; instrumented layers bind their sink onto the plan so injected
    faults land in the same JSONL stream as the recovery events.
    """

    def __init__(self, seed: int, faults: Sequence[Fault] = (), sink=None):
        self.seed = int(seed)
        self.faults = tuple(faults)
        self._left = [f.times for f in self.faults]
        self._occ: dict = {}
        self._domain_fired: set = set()  # (fault_i, index) ignitions
        self.fired: dict[str, int] = {}
        self.sink = sink if sink is not None else NullSink()
        self.tracer = None  # bound via bind_tracer (obs.reqtrace)

    # ---- the schedule --------------------------------------------------

    def _rate_fires(self, fault_i: int, site: str, index: int) -> bool:
        """Pure function of (seed, fault, site, index) — the determinism
        contract: no call-order state feeds the draw."""
        ss = np.random.SeedSequence(
            [self.seed, fault_i, zlib.crc32(site.encode()), int(index)]
        )
        return float(np.random.default_rng(ss).random()) < self.faults[fault_i].p

    def should_fire(self, site: str, index: Optional[int] = None,
                    key: Optional[int] = None,
                    stage: Optional[str] = None) -> Optional[Fault]:
        """First matching, unexhausted clause that fires at this
        occurrence — consumed from its ``times`` budget — or ``None``.
        ``index=None`` auto-counts occurrences per (site, stage, key).
        A ``domain`` clause consumes ONE budget unit per (clause, index)
        ignition: the first domain member seen at an index pays; later
        members at the same index fire free (even past exhaustion), so
        every replica in the rack dies off the same draw."""
        if index is None:
            occ_key = (site, stage, key)
            index = self._occ.get(occ_key, 0)
            self._occ[occ_key] = index + 1
        for i, f in enumerate(self.faults):
            if f.site != site:
                continue
            if f.key is not None and key != f.key:
                continue
            if f.domain is not None and key not in tuple(f.domain):
                continue
            if f.stage is not None and stage != f.stage:
                continue
            ignited = f.domain is not None and (i, index) in self._domain_fired
            if self._left[i] == 0 and not ignited:
                continue
            if f.at is not None:
                fires = index in tuple(f.at)
            else:
                fires = f.p > 0 and self._rate_fires(i, site, index)
            if not fires:
                continue
            if not ignited:
                if self._left[i] is not None:
                    self._left[i] -= 1
                if f.domain is not None:
                    self._domain_fired.add((i, index))
            self.fired[site] = self.fired.get(site, 0) + 1
            self.sink.emit(
                "ft/fault", site=site, index=index, kind=f.kind,
                **({"key": key} if key is not None else {}),
                **({"stage": stage} if stage is not None else {}),
            )
            if (self.tracer is not None and key is not None
                    and site != "serve/replica"
                    and site.startswith(("serve/", "comm/"))):
                # rid-keyed serve-path sites only (serve/replica keys on
                # the REPLICA index, which could collide with a rid);
                # the tracer drops marks for rids it is not following
                self.tracer.mark(key, "fault", time.perf_counter(),
                                 site=site, fault=f.kind)
            return f
        return None

    def stats(self) -> dict[str, int]:
        """{site: firings so far} — the sweep bench's injected-fault count."""
        return dict(self.fired)

    # ---- the hooks instrumented layers call ----------------------------

    def corrupt_batch(self, x, step: int):
        """Return ``x`` with one poisoned element when a ``train/grad``
        clause fires at ``step`` — NaN (or Inf) flows through the
        UNMODIFIED compiled step into the loss and every gradient leaf,
        which is exactly what the device-side guard must catch."""
        f = self.should_fire("train/grad", index=step)
        if f is None:
            return x
        x = x.clone()
        x[(0,) * x.ndim] = math.inf if f.kind == "inf" else math.nan
        return x

    def maybe_fail(self, site: str, index: Optional[int] = None,
                   key: Optional[int] = None, op: str = "") -> None:
        """Raise an :class:`InjectedFault` (or stall, or hard-kill) when a
        clause fires.  ``stall`` sleeps and RETURNS — the call proceeds;
        the watchdog in ``ft.retry`` is what turns a stall into a
        failure."""
        f = self.should_fire(site, index=index, key=key)
        if f is None:
            return
        if f.kind == "stall":
            time.sleep(f.stall_s)
            return
        if f.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if f.kind == "preempt":
            raise Preempted(site, index)
        raise InjectedFault(op, f"injected {f.kind} fault at {site}")

    def maybe_preempt(self, site: str = "train/preempt",
                      index: Optional[int] = None) -> None:
        """Raise :class:`Preempted` when a clause fires — called at chunk
        boundaries AFTER the save, so the restarted run resumes exactly
        where the preempted one stopped."""
        if self.should_fire(site, index=index) is not None:
            raise Preempted(site, index)

    def stage_hook(self, site: str) -> Callable[[str], None]:
        """A ``checkpoint.save(hook=...)``-shaped adapter for ``site``:
        each named stage queries a clause of that site (occurrences
        auto-counted PER STAGE, so ``Fault(stage="publish", at=(1,))``
        means "the second occurrence's publish point").  ``ckpt/save``
        is the blocking save path's site; ``ckpt/write`` the async
        background writer's — same stage vocabulary, separately
        injectable."""

        def hook(stage: str) -> None:
            f = self.should_fire(site, stage=stage)
            if f is None:
                return
            if f.kind == "stall":
                time.sleep(f.stall_s)
                return
            if f.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise OSError(f"injected checkpoint IO failure at {stage!r}")

        return hook

    def save_hook(self) -> Callable[[str], None]:
        """:meth:`stage_hook` bound to the blocking ``ckpt/save`` site."""
        return self.stage_hook("ckpt/save")

    def wrap_collective(self, fn, op: str):
        """Wrap a compiled program (host-level): each call first queries
        ``comm/<op>`` — a firing raises a transient :class:`InjectedFault`
        carrying the op name, the fault class ``mpierr.h`` could only
        abort on and the supervisor now restarts through."""
        site = f"comm/{op}"

        def wrapped(*args, **kwargs):
            self.maybe_fail(site, op=op)
            return fn(*args, **kwargs)

        return wrapped
