"""Bounded retry with exponential backoff, deterministic jitter, and a
wall-clock watchdog.

The generic transient-failure absorber the rest of ``ft`` builds on:
checkpoint save/restore (a flaky filesystem), ``native.hostpool``
allocation (a transiently-exhausted locked-page budget), and serve
prefill (a transient device error) all route through :func:`retry`.
Jitter is DETERMINISTIC — drawn from ``SeedSequence([seed, attempt])``,
never from wall clock — so a chaos test's retry timeline is replayable;
the watchdog abandons a stalled attempt (``attempt_timeout_s``, thread
side-car) and bounds the whole call (``timeout_s``) so a hung save can
never wedge the supervisor's restart loop.  An abandoned attempt KEEPS
RUNNING on its daemon thread — only wrap calls that tolerate a zombie
duplicate: ``checkpoint.save`` qualifies (same-step publishes are
idempotent and its overwrite asides are call-unique, so a zombie and
its retry never collide on a path), arbitrary stateful calls may not.

The twin of ``tpuscratch.ft.retry``, with the same delays for a seed.
It imports only ``runtime.errors``; logs name
the failing op via ``CommError.op`` when the exception carries one.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Optional, TypeVar

import numpy as np

T = TypeVar("T")


class RetryTimeout(TimeoutError):
    """The TOTAL wall-clock budget (``timeout_s``) ran out between
    attempts — raised chained to the last failure."""

    def __init__(self, op: str, elapsed_s: float, budget_s: float):
        self.op = op
        super().__init__(
            f"{op}: retry budget exhausted after {elapsed_s:.3f}s "
            f"(timeout {budget_s:.3f}s)"
        )


class WatchdogTimeout(TimeoutError):
    """One attempt exceeded ``attempt_timeout_s`` and was abandoned (the
    stalled call keeps running on its daemon side-car thread; its late
    result is dropped).  A ``TimeoutError`` → retryable by default."""

    def __init__(self, op: str, timeout_s: float):
        self.op = op
        super().__init__(f"{op}: attempt exceeded watchdog {timeout_s:.3f}s")


def jittered_backoff(seed: int, n: int, base_s: float, multiplier: float,
                     max_s: float, jitter: float) -> float:
    """The ONE exponential-backoff-with-deterministic-jitter formula
    (``RetryPolicy.delay`` and the supervisor's ``RestartBudget.delay``
    both route here): ``base_s * multiplier**n`` capped at ``max_s``,
    scaled by a seeded uniform draw in ``±jitter`` — a pure function of
    ``(seed, n)``, never of wall clock, so a chaos test's backoff
    timeline is replayable."""
    d = min(max_s, base_s * multiplier ** n)
    if jitter and d > 0:
        ss = np.random.SeedSequence([seed, n])
        u = float(np.random.default_rng(ss).random())  # [0, 1)
        d *= 1.0 + jitter * (2.0 * u - 1.0)
    return max(0.0, d)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: attempts, backoff curve, jitter seed, watchdogs.

    ``delay(attempt)`` is a pure function of the policy
    (:func:`jittered_backoff`), so two runs with the same policy sleep
    the same schedule (the chaos determinism contract)."""

    max_attempts: int = 3
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1                       # fraction of the delay
    seed: int = 0
    timeout_s: Optional[float] = None         # total wall budget
    attempt_timeout_s: Optional[float] = None  # per-attempt watchdog
    retryable: tuple = (Exception,)

    def delay(self, attempt: int) -> float:
        return jittered_backoff(self.seed, attempt, self.base_s,
                                self.multiplier, self.max_s, self.jitter)


#: the checkpoint-save policy the trainer and halo driver share when a
#: chaos plan is attached and the caller gave no explicit policy:
#: absorb transient IO faults fast, fail within ~a tenth of a second
DEFAULT_SAVE_RETRY = RetryPolicy(max_attempts=3, base_s=0.01, max_s=0.1)


def _call_with_watchdog(fn: Callable[[], T], timeout_s: float, op: str) -> T:
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # relayed to the caller thread
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True, name=f"ft-watchdog:{op}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise WatchdogTimeout(op, timeout_s)
    if "error" in box:
        raise box["error"]
    return box["value"]


def retry(fn: Callable[[], T], policy: RetryPolicy = RetryPolicy(), *,
          op: Optional[str] = None,
          log: Callable[[str], None] = lambda s: None,
          sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn()`` under ``policy``; return its result or re-raise the
    last failure once attempts (or the wall budget) are exhausted.

    ``op`` names the call in logs and timeout errors; an exception that
    carries its own ``.op`` (a ``CommError``, a guarded block's wrap)
    wins, so retry logs name the actual failing op, not the call site's
    guess."""
    name = op or getattr(fn, "__name__", "call")
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.max_attempts)):
        elapsed = time.monotonic() - t0
        if policy.timeout_s is not None and elapsed > policy.timeout_s:
            raise RetryTimeout(name, elapsed, policy.timeout_s) from last
        try:
            if policy.attempt_timeout_s is None:
                return fn()
            return _call_with_watchdog(fn, policy.attempt_timeout_s, name)
        except policy.retryable as exc:
            last = exc
            failing = getattr(exc, "op", None) or name
            log(
                f"retry {attempt + 1}/{policy.max_attempts} "
                f"[{failing}]: {type(exc).__name__}: {exc}"
            )
            if attempt + 1 >= policy.max_attempts:
                break
            d = policy.delay(attempt)
            if policy.timeout_s is not None:
                # never sleep past the wall budget
                d = min(d, max(0.0, policy.timeout_s -
                               (time.monotonic() - t0)))
            if d > 0 and math.isfinite(d):
                sleep(d)
    assert last is not None
    raise last
