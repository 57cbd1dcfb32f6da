"""Guarded training policy: the host half of the in-step health guard.

The device half lives INSIDE the compiled train step
(``models.transformer.train_step(..., guard=(clip_norm, spike_factor))``):
an all-axis ``comm.collectives`` reduce of the local isfinite flag (loss
and gradient — a NaN/Inf in any leaf propagates into the global grad
norm), a loss-spike check against the caller-fed reference loss, an
in-program clip of over-norm gradients, and a ``where``-select that
passes params (and optimizer state) through UNCHANGED on a skipped step
— one extra int32 status scalar out.  When no guard is requested the
step body is byte-identical to the unguarded one.

This module holds the policy knobs and the host-side escalation ladder
the trainer runs on the statuses it reads back each chunk:

    skip-step (in-program, free)        — a non-finite or spiking step
                                          applies nothing;
    clip (in-program, counted)          — an over-norm but finite step
                                          applies the clipped update;
    rollback-to-last-checkpoint (host)  — MORE than ``max_skips``
                                          consecutive skips (the
                                          tolerated streak) means the
                                          stream is poisoned, not
                                          glitched: restore and replay.

Every rung is bounded and counted: ``max_rollbacks`` exceeded raises
:class:`GuardFailure` — at that point the run needs a human, not a
policy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

#: the status vocabulary of the guarded step's extra scalar output
STATUS_OK, STATUS_CLIPPED, STATUS_SKIPPED = 0, 1, 2


class GuardFailure(RuntimeError):
    """The rollback budget is spent and steps still skip — the bounded
    end of the escalation ladder (deliberately NOT restartable by the
    supervisor: replaying a poisoned stream forever is the livelock this
    package exists to prevent)."""


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Knobs for the guarded train step + escalation ladder.

    ``clip_norm``/``spike_factor`` are compiled INTO the step (inf
    disables each check at zero cost — ``where`` against an inf
    threshold); ``max_skips``/``max_rollbacks`` bound the host ladder."""

    clip_norm: float = math.inf      # grad-norm above this → clipped
    spike_factor: float = math.inf   # loss > factor * ref_loss → skipped
    max_skips: int = 2               # consecutive skips before rollback
    max_rollbacks: int = 1           # rollbacks before GuardFailure

    def step_guard(self) -> tuple[float, float]:
        """The (clip_norm, spike_factor) pair the step builders take."""
        return (self.clip_norm, self.spike_factor)


class GuardState:
    """Counts statuses and decides escalation; one per training run."""

    def __init__(self, policy: GuardPolicy):
        self.policy = policy
        self.skips = 0
        self.clips = 0
        self.rollbacks = 0
        self.streak = 0   # CONSECUTIVE skips, carried across chunks

    def observe(self, statuses: Sequence[int]) -> bool:
        """Fold one chunk's per-step statuses in; True ⇒ the chunk must
        be rolled back (discarded, restored, replayed)."""
        need_rollback = False
        for s in statuses:
            if s == STATUS_SKIPPED:
                self.skips += 1
                self.streak += 1
                if self.streak > self.policy.max_skips:
                    need_rollback = True
            else:
                self.streak = 0
                if s == STATUS_CLIPPED:
                    self.clips += 1
        return need_rollback

    def rolled_back(self) -> None:
        """Record one rollback; raises :class:`GuardFailure` past the
        budget.  Resets the skip streak — the replay gets a fresh run at
        the ladder."""
        self.rollbacks += 1
        self.streak = 0
        if self.rollbacks > self.policy.max_rollbacks:
            raise GuardFailure(
                f"guard rolled back {self.rollbacks} times "
                f"(budget {self.policy.max_rollbacks}) and steps still "
                f"skip — {self.skips} skipped, {self.clips} clipped"
            )
