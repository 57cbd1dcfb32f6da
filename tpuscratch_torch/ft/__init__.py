"""tpuscratch_torch.ft — fault injection, guarded training, supervision
(the twin of ``tpuscratch.ft``).

- **chaos**      — ``ChaosPlan(seed, faults)``: a seeded, deterministic
  fault injector behind hooks in the trainer, the halo driver, the
  solver runner and ``checkpoint.save``; the same firing sequence as the
  JAX package's for the same seed.
- **guards**     — ``GuardPolicy`` + the host-side escalation ladder for
  the device-side finiteness/loss-spike guard of the train steps
  (``models.transformer`` ``guard=``): skip-step → clip →
  rollback-to-last-checkpoint, each bounded and counted.
- **retry**      — ``retry(fn, policy)`` with exponential backoff,
  deterministic jitter and a wall-clock watchdog.
- **supervisor** — ``supervise(fn)`` / ``supervise_train(...)``: the
  restart loop that resumes from ``latest_step`` under a restart budget;
  ``supervise_elastic`` / ``supervise_train_elastic`` resume onto another
  stacked-mesh shape.
"""

from tpuscratch_torch.ft.chaos import (  # noqa: F401
    ChaosPlan,
    Fault,
    InjectedFault,
    Preempted,
    bind_sink,
    bind_tracer,
)
from tpuscratch_torch.ft.guards import (  # noqa: F401
    STATUS_CLIPPED,
    STATUS_OK,
    STATUS_SKIPPED,
    GuardFailure,
    GuardPolicy,
    GuardState,
)
from tpuscratch_torch.ft.retry import (  # noqa: F401
    DEFAULT_SAVE_RETRY,
    RetryPolicy,
    RetryTimeout,
    WatchdogTimeout,
    jittered_backoff,
    retry,
)
from tpuscratch_torch.ft.supervisor import (  # noqa: F401
    RestartBudget,
    RestartsExhausted,
    supervise,
    supervise_elastic,
    supervise_program,
    supervise_train,
    supervise_train_elastic,
)
