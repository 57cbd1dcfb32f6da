"""Error-handling layer with dual policy: raise or print-and-abort.

The twin of ``tpuscratch.runtime.errors`` (plain Python, copied so that
the port imports nothing of the JAX package): the replacement for the
reference's ``mpierr.h`` / ``cuda_error_handler.h`` pair, which select
at compile time between throwing and printing then ``MPI_Abort``
(mpierr.h:30-52, cuda_error_handler.h:47-86). Here the policy is a
runtime value. Asynchronous CUDA faults surface at the next
synchronising call (``torch.cuda.synchronize``, a copy to the host), so
that is where ``guarded`` catches them.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import traceback
from enum import Enum
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


class CommError(RuntimeError):
    """A failure in the communication/runtime layer, tagged with context."""

    def __init__(self, op: str, message: str, rank: Optional[int] = None):
        self.op = op
        self.rank = rank
        self.message = message
        super().__init__(format_comm_err(op, message, rank))

    def with_op(self, op: str, rank: Optional[int] = None) -> "CommError":
        """Attach op/rank context post-hoc when the error was raised
        without it (chaos-injected faults don't know which op wraps
        them); ``guarded`` calls this on pass-through so ft retry logs
        name the actual failing op.  A non-empty existing op wins."""
        if not self.op:
            self.op = op
        if self.rank is None:
            self.rank = rank
        self.args = (format_comm_err(self.op, self.message, self.rank),)
        return self


def format_comm_err(op: str, message: str, rank: Optional[int] = None) -> str:
    """Format op + error + class, mirroring format_mpi_err_msg
    (mpierr.h:15-28), which prints both the error string and
    the error-class string."""
    where = f"[rank {rank}] " if rank is not None else ""
    return f"{where}{op}: {message}"


class ErrorPolicy(Enum):
    """RAISE = exception propagation; ABORT = print then hard-exit, the
    analogue of HANDLE_MPI_ERROR_STDERR + MPI_Abort (mpierr.h:37-43)."""

    RAISE = "raise"
    ABORT = "abort"


def _handle(exc: BaseException, op: str, policy: ErrorPolicy, rank: Optional[int]) -> None:
    if policy is ErrorPolicy.ABORT:
        print(
            format_comm_err(op, f"{type(exc).__name__}: {exc}", rank),
            file=sys.stderr,
            flush=True,
        )
        traceback.print_exc()
        # The whole-job teardown MPI_Abort performs is the launcher's job;
        # locally a nonzero hard exit is the faithful analogue.
        os._exit(1)
    raise CommError(op, f"{type(exc).__name__}: {exc}", rank) from exc


@contextlib.contextmanager
def guarded(op: str, policy: ErrorPolicy = ErrorPolicy.RAISE, rank: Optional[int] = None):
    """Context manager guarding a block of runtime/comm calls.

    Usage parity with the reference's ``MPI_(MPI_Init(...))`` wrapping of
    every call (mpierr.h:48-52):

        with guarded("mesh construction", cfg.error_policy, rank):
            mesh = make_mesh_2d(...)
    """
    try:
        yield
    except CommError as exc:
        # Already wrapped by an inner guard: don't re-wrap — but fill in
        # missing op/rank context (an injected fault raised without an op
        # picks up this guard's), and an ABORT policy must still abort
        # (MPI_Abort parity).
        exc.with_op(op, rank)
        if policy is ErrorPolicy.ABORT:
            _handle(exc, exc.op, policy, exc.rank if exc.rank is not None else rank)
        raise
    except Exception as exc:  # SystemExit/KeyboardInterrupt pass through
        _handle(exc, op, policy, rank)


def guard_call(
    fn: Callable[..., T],
    *args,
    op: Optional[str] = None,
    policy: ErrorPolicy = ErrorPolicy.RAISE,
    rank: Optional[int] = None,
    **kwargs,
) -> T:
    """Functional form: ``guard_call(torch.cuda.synchronize, op="dot")``."""
    name = op or getattr(fn, "__name__", "call")
    with guarded(name, policy, rank):
        return fn(*args, **kwargs)


def guards(op: Optional[str] = None, policy: ErrorPolicy = ErrorPolicy.RAISE):
    """Decorator form for whole entry points (each reference main() wraps its
    body in try/catch under the exceptions policy, e.g. mpi2.cpp)."""

    def deco(fn: Callable[..., T]) -> Callable[..., T]:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs) -> T:
            with guarded(op or fn.__name__, policy):
                return fn(*args, **kwargs)

        return wrapper

    return deco
