"""Tracing / profiling: spans, cross-rank wall-time, ``torch.profiler`` hooks.

The twin of ``tpuscratch.runtime.profiling``. The reference's
instrumentation is manual wall-clock spans — clock() begin/end gathered
to rank 0 with the max-min convention (mpicuda3.cu:176-179,315-325),
MPI_Wtime segment timing separating network from copy
(mpi-pingpong-gpu.cpp:51-57), and a carve-out for one-time setup cost
(NO_GPU_MALLOC_TIME, mpicuda3.cu:221-240). This module keeps those
conventions and adds what the CUDA runtime offers beyond them:

- ``Timeline.span``: a named, nestable wall-clock bracket that
  synchronizes the devices of the tensors it is given on entry
  (``obs.trace.FlightRecorder``'s bracket), so queued kernels cannot leak
  into the span; the body fences its own results.
- ``cross_rank_span`` merges per-rank timelines with max(end)-min(begin).
- ``trace``: a ``torch.profiler`` bracket (CPU and, with a card, CUDA
  activity: the device timeline CUPTI records, kernel names included —
  also those launched through ``ctypes``, as the hand-written kernels
  are) written as a Chrome trace file — the part clock() could never see.
- ``annotate``: a named region on that timeline
  (``torch.profiler.record_function``).

The merge conventions live in ``obs.metrics`` (``span_max_min``); the obs
modules are imported inside the functions, because ``obs`` re-exports
this module's names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import warnings
from typing import Iterator, Optional

__all__ = ["ProfileTrace", "Span", "Timeline", "annotate", "cross_rank_span", "trace"]


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    begin: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.begin


class Timeline:
    """Per-process span collector (one per rank; merge via
    :func:`cross_rank_span`). A thin delegate over
    ``obs.trace.FlightRecorder``, the one span implementation: every span
    also lands in ``self.recorder``'s ring (pass a shared recorder to
    pool several layers' spans into one Chrome trace), while
    ``self.spans`` keeps the per-collector list the merge helpers read."""

    def __init__(self, recorder=None) -> None:
        from tpuscratch_torch.obs.trace import FlightRecorder

        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.spans: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, *sync) -> Iterator[None]:
        """Wall-clock bracket. The devices of any ``sync`` tensors are
        synchronized at entry so queued work cannot leak into the span.
        Mirrors the recorder's span into
        ``self.spans``, on the exception path too."""
        ev = self.recorder.open_span(name, sync=sync)
        try:
            yield
        finally:
            self.recorder.close_span(ev)
            self.spans.append(Span(name, ev.begin, ev.end))

    def seconds(self, name: str) -> float:
        """Total time across spans with this name."""
        total = sum(s.seconds for s in self.spans if s.name == name)
        if not any(s.name == name for s in self.spans):
            raise KeyError(name)
        return total

    def report(self) -> str:
        lines = [f"{s.name}: {s.seconds * 1e3:.3f} ms" for s in self.spans]
        return "\n".join(lines)


def cross_rank_span(timelines: list[Timeline], name: str) -> float:
    """max(end) - min(begin) for ``name`` across per-rank timelines — the
    mpicuda3 convention as a pure function over collected spans."""
    from tpuscratch_torch.obs.metrics import span_max_min

    begins, ends = [], []
    for tl in timelines:
        for s in tl.spans:
            if s.name == name:
                begins.append(s.begin)
                ends.append(s.end)
    return span_max_min(begins, ends)


@dataclasses.dataclass
class ProfileTrace:
    """What a :func:`trace` bracket wrote: ``path`` is the Chrome trace
    file, set when the bracket closes; None while it runs, or when the
    profiler could not start or export (it warned instead)."""

    logdir: str
    path: Optional[str] = None


_trace_ids = itertools.count()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[ProfileTrace]:
    """``torch.profiler`` trace around a block of work, written to
    ``logdir`` as a Chrome trace-event JSON file (``trace_<pid>_<n>.json``,
    readable by Perfetto and by ``json``). Records CPU activity, and CUDA
    activity when a card is present.

    A profiler that cannot start (or cannot write its file) degrades the
    bracket to a no-op with a warning instead of killing the instrumented
    run: profiling must never be the thing that takes serving down."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = ProfileTrace(logdir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        warnings.warn(f"torch.profiler failed to start ({e}); runtime.profiling.trace "
                      "degraded to a no-op span", RuntimeWarning, stacklevel=3)
        yield out
        return
    try:
        yield out
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_trace_ids)}.json")
        try:
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(path)
            out.path = path
        except Exception as e:
            warnings.warn(f"torch.profiler trace export to {path} failed ({e})",
                          RuntimeWarning, stacklevel=3)


def annotate(name: str):
    """Named region visible in profiler timelines
    (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    return record_function(name)
