"""Rank-aware logging with the buffer-then-single-write discipline.

The twin of ``tpuscratch.runtime.log`` (plain Python, copied so that the
port imports nothing of the JAX package).

The reference avoids interleaved stdout across ranks by accumulating into a
``std::ostringstream`` and writing once (mpi7.cpp:56-62), and
silences output entirely under ``NO_LOG`` (mpicuda2.cu:183-188). RankLogger
reproduces both: messages are prefixed with rank/coords identity, optionally
buffered and flushed as one write, and the whole logger can be disabled.
Per-rank file output keyed by grid coordinates mirrors the stencil drivers'
``<x>_<y>`` dump files (mpi-2d-stencil-subarray.cpp:60-62).
"""

from __future__ import annotations

import io
import sys
from typing import Optional, Sequence, TextIO


class RankLogger:
    def __init__(
        self,
        rank: Optional[int] = None,
        coords: Optional[Sequence[int]] = None,
        enabled: bool = True,
        buffered: bool = False,
        stream: Optional[TextIO] = None,
    ):
        self.rank = rank
        self.coords = tuple(coords) if coords is not None else None
        self.enabled = enabled
        self.buffered = buffered
        self._stream = stream if stream is not None else sys.stdout
        self._buf = io.StringIO()

    @property
    def prefix(self) -> str:
        parts = []
        if self.rank is not None:
            parts.append(f"rank {self.rank}")
        if self.coords is not None:
            parts.append("(" + ",".join(map(str, self.coords)) + ")")
        return f"[{' '.join(parts)}] " if parts else ""

    def log(self, *values) -> None:
        if not self.enabled:
            return
        line = self.prefix + " ".join(str(v) for v in values) + "\n"
        if self.buffered:
            self._buf.write(line)
        else:
            self._stream.write(line)
            self._stream.flush()

    __call__ = log

    def log0(self, *values) -> None:
        """Log only on rank 0 (the reference's root-only printouts)."""
        if self.rank in (None, 0):
            self.log(*values)

    def flush(self) -> None:
        """Single write of everything buffered (ostringstream pattern)."""
        text = self._buf.getvalue()
        if text:
            self._stream.write(text)
            self._stream.flush()
            self._buf = io.StringIO()

    def __enter__(self) -> "RankLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()


def coord_filename(coords: Sequence[int], prefix: str = "") -> str:
    """Per-rank output filename keyed by grid coordinates: '0_1', '2_2'...
    exactly as the stencil drivers name their dumps
    (mpi-2d-stencil-subarray.cpp:60-62, sample-output/0_0...2_2)."""
    return prefix + "_".join(str(c) for c in coords)
