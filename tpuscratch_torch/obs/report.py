"""Reading a run's JSONL artifact back: :func:`load_events`.

The reader half of ``tpuscratch.obs.report`` that the goodput account
needs. A torn final line (a writer killed mid-flush) is skipped with a
warning, so a crashed run's surviving events still load.
"""

from __future__ import annotations

import json
import warnings
from typing import Iterable

__all__ = ["load_events"]


def load_events(paths: Iterable[str]) -> list[dict]:
    """All events from the given JSONL files, in file order.  Blank
    lines are skipped; a corrupt/truncated line is SKIPPED with a
    warning naming its location instead of failing the whole file — a
    torn final line is the normal state of an artifact whose writer was
    SIGKILLed mid-flush, and the surviving events are exactly what a
    post-mortem needs. Each event gains ``_file``, its source path."""
    events = []
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    warnings.warn(
                        f"{path}:{lineno}: skipping corrupt JSONL line "
                        f"({e.msg})",
                        RuntimeWarning, stacklevel=2,
                    )
                    continue
                if not isinstance(rec, dict):
                    warnings.warn(
                        f"{path}:{lineno}: skipping non-object JSONL line",
                        RuntimeWarning, stacklevel=2,
                    )
                    continue
                rec["_file"] = path
                events.append(rec)
    return events
