"""tpuscratch_torch.obs — observability (the twin of ``tpuscratch.obs``).

- **sink** — the per-host JSONL event sink with run metadata; every
  instrumented layer (trainer, halo driver, solver runner) writes
  through it, with the JAX package's field names.
- **metrics** — counters, gauges, histograms and reservoirs in a
  host-side registry; :func:`mesh_reduce` / :func:`mesh_span` reduce
  per-rank numbers over the stacked mesh through ``comm``; the max-min
  span merge; :class:`CompileCounter` counts builds of a step body.
- **trace** — the bounded flight recorder: spans (fenced on the given
  tensors' device) and instants, Chrome trace-event JSON, per-phase
  totals and the straggler reports.
- **goodput** — the goodput/badput partition of a run's wall time from
  its JSONL stream; the buckets sum to the wall time by construction.
- **ledger** — the communication/compute ledger of one run of a program:
  every collective it called (kind, payload, group), FLOPs from
  ``torch.utils.flop_counter``, the analytic wire-byte formulas, the KV
  byte counts and the achieved-fraction-of-roofline diff. The port has
  no HLO, so the JAX ledger's HLO parser has no counterpart.
- **report** — ``python -m tpuscratch_torch.obs.report run.jsonl``
  collapses a run's JSONL into a summary table (the per-phase straggler
  table when >= 2 hosts reported); :func:`load_events`, the JSONL reader.
- **regress** — ``python -m tpuscratch_torch.obs.regress BASE.json
  NEW.json`` diffs two ``bench/record --json`` artifacts against a noise
  band and exits nonzero on a regression (also ``bench/record --check``).
- ``runtime.profiling``'s ``Timeline``, ``Span``, ``cross_rank_span`` and
  ``annotate`` (spans over this package's flight recorder) are re-exported
  here.

Not ported yet: ``reqtrace`` (with the serving engine's hooks).

The report, regress and profiling names load on first use, so
``python -m tpuscratch_torch.obs.report`` / ``.regress`` run their
module once.
"""

import importlib

from tpuscratch_torch.obs.metrics import (  # noqa: F401
    CompileCounter,
    Counter,
    Gauge,
    Histogram,
    MeshSpan,
    MetricsRegistry,
    Reservoir,
    merge_snapshots,
    mesh_reduce,
    mesh_span,
    percentile,
    span_max_min,
)
from tpuscratch_torch.obs.sink import NullSink, Sink, open_sink  # noqa: F401
from tpuscratch_torch.obs.trace import (  # noqa: F401
    FlightRecorder,
    StragglerReport,
    detect_stragglers,
    emit_phase_totals,
    file_flight_data,
    fold_phase_events,
    merge_chrome_traces,
    mesh_straggler,
    span_stamps,
    validate_chrome_trace,
)
from tpuscratch_torch.obs.goodput import (  # noqa: F401
    BUCKETS,
    GoodputReport,
    WorkloadGoodput,
    by_workload,
    goodput_report,
)
from tpuscratch_torch.obs.ledger import (  # noqa: F401
    CollectiveOp,
    GradSyncBytes,
    KVHostTraffic,
    Ledger,
    RooflineReport,
    all_gather_wire_bytes,
    all_to_all_wire_bytes,
    analyze,
    grad_sync_wire_bytes,
    kv_cache_bytes,
    kv_host_traffic_bytes,
    kv_page_bytes,
    reduce_scatter_wire_bytes,
    ring_all_reduce_wire_bytes,
    roofline,
)

#: name -> module, loaded on first use (PEP 562)
_LAZY = {
    **{n: "tpuscratch_torch.obs.report" for n in (
        "load_events", "stragglers", "summarize", "decompose", "request_waterfall",
        "format_table")},
    **{n: "tpuscratch_torch.obs.regress" for n in (
        "Finding", "compare", "direction", "format_findings", "has_regression",
        "index_rows", "load_rows", "noise_floor")},
    **{n: "tpuscratch_torch.runtime.profiling" for n in (
        "Span", "Timeline", "annotate", "cross_rank_span")},
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
