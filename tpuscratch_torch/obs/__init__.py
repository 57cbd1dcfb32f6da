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
- **report** — :func:`load_events`, the JSONL reader.

Not ported yet: ``ledger``, ``regress``, ``reqtrace`` and ``report``'s
command line.
"""

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
from tpuscratch_torch.obs.report import load_events  # noqa: F401
