"""Collapse an obs JSONL run into a summary table.

``python -m tpuscratch_torch.obs.report run.jsonl [run.h1.jsonl ...]
[--event serve/tick] [--json] [--request RID]``

The twin of ``tpuscratch.obs.report``. Reads one or more per-host sink
files (``obs.sink.Sink`` output), groups events by kind, and prints
per-event counts plus min/p50/mean/max for every numeric field — the
rank-0 "gather the per-rank numbers and print the table" step of the
reference's drivers (mpicuda3.cu:315-325), run after the fact over the
artifact instead of inside the job.

``metrics`` events (registry snapshots) are folded with
``obs.metrics.merge_snapshots`` semantics: the LAST snapshot per
(file, scope) wins — snapshots of one registry are cumulative, and
``scope`` (``Sink.emit_metrics(..., scope=registry.id)``) identifies the
registry — then the survivors merge across scopes and hosts (distinct
registries are disjoint populations: one engine per batch size in a
sweep, one trainer per run).

The command line reads files only and needs no device: its imports are
the stdlib-only ``obs.metrics`` and ``obs.trace``.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from typing import Iterable, Optional

from tpuscratch_torch.obs.metrics import merge_snapshots, percentile
from tpuscratch_torch.obs.trace import detect_stragglers, fold_phase_events

__all__ = ["load_events", "stragglers", "summarize", "decompose",
           "request_waterfall", "format_table", "main"]


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


def stragglers(events: list[dict], min_skew: float = 1.0) -> list[dict]:
    """The per-phase host-skew table from ``trace/phase`` events: for
    every phase reported by >= 2 hosts, name the slowest host, the
    fastest, and the skew ratio.  The cumulative-event fold (newest per
    (file, host, phase), same-host files take the larger total) is
    ``obs.trace.fold_phase_events`` — shared with the goodput
    straggler-wait carve-out, so the two readers always agree."""
    per_phase = fold_phase_events(events)
    return [
        {
            "phase": r.phase, "slowest": r.slowest, "fastest": r.fastest,
            "max_s": r.max_s, "min_s": r.min_s,
            # infinite skew (a 0.0-rounded fastest host) exports as None:
            # ``json.dumps`` would otherwise emit the non-standard
            # ``Infinity`` token and break strict consumers
            "skew": round(r.skew, 4) if r.skew != float("inf") else None,
        }
        for r in detect_stragglers(per_phase, min_skew=min_skew)
    ]


def summarize(events: list[dict],
              only_event: Optional[str] = None) -> dict:
    """{event kind: {"count": n, "fields": {field: stats}}} plus a
    merged ``"metrics"`` entry (cross-host merge of each file's last
    registry snapshot), a ``"stragglers"`` table (per-phase host skew
    from ``trace/phase`` events, when >= 2 hosts reported), and the
    ``"run"`` metadata events verbatim."""
    by_kind: dict[str, list[dict]] = {}
    # (file, scope) -> newest snapshot of that registry
    last_snapshot: dict[tuple, dict] = {}
    runs = []
    for rec in events:
        kind = rec.get("event", "?")
        if kind == "run":
            runs.append({k: v for k, v in rec.items()
                         if not k.startswith("_")})
            continue
        if kind == "metrics" and isinstance(rec.get("metrics"), dict):
            last_snapshot[(rec["_file"], rec.get("scope"))] = rec["metrics"]
            continue
        if kind == "trace/phase" and only_event != "trace/phase":
            # cumulative snapshots: folded by stragglers() — but an
            # explicit --event trace/phase request gets the raw stats
            continue
        if only_event is not None and kind != only_event:
            continue
        by_kind.setdefault(kind, []).append(rec)

    out: dict = {"runs": runs, "events": {}}
    # the skew table reads the whole stream, so it only belongs on the
    # unfiltered summary — an --event view must not smuggle other kinds
    skew_rows = stragglers(events) if only_event is None else []
    if skew_rows:
        out["stragglers"] = skew_rows
    for kind, recs in sorted(by_kind.items()):
        fields: dict[str, list[float]] = {}
        for rec in recs:
            for key, val in rec.items():
                if key in ("event", "t") or key.startswith("_"):
                    continue
                if isinstance(val, bool) or not isinstance(
                    val, (int, float)
                ):
                    continue
                fields.setdefault(key, []).append(float(val))
        out["events"][kind] = {
            "count": len(recs),
            "fields": {
                key: {
                    "min": min(vals),
                    "p50": percentile(vals, 50),
                    "mean": sum(vals) / len(vals),
                    "max": max(vals),
                }
                for key, vals in sorted(fields.items())
            },
        }
    if last_snapshot:
        out["metrics"] = merge_snapshots(last_snapshot.values())
    # the per-class latency decomposition (reqtrace/request events) —
    # unfiltered summaries only, same rule as the skew table
    if only_event is None:
        decomp = decompose(events)
        if decomp:
            out["decomposition"] = decomp
    return out


def decompose(events: list[dict]) -> dict:
    """Per-class latency decomposition from ``reqtrace/request`` events
    (``obs.reqtrace.ReqTracer.collect``): {class: {field: stats}} over
    every traced request's bucket seconds plus e2e/ttft — the artifact
    twin of ``ReqTracer.decomposition()`` (reservoir-bounded, live)
    rebuilt exactly from the JSONL (unbounded, post-mortem)."""
    per_cls: dict[str, dict[str, list[float]]] = {}
    for rec in events:
        if rec.get("event") != "reqtrace/request":
            continue
        fields = per_cls.setdefault(str(rec.get("cls", "")), {})
        for key, val in rec.items():
            if not key.endswith("_s") or isinstance(val, bool) \
                    or not isinstance(val, (int, float)):
                continue
            fields.setdefault(key, []).append(float(val))
    return {
        cls: {
            key: {
                "count": len(vals),
                "mean": sum(vals) / len(vals),
                "p50": percentile(vals, 50),
                "p99": percentile(vals, 99),
            }
            for key, vals in sorted(fields.items())
        }
        for cls, fields in sorted(per_cls.items())
    }


def request_waterfall(events: list[dict], rid: int) -> str:
    """One request's causal span tree as an ASCII waterfall: every
    attributed segment (attempt-grouped, submit-relative) as a scaled
    bar, every lifecycle mark on its own line, the bucket totals, and
    the exact-sum line (``sum(buckets) == e2e`` — the
    ``RequestTrace.check`` invariant, re-checked from the artifact).
    The NEWEST ``reqtrace/request`` event for ``rid`` wins (a retried
    fleet run may trace the rid twice)."""
    rec = None
    for r in events:
        if r.get("event") == "reqtrace/request" and r.get("rid") == rid:
            rec = r
    if rec is None:
        return f"no reqtrace/request event for rid {rid}"
    e2e = float(rec.get("e2e_s", 0.0))
    scale = 40.0 / e2e if e2e > 0 else 0.0
    lines = [
        f"request {rid}  class={rec.get('cls', '')!r}  "
        f"outcome={rec.get('outcome', '?')}  attempts={rec.get('attempts')}"
        f"  e2e {_fmt(e2e)} s"
        + (f"  ttft {_fmt(rec['ttft_s'])} s" if "ttft_s" in rec else "")
    ]
    segs = [tuple(s) for s in rec.get("segments", [])]
    width = max([len(str(b)) for _a, b, _t0, _t1 in segs] or [6])
    last_attempt = None
    for attempt, bucket, t0, t1 in segs:
        if attempt != last_attempt:
            lines.append(f"  attempt {attempt}:")
            last_attempt = attempt
        pad = int(round(t0 * scale))
        bar = max(1, int(round((t1 - t0) * scale)))
        lines.append(
            f"    {str(bucket).ljust(width)}  "
            f"[{_fmt(t0):>10} .. {_fmt(t1):>10}] "
            f"{' ' * pad}{'#' * bar}"
        )
    marks = [tuple(m) for m in rec.get("marks", [])]
    if marks:
        lines.append("  marks:")
        for kind, t in marks:
            lines.append(f"    {str(kind).ljust(width)}  at {_fmt(t)} s")
    lines.append("  buckets:")
    total = 0.0
    for key in sorted(k for k in rec if k.endswith("_s")
                      and k not in ("e2e_s", "ttft_s")):
        total += float(rec[key])
        lines.append(f"    {key.ljust(width + 2)}  {_fmt(rec[key])} s")
    ok = abs(total - e2e) <= 1e-5 * max(1.0, e2e) + 1e-5
    lines.append(
        f"  sum(buckets) {_fmt(total)} s == e2e {_fmt(e2e)} s: "
        f"{'exact' if ok else 'BROKEN'}"
    )
    return "\n".join(lines)


def _fmt(v: float) -> str:
    if v != v:  # nan
        return "nan"
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.3e}"
    return f"{v:.6g}"


def format_table(summary: dict) -> str:
    """The human rendering: one block per event kind, one row per
    numeric field."""
    lines = []
    for run in summary.get("runs", []):
        meta = " ".join(
            f"{k}={run[k]}" for k in sorted(run) if k not in ("event", "t")
        )
        lines.append(f"run: {meta}")
    for kind, info in summary.get("events", {}).items():
        lines.append(f"\n{kind}  (n={info['count']})")
        fields = info["fields"]
        if fields:
            width = max(len(k) for k in fields)
            lines.append(
                f"  {'field'.ljust(width)}  {'min':>12} {'p50':>12} "
                f"{'mean':>12} {'max':>12}"
            )
            for key, st in fields.items():
                lines.append(
                    f"  {key.ljust(width)}  {_fmt(st['min']):>12} "
                    f"{_fmt(st['p50']):>12} {_fmt(st['mean']):>12} "
                    f"{_fmt(st['max']):>12}"
                )
    skew_rows = summary.get("stragglers")
    if skew_rows:
        lines.append("\nstragglers (per-phase host skew, slowest first)")
        width = max(len(r["phase"]) for r in skew_rows)

        def _skew(r):
            return float("inf") if r["skew"] is None else r["skew"]

        for r in sorted(skew_rows, key=lambda r: -_skew(r)):
            skew_txt = "inf" if r["skew"] is None else f"{r['skew']:.2f}x"
            lines.append(
                f"  {r['phase'].ljust(width)}  host {r['slowest']} slowest "
                f"{_fmt(r['max_s'])} s vs host {r['fastest']} "
                f"{_fmt(r['min_s'])} s  (skew {skew_txt})"
            )
    decomp = summary.get("decomposition")
    if decomp:
        lines.append("\nper-class latency decomposition (reqtrace)")
        for cls, fields in decomp.items():
            lines.append(f"  class {cls!r}")
            width = max(len(k) for k in fields)
            lines.append(
                f"    {'field'.ljust(width)}  {'n':>6} {'mean':>12} "
                f"{'p50':>12} {'p99':>12}"
            )
            for key, st in fields.items():
                lines.append(
                    f"    {key.ljust(width)}  {st['count']:>6} "
                    f"{_fmt(st['mean']):>12} {_fmt(st['p50']):>12} "
                    f"{_fmt(st['p99']):>12}"
                )
    metrics = summary.get("metrics")
    if metrics:
        lines.append("\nmetrics (final snapshot, merged across hosts)")
        width = max(len(k) for k in metrics)
        for name, m in metrics.items():
            kind = m.get("kind", "?")
            if kind == "counter":
                detail = f"count {_fmt(m['value'])}"
            elif kind == "gauge":
                detail = (
                    f"value {_fmt(m['value'])}  "
                    f"[min {_fmt(m['min'])}, max {_fmt(m['max'])}]"
                )
            else:
                detail = (
                    f"n {m.get('count', 0)}  mean {_fmt(m.get('mean', 0.0))}"
                    f"  [min {_fmt(m.get('min', 0.0))}, "
                    f"max {_fmt(m.get('max', 0.0))}]"
                )
            lines.append(f"  {name.ljust(width)}  {kind:<9} {detail}")
    return "\n".join(lines) if lines else "no events"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuscratch_torch.obs.report", description=__doc__
    )
    ap.add_argument("paths", nargs="+", help="obs JSONL file(s)")
    ap.add_argument("--event", default=None,
                    help="only summarize this event kind")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    ap.add_argument("--request", type=int, default=None, metavar="RID",
                    help="print one traced request's span-tree waterfall "
                         "(reqtrace/request events) instead of the summary")
    args = ap.parse_args(argv)
    if args.request is not None:
        print(request_waterfall(load_events(args.paths), args.request))
        return 0
    summary = summarize(load_events(args.paths), only_event=args.event)
    if args.json:
        print(json.dumps(summary))
    else:
        print(format_table(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
