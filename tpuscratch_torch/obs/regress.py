"""The bench regression gate: diff two ``bench/record.py`` artifacts.

``python -m tpuscratch_torch.obs.regress BASE.json NEW.json [--noise 0.1]``

The twin of ``tpuscratch.obs.regress``, copied, with two changes: the
card's rows (``platform == "cuda"``) keep the tight band as the TPU's do
(see :func:`noise_floor`), and the fields that only the port's rows carry
have directions (``_LOWER``'s note). It reads files only and needs no
device.

``bench/record.py --json`` appends one JSON row per measurement; this
CLI matches the two files' rows by ``(config, metric)`` (last row wins —
append-mode files carry history; corrupt/torn lines are skipped with a
warning, ``obs.report``'s loader tolerance), compares every numeric
field whose direction it knows (tokens/s up is good, p50/p99/bytes down
is good) against a fractional noise band, and **exits nonzero when
anything regressed** — the recorded trajectory as an enforceable gate instead of a
decorative table.  ``record.py --check BASE.json`` runs the same
comparison in-process right after measuring.

Direction inference is by name substring (see ``_HIGHER``/``_LOWER``);
fields with no inferable direction (platform, flops_per_token, device
counts, nested sweeps) are ignored.  A metric present in BASE but
missing from NEW is reported as ``missing`` — a warning, not a failure,
because configs legitimately skip on absent hardware (``Needs``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Iterable, Mapping, Optional

__all__ = ["CHIP_PLATFORMS", "Finding", "compare", "direction", "format_findings",
           "has_regression", "index_rows", "load_rows", "main", "noise_floor"]

#: name substrings ⇒ bigger is better
#: ("achieved" covers the ledger-derived achieved-fraction/-rate rows
#: of the overlap ablation, config 14 — checked before "_s"/"ratio"
#: could mislabel them — AND the config-12 decode-sweep roofline row's
#: ``achieved_frac``/``achieved_hbm_gbps``: the fraction of
#: peak HBM bandwidth the paged-attention sweep reaches must only go
#: up, the pin on the fused kernel the way the 0.55x byte gate pins
#: int8.  Its ``fused_speedup`` (fused Pallas kernel over the dense
#: oracle, TPU-only) rides "speedup" — up.  The row's stated
#: ``peak_hbm_gbps`` denominator is CONFIGURATION, skipped below —
#: restating the peak must not masquerade as a kernel change.)
#: ("goodput" covers the config-16 elastic-FT rows' goodput_fraction —
#: the share of wall spent on committed steps, up)
#: (the config-12 tiered-KV row: ``resident``/``users`` cover
#: ``resident_users`` — concurrent residents at fixed HBM must only go
#: up; its cost axes ride existing substrings — ``cold_hit_p99_s`` via
#: "p99", ``host_bytes_per_token`` via "bytes" — plus "cold" below so a
#: renamed cold-path field can never silently lose its direction)
#: ("decode_spec" pins the serve_decode_spec row's headline ``value``
#: — a tokens/s rate — which the "_s" substring in its METRIC NAME
#: would otherwise mislabel lower-is-better: a latent inversion that
#: only fires when the rate moves beyond noise, and then gates speedups
#: as regressions.  Targeted on purpose: a bare "spec" would drag the
#: ``spec_k`` configuration field into the comparison.)
#: (the config-17 fleet-router row: ``affinity_hit``/
#: ``affinity_token`` cover the routing-index counters — prefix-affine
#: routing finding fewer matches on the canonical mix is a regression
#: of the index; targeted on purpose, a bare "affinity" would drag the
#: ``prefill_frac_affinity_off`` CONTROL field — lower-is-better —
#: into _HIGHER, the decode_spec latent-inversion lesson.
#: ``shared``/``subpage`` cover the static sharing counters — tokens
#: served from pages instead of prefilled must only go up at a fixed
#: workload.  The row's aggregate rate rides "tokens_per"; its
#: per-class TTFT tails are pinned lower by "ttft" below, with the
#: widened _NOISE_FLOORS band.)
#: (``decode_macro`` pins the config-12 macro-decode row's headline —
#: its ``value`` is the T=16 token rate, higher; the row's static
#: dispatch fields ride the ``dispatches``/``host_sync`` _LOWER
#: entries with the tight band.)
#: (the config-19 traffic-chaos row: ``readmitted`` counts
#: replica-kill victims re-admitted through the quarantine/requeue
#: path — at a FIXED chaos plan every victim must be re-admitted, so
#: the count falling means requests started leaking into ``dropped``
#: instead; its per-class goodput fractions ride "goodput".)
_HIGHER = ("per_s", "per_sec", "gbps", "tflops", "efficiency",
           "throughput", "updates", "tokens_per", "accept", "speedup",
           "achieved", "goodput", "resident", "users", "decode_spec",
           "decode_macro", "affinity_hit", "affinity_token", "shared",
           "subpage", "readmitted")
#: name substrings ⇒ smaller is better (checked after _HIGHER)
#: (note the ordering: ``accept_len_mean`` and ``spec_speedup`` match
#: _HIGHER before "ratio"/"bytes" substrings could ever mislabel them —
#: accepted draft length and speculative speedup regress DOWNWARD;
#: ``prefill_frac`` is the prefix-sharing row's fraction of prompt
#: tokens actually prefilled and ``degraded`` counts disaggregated
#: handoffs that fell back to local prefill — both regress UPWARD.
#: The config-15 solver rows add: ``iterations``/``cycles`` — a solver
#: taking more V-cycles/CG iterations to tolerance regressed;
#: ``psum``/``ppermute`` — the communication-avoiding claims are
#: per-iteration collective COUNTS (one fused psum per pipelined-CG
#: iteration, 6/s ppermutes per s-step sweep), so a count creeping up
#: is a regression of the proof itself.  ``halo_bytes`` rides the
#: existing "bytes" substring; ``deep_speedup``/``pipelined_speedup``
#: ride "speedup"; ``comm_ratio`` (halo bytes per computed cell) rides
#: "ratio" — down.)
#: (the config-16 elastic-FT badput directions: ``checkpoint`` and
#: ``restart`` bucket SHARES — and any other badput share — regress
#: UPWARD; a lost-capacity/goodput win is their going down.  The
#: trailing ``restarts``/``checkpoint_s`` style fields ride the same
#: substrings.)
#: (``ttft`` pins the config-17 per-class time-to-first-token fields —
#: their ``_p50_s``/``_p99_s`` suffixes already match, the explicit
#: substring keeps a renamed TTFT field from losing its direction.)
#: (the config-12 macro-decode row: ``dispatches`` and
#: ``host_sync`` are the per-token orchestration costs macro-step
#: decode exists to amortize — exact engine counters over exact token
#: counts, so they keep the tight static band; a dispatches/token
#: creeping back toward 1 means the scan stopped covering the ticks.)
#: (the config-18 co-scheduling row: ``share_err`` is the
#: achieved-vs-target share error of the MeshScheduler's arbitration —
#: drifting from the policy target is a scheduler regression;
#: ``switch`` pins the per-context-switch overhead seconds.  The row's
#: aggregate/solo goodput fractions ride the existing "goodput"
#: _HIGHER entry; the raw ``switches`` COUNT is workload shape,
#: skipped.)
#: (the config-19 row's ``dropped`` is the zero-loss law as a gated
#: counter — any value above the recorded 0 is a lost request; its
#: TTFT tails ride the existing "ttft" substring + widened floor.)
#: (the config-20 overload row: ``sheds``/``shed_frac`` are
#: the load-shedding counters at a FIXED storm — deterministic on the
#: logical shed clock, so they keep the tight static band; more sheds
#: at the same storm means capacity or scheduling regressed.  The
#: per-class ``sheds_latency`` field doubles as the zero-top-shed gate:
#: recorded 0, any value above it fails.  ``retries``/``abandoned``
#: pin the retry-storm amplification — the closed loop resubmitting
#: more, or giving up on more, at the same storm is a regression.
#: ``sheds`` not a bare "shed": "shed" is a substring of "finished".)
#: (the port's own fields: config 16's ``copy_device_s_async`` — the
#: async snapshots' device seconds — named by "copy_device" so a rename
#: keeps its direction; config 12's ``bytes_per_token_fp8`` and config
#: 13's ``peak_mem_bytes`` / ``zero_state_bytes_per_rank`` ride "bytes".)
_LOWER = ("latency", "p50", "p99", "bytes", "ratio", "_s", "seconds",
          "overhead", "bubble", "crossover", "prefill_frac", "degraded",
          "iterations", "cycles", "psum", "ppermute", "checkpoint",
          "restart", "badput", "cold", "ttft", "dispatches", "host_sync",
          "share_err", "switch", "dropped", "sheds", "shed_frac",
          "retries", "abandoned", "copy_device")

#: checked BEFORE _HIGHER: the config-15 per-SWEEP collective budget
#: fields ("ppermutes_per_sweep", "halo_bytes_per_sweep") would
#: otherwise be mislabeled higher-is-better by _HIGHER's "per_s"
#: substring (meant for per-second rates) — these are costs, down.
#: (``decomp_`` pins the config-22 per-class latency-decomposition
#: bucket means: ``decomp_<bucket>_s_<class>`` — every
#: bucket second (queue wait, shed wait, handoff, kill/degrade WASTE,
#: stall remainder) is a cost at the fixed chaos workload, down.
#: Registered FIRST on purpose: the class suffix is a tenant-chosen
#: name, and a class called e.g. "throughput" would otherwise drag its
#: buckets into _HIGHER upside down.)
_LOWER_FIRST = ("per_sweep", "decomp_")
#: fields that are identity/configuration, never compared
#: (``replicas`` is the config-17 fleet size — workload shape, like dp)
#: (``switches``/``workloads`` are the config-18 arbitration shape —
#: how many context switches/jobs the policy produced at this quantum,
#: not a cost; the per-switch overhead carries the direction.  Its
#: achieved/target shares and raw walls are CONTEXT: ``share_err``
#: carries the arbitration direction and the goodput fractions carry
#: the wall story — ``share_solver``'s accidental ``_s`` substring and
#: the wall clocks must not gate; a few-ms solver share swings tens of
#: percent on the proxy with nothing regressed.)
#: (``kills``/``stalls``/``requests``/``peak_open`` are the config-19
#: chaos/workload shape — how much churn the fixed plan injected and
#: how deep the open loop ran, not costs; its raw chaos/clean walls
#: are context like config 18's — the median-of-3 token rates and the
#: direction-gated counters carry the story.  Config 20's storm wall
#: (``wall_s_storm``) and tick counts ride the same reasoning — the
#: bounded-open-queue claim is asserted in ``bench_overload``, not
#: gated here.)
_SKIP = {"config", "dp", "n_devices", "steps", "accum", "host",
         "flops_per_token", "degenerate", "peak_hbm_gbps", "replicas",
         "switches", "workloads", "share_train", "share_solver",
         "target_train", "target_solver", "wall_s_cosched",
         "wall_s_solo", "kills", "stalls", "requests", "peak_open",
         "wall_s_chaos", "wall_s_clean", "wall_s_storm",
         "ticks_storm", "ticks_clean",
         # config 22: trace/workload shape and context —
         # n_traces/waste_traces are deterministic chaos-schedule
         # counts, the walls/ticks are context like config 19's, and
         # trace_overhead_frac is HARD-gated in-config (RuntimeError
         # at >= 2%); its recorded value is often exactly 0.0 (min
         # over interleaved pairs), and a zero base would inf-trip the
         # delta on any nonzero re-measurement
         "n_traces", "waste_traces", "ticks", "wall_s_traced",
         "wall_s_untraced", "trace_overhead_frac",
         # per-class completion counts are the fixed closed-loop
         # quotas, not costs — and "completed_latency" would otherwise
         # ride the "latency" _LOWER substring upside down
         "completed_latency", "completed_batch"}

#: per-field MEASURED-noise floors (fractional band, substring-matched
#: like the direction tables; first match wins): wall-clock fields
#: swing on SAME-CODE control runs — +11.6–27.5% in the JAX package's
#: ``--check`` pairs, and a three-run control of config 12 on
#: a 1-core CPU host measured p50/p99 tails to 51%, rate ratios
#: (spec_speedup, achieved_frac) to 47%, and serve token rates to 39%
#: single-shot (the JAX harness re-measures config 12's serve rates
#: median-of-3, which pulls them inside these floors) — while every
#: STATIC field (bytes, counts, exact-counter fractions like
#: prefill_frac) sat at exactly 0.0%.  The band a field is judged
#: against is ``max(--noise, floor)`` — a floor can only WIDEN a
#: field's band, never narrow it; the static fields keep the tight
#: default, and CHIP rows (``platform`` "tpu", or "cuda" for the
#: card's) skip the floors entirely (see :func:`noise_floor`) so the
#: pinned chip trajectory is
#: never judged against CPU-proxy noise.  A REAL regression still
#: gates: the injected-regression tests drive 2x swings, past every
#: floor.
_NOISE_FLOORS = (
    ("ttft", 0.55),            # per-request tail timings (scheduler noise)
    ("p99", 0.55),             # tail percentiles, and p99/p99 ratios
    ("p50", 0.55),             # medians of the same wall-clock samples
    ("max_s", 0.55),
    ("cold_hit_p", 0.55),      # cold_hit_p50/p99 stall timings ONLY —
                               # the cold_hits COUNT is static, tight band
    ("speedup", 0.50),         # ratio of two measured rates: both runs'
    ("residency_gain", 0.50),  # noise compounds
    ("achieved", 0.50),        # measured rate over a stated peak
    ("tokens_per_s_t", 0.55),  # the macro row's per-T rates: SINGLE-
                               # STREAM windows (batch capped by the
                               # T=16 page reservation), tick walls in
                               # the 0.1-1 ms scheduler-noise regime —
                               # an idle-machine same-code pair swung
                               # tokens_per_s_t4 by 42.5% even median-
                               # of-3 (before the generic 0.40 band)
    ("tokens_per_s", 0.40),    # wall-clock token rates (median-of-3
    ("decode_spec", 0.40),     # re-measured on the serve configs)
    ("decode_macro", 0.55),    # the macro row's headline (= its T=16
                               # single-stream rate, the band above);
                               # the row's dispatch counters are
                               # static (no floor)
    ("share_err", 0.50),       # achieved-vs-target share: a ratio of
                               # measured busy walls on tiny CPU chunks
    ("switch", 0.55),          # per-switch overhead: sub-ms residuals
                               # of wall minus busy, scheduler-noise
                               # dominated on the proxy
    ("goodput", 0.40),         # goodput fractions of short CPU runs —
                               # chunk walls in the ms regime
    ("decomp_", 0.55),         # per-class bucket MEANS (config 22):
                               # wall-clock waits/work seconds in the
                               # scheduler-noise regime, same as ttft
)


#: row platforms judged as chip rows (no CPU noise floor)
CHIP_PLATFORMS = ("tpu", "cuda")


def noise_floor(name: str, platform: str = "") -> float:
    """The measured-noise floor (fraction) for a metric/field name;
    0.0 when no floor applies (the CLI ``--noise`` band rules alone).

    Floors are a CPU-PROXY discipline: they exist because the 1-core
    dev box cannot hold a wall-clock rate steady, and they must not
    leak onto chip artifacts — a real 35% chip regression has no noise
    excuse — so chip rows (``platform`` "tpu", or "cuda": the port's rows
    name the card's device type) always return 0.0 and keep the tight
    default band."""
    if platform.lower() in CHIP_PLATFORMS:
        return 0.0
    low = name.lower()
    for sub, floor in _NOISE_FLOORS:
        if sub in low:
            return floor
    return 0.0


def direction(name: str) -> Optional[str]:
    """'higher' | 'lower' | None for a metric/field name."""
    low = name.lower()
    if any(s in low for s in _LOWER_FIRST):
        return "lower"
    if any(s in low for s in _HIGHER):
        return "higher"
    if any(s in low for s in _LOWER):
        return "lower"
    return None


@dataclasses.dataclass(frozen=True)
class Finding:
    """One compared number (or one structural note)."""

    config: object
    metric: str
    field: str
    base: Optional[float]
    new: Optional[float]
    delta: Optional[float]          # (new - base) / base, sign as stored
    status: str                     # ok | regressed | improved | missing | added

    def line(self) -> str:
        tag = {"regressed": "REGRESSED", "improved": "improved",
               "missing": "MISSING", "added": "added"}.get(self.status, "ok")
        if self.base is None or self.new is None:
            return f"  {self.metric}.{self.field}: {tag}"
        pct = 100 * (self.delta or 0.0)
        return (
            f"  {self.metric}.{self.field}: {self.base:.6g} -> "
            f"{self.new:.6g} ({pct:+.1f}%) {tag}"
        )


def index_rows(rows: Iterable[dict]) -> dict[tuple, dict]:
    """{(config, metric): row} — last occurrence wins (append-mode
    artifacts carry every historical run; the newest is the state)."""
    out: dict[tuple, dict] = {}
    for row in rows:
        metric = row.get("metric")
        if metric is None:
            continue
        out[(row.get("config"), metric)] = row
    return out


def load_rows(path: str) -> dict[tuple, dict]:
    """Indexed rows of one record artifact, loaded through
    ``obs.report.load_events`` — the ONE torn-tail-tolerant JSONL
    loader: blank lines skipped, corrupt/truncated and non-object lines
    dropped with a located ``RuntimeWarning`` (stderr, for the CLI).
    The loader's ``_file`` annotation is a string field, so the
    comparison (numeric, direction-bearing fields only) never sees
    it."""
    from tpuscratch_torch.obs.report import load_events

    return index_rows(load_events([path]))


def _comparable(row: dict) -> dict[str, float]:
    """{field: value} of every direction-bearing numeric field."""
    out = {}
    for key, val in row.items():
        if key in _SKIP or key == "metric":
            continue
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        if not math.isfinite(val):
            continue
        name = row.get("metric", "") if key == "value" else key
        if direction(name) is not None:
            out[key] = float(val)
    return out


def compare(base: Mapping[tuple, dict], new: Mapping[tuple, dict],
            noise: float = 0.1) -> list[Finding]:
    """All findings, worst first.  ``noise`` is the fractional band a
    change must exceed (in the BAD direction) to count as a regression;
    symmetric for ``improved``.  Per field the band is
    ``max(noise, noise_floor(field))`` — tail/ratio-of-rates fields
    carry measured-noise floors so same-code pairs stop flagging
    (see ``_NOISE_FLOORS``)."""
    findings = []
    for key in sorted(base, key=str):
        cfg, metric = key
        if key not in new:
            findings.append(Finding(cfg, metric, "*", None, None, None,
                                    "missing"))
            continue
        b_row, n_row = base[key], new[key]
        b_num, n_num = _comparable(b_row), _comparable(n_row)
        for field in sorted(b_num):
            if field not in n_num:
                raw = n_row.get(field)
                if (isinstance(raw, float) and not math.isfinite(raw)):
                    # present but NaN/inf: the measurement degenerated —
                    # that is a failing state, not a skipped config
                    findings.append(Finding(cfg, metric, field,
                                            b_num[field], None, None,
                                            "regressed"))
                else:
                    # a renamed/dropped field must not silently disable
                    # its gate: surface it, like a whole-metric
                    # disappearance
                    findings.append(Finding(cfg, metric, field,
                                            b_num[field], None, None,
                                            "missing"))
                continue
            bv, nv = b_num[field], n_num[field]
            name = metric if field == "value" else field
            d = direction(name)
            band = max(noise, noise_floor(
                name, str(n_row.get("platform") or
                          b_row.get("platform") or "")
            ))
            if bv == 0:
                delta = 0.0 if nv == 0 else math.inf
            else:
                delta = (nv - bv) / abs(bv)
            worse = delta < -band if d == "higher" else delta > band
            better = delta > band if d == "higher" else delta < -band
            status = ("regressed" if worse
                      else "improved" if better else "ok")
            findings.append(Finding(cfg, metric, field, bv, nv, delta,
                                    status))
    for key in sorted(set(new) - set(base), key=str):
        findings.append(Finding(key[0], key[1], "*", None, None, None,
                                "added"))
    order = {"regressed": 0, "missing": 1, "improved": 2, "added": 3,
             "ok": 4}
    findings.sort(key=lambda f: (order[f.status], str(f.config), f.metric,
                                 f.field))
    return findings


def has_regression(findings: Iterable[Finding]) -> bool:
    return any(f.status == "regressed" for f in findings)


def format_findings(findings: list[Finding], noise: float) -> str:
    n_reg = sum(f.status == "regressed" for f in findings)
    n_ok = sum(f.status == "ok" for f in findings)
    n_imp = sum(f.status == "improved" for f in findings)
    lines = [
        f"regression gate (noise band ±{100 * noise:.0f}%): "
        f"{n_reg} regressed, {n_imp} improved, {n_ok} within band"
    ]
    for f in findings:
        if f.status != "ok":
            lines.append(f.line())
    if n_reg == 0 and len(lines) == 1:
        lines.append("  all compared metrics within the noise band")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuscratch_torch.obs.regress", description=__doc__
    )
    ap.add_argument("base", help="baseline record JSON (bench/record --json)")
    ap.add_argument("new", help="candidate record JSON to gate")
    ap.add_argument("--noise", type=float, default=0.1,
                    help="fractional noise band (default 0.1 = 10%%)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of a table")
    args = ap.parse_args(argv)
    findings = compare(load_rows(args.base), load_rows(args.new),
                       noise=args.noise)
    if args.json:
        rows = []
        for f in findings:
            row = dataclasses.asdict(f)
            if row["delta"] is not None and not math.isfinite(row["delta"]):
                # a 0 -> nonzero comparison carries delta=inf; None keeps
                # the artifact strict JSON (no ``Infinity`` token)
                row["delta"] = None
            rows.append(row)
        print(json.dumps(rows, allow_nan=False))
    else:
        print(format_findings(findings, args.noise))
    return 1 if has_regression(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
