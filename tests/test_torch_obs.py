"""The port's observability package (``tpuscratch_torch.obs``) against the
JAX package's: the same calls on the same inputs give the same results —
JSONL sink lines (the time stamp ``t`` excepted), metric snapshots, the
seeded ``Reservoir`` draws, flight-recorder spans under an injected clock,
Chrome-trace export and validation, the phase fold, straggler reports,
``goodput_report`` and ``by_workload`` on one event list — and
``mesh_reduce`` / ``mesh_span`` / ``mesh_straggler`` on 4 stacked ranks
against the 4-device CPU mesh (both reduce in f32: equal values)."""

import itertools
import json
import time

import jax
import numpy as np
import pytest
import torch

from tpuscratch import obs as jobs
from tpuscratch.obs import goodput as jgoodput
from tpuscratch.obs import metrics as jmetrics
from tpuscratch.obs import trace as jtrace
from tpuscratch.obs.report import load_events as jload
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch import obs as tobs
from tpuscratch_torch.obs import goodput as tgoodput
from tpuscratch_torch.obs import metrics as tmetrics
from tpuscratch_torch.obs import trace as ttrace
from tpuscratch_torch.obs.report import load_events as tload
from tpuscratch_torch.runtime.mesh import make_mesh

torch.set_num_threads(1)


def _lines(path):
    """A JSONL file's records without the time stamp and the recorder's
    per-process ``scope`` salt."""
    out = []
    for ln in open(path):
        rec = json.loads(ln)
        rec.pop("t")
        rec.pop("scope", None)
        out.append(rec)
    return out


def test_sink_lines_match(tmp_path):
    for pkg, mod in (("jax", jobs), ("port", tobs)):
        with mod.open_sink(str(tmp_path / f"{pkg}.jsonl"), run={"who": "x"}, host=0,
                           flush_every=2) as s:
            s.emit("train/chunk", step=3, loss=0.5)
            s.emit_metrics({"a": {"kind": "counter", "value": 2}}, scope="r1")
            s.emit("halo/run", cells=[1, 2])
        with mod.open_sink(str(tmp_path / f"{pkg}.jsonl"), host=3) as s:
            s.emit("x", v=1)
    assert _lines(tmp_path / "jax.jsonl") == _lines(tmp_path / "port.jsonl")
    assert _lines(tmp_path / "jax.h3.jsonl") == _lines(tmp_path / "port.h3.jsonl")
    ev_j = jload([str(tmp_path / "jax.jsonl")])
    ev_t = tload([str(tmp_path / "port.jsonl")])
    assert [e["event"] for e in ev_j] == [e["event"] for e in ev_t]
    assert isinstance(tobs.open_sink(None), tobs.NullSink)


def test_sink_rotation_matches(tmp_path, monkeypatch):
    # a fixed clock: a line's length (so where a segment ends) must not
    # depend on how many digits its time stamp takes
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    for pkg, mod in (("jax", jobs), ("port", tobs)):
        with mod.Sink(str(tmp_path / f"{pkg}.jsonl"), flush_every=1, rotate_bytes=200,
                      max_segments=2) as s:
            for i in range(20):
                s.emit("e", i=i, pad="x" * 30)
        assert (tmp_path / f"{pkg}.jsonl.2").exists()
    for suffix in ("", ".1", ".2"):
        assert _lines(tmp_path / f"jax.jsonl{suffix}") == _lines(tmp_path / f"port.jsonl{suffix}")


def _exercise(mod):
    reg = mod.MetricsRegistry()
    for i in range(50):
        reg.counter("c").inc(i % 3)
        reg.gauge("g").set(np.sin(i))
        reg.histogram("h").observe(float(i * i % 17))
        reg.reservoir("r").observe(float(i))
    snap = reg.snapshot()
    res = mod.Reservoir(k=8, seed=5)
    for i in range(1000):
        res.observe(float(i))
    return snap, res.snapshot(), sorted(res._samples) if hasattr(res, "_samples") else None


def test_metric_snapshots_and_reservoir_draws_match():
    js, jr, jsamples = _exercise(jmetrics)
    ts, tr, tsamples = _exercise(tmetrics)
    assert js == ts and jr == tr and jsamples == tsamples
    assert jmetrics.merge_snapshots([js, js]) == tmetrics.merge_snapshots([ts, ts])
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]
    for q in (0, 50, 90, 99, 100):
        assert jmetrics.percentile(xs, q) == tmetrics.percentile(xs, q)
    assert jmetrics.span_max_min([1, 2], [4, 3]) == tmetrics.span_max_min([1, 2], [4, 3])


def test_compile_counter_counts_builds():
    c = tobs.CompileCounter()
    build = c.wrap(lambda k: (lambda x: x + k))
    step = build(1)
    assert [step(i) for i in range(3)] == [1, 2, 3] and c.count == 1


def _record(mod):
    clock = itertools.count(0, 0.25).__next__
    rec = mod.FlightRecorder(capacity=6, clock=clock)
    for i in range(4):
        with rec.span("train/chunk", step=i):
            rec.instant("mark", i=i)
        sp = rec.open_span("ckpt/save", step=i)
        rec.close_span(sp)
    with rec.span("open/then/closed"):
        pass
    return rec


def test_flight_recorder_trace_and_phase_totals_match(tmp_path):
    jr, tr = _record(jtrace), _record(ttrace)
    jt, tt = jr.chrome_trace(pid=1, label="h"), tr.chrome_trace(pid=1, label="h")
    assert jt == tt and jr.dropped == tr.dropped > 0
    assert jtrace.validate_chrome_trace(jt) == ttrace.validate_chrome_trace(tt) > 0
    merged = (jtrace.merge_chrome_traces({0: jt, 2: jt}), ttrace.merge_chrome_traces({0: tt, 2: tt}))
    assert merged[0] == merged[1]
    assert ttrace.validate_chrome_trace(merged[1]) == jtrace.validate_chrome_trace(merged[0])
    assert {k: vars(v) for k, v in jr.phase_totals().items()} == \
        {k: vars(v) for k, v in tr.phase_totals().items()}
    assert jtrace.span_stamps(jr, "ckpt/save") == ttrace.span_stamps(tr, "ckpt/save")
    bad = json.loads(json.dumps(tt))
    bad["traceEvents"] = [e for e in bad["traceEvents"] if e.get("ph") != "E"]
    with pytest.raises(ValueError):
        ttrace.validate_chrome_trace(bad)
    for pkg, mod, rec in (("jax", jobs, jr), ("port", tobs, tr)):
        with mod.Sink(str(tmp_path / f"{pkg}.jsonl")) as s:
            mod.emit_phase_totals(s, rec)
    assert _lines(tmp_path / "jax.jsonl") == _lines(tmp_path / "port.jsonl")


def test_open_span_fences_tensors():
    rec = tobs.FlightRecorder()
    x = torch.ones(4)
    sp = rec.open_span("s", sync=[x, {"a": [x]}])
    assert rec.close_span(sp).seconds >= 0


def _events():
    """One stream of every duration-carrying event kind, two hosts' phase
    totals, two workloads, a resumed session (a second ``run`` line)."""
    ev = [{"event": "run", "t": 0.0, "host": 0, "_file": "a"}]
    t = 0.0
    for i in range(6):
        t += 1.0
        wl = "train" if i % 2 else "halo"
        ev.append({"event": f"{wl}/chunk", "t": t, "chunk_s": 0.8, "wall_s": 0.8,
                   "compile_s": 0.3 if i < 2 else 0.0, "steps": 2, "tokens": 64,
                   "workload": wl, "_file": "a"})
        t += 0.2
        ev.append({"event": "ckpt/save", "t": t, "wall_s": 0.15, "workload": wl, "_file": "a"})
    ev.append({"event": "ft/restart", "t": t + 0.5, "backoff_s": 0.4, "workload": "train",
               "_file": "a"})
    ev.append({"event": "ft/rollback", "t": t + 1.0, "lost_s": 0.3, "workload": "train",
               "_file": "a"})
    ev.append({"event": "ckpt/snapshot", "t": t + 1.2, "wall_s": 0.05, "workload": "halo",
               "_file": "a"})
    ev.append({"event": "ckpt/write", "t": t + 1.4, "wall_s": 0.5, "workload": "halo",
               "_file": "a"})
    for host, secs in ((0, 1.0), (1, 1.6)):
        ev.append({"event": "trace/phase", "t": t + 2, "host": host, "phase": "train/chunk",
                   "seconds": secs, "count": 3, "_file": f"h{host}"})
    ev.append({"event": "run", "t": 0.0, "host": 0, "_file": "a"})
    ev.append({"event": "train/chunk", "t": 2.0, "chunk_s": 1.5, "compile_s": 0.0, "steps": 1,
               "tokens": 32, "workload": "train", "_file": "a"})
    return ev


def test_goodput_and_by_workload_match():
    ev = _events()
    jr, tr = jgoodput.goodput_report(ev, flops_per_step=1e9, peak_flops_per_s=1e12), \
        tgoodput.goodput_report(ev, flops_per_step=1e9, peak_flops_per_s=1e12)
    assert vars(jr) == vars(tr)
    tr.check()
    assert jr.summary() == tr.summary()
    jw, tw = jgoodput.by_workload(ev), tgoodput.by_workload(ev)
    assert jw.table() == tw.table() and jw.summary() == tw.summary()
    tw.check()
    assert jtrace.fold_phase_events(ev) == ttrace.fold_phase_events(ev)


def test_straggler_reports_match():
    per = {"a": {0: 1.0, 1: 2.5, 2: 1.1}, "b": {0: 1.0, 1: 1.05}, "c": {3: 2.0}}
    js = jtrace.detect_stragglers(per, min_skew=1.2)
    ts = ttrace.detect_stragglers(per, min_skew=1.2)
    assert [vars(r) for r in js] == [vars(r) for r in ts]
    assert [r.summary() for r in js] == [r.summary() for r in ts]


def test_mesh_reduce_span_and_straggler_on_4_stacked_ranks():
    """The stacked mesh's reductions against the JAX CPU mesh's."""
    per_rank = np.random.default_rng(7).standard_normal((4, 3))
    jm = jax_mesh((2, 2), ("a", "b"), jax.devices()[:4])
    tm = make_mesh((2, 2), ("a", "b"), device="cpu")
    ops = ("sum", "max", "min")
    jr, tr = jmetrics.mesh_reduce(jm, per_rank, ops), tmetrics.mesh_reduce(tm, per_rank, ops)
    for op in ops:
        assert jr[op].dtype == tr[op].dtype and np.array_equal(jr[op], tr[op])
    one = [1.0, 3.0, 2.0, 0.5]
    assert np.array_equal(jmetrics.mesh_reduce(jm, one)["sum"], tmetrics.mesh_reduce(tm, one)["sum"])
    begins, ends = [10.0, 10.5, 11.0, 10.2], [12.0, 13.0, 12.5, 12.1]
    assert vars(jmetrics.mesh_span(jm, "p", begins, ends)) == \
        vars(tmetrics.mesh_span(tm, "p", begins, ends))
    assert vars(tmetrics.mesh_span(tm, "p", begins, ends, use_device=False)) == \
        vars(jmetrics.mesh_span(jm, "p", begins, ends, use_device=False))
    secs = [0.5, 0.9, 0.4, 0.7]
    assert vars(jtrace.mesh_straggler(jm, "x", secs)) == vars(ttrace.mesh_straggler(tm, "x", secs))
    with pytest.raises(ValueError, match="rows"):
        tmetrics.mesh_reduce(tm, per_rank[:3])
    with pytest.raises(ValueError, match="unknown reduce op"):
        tmetrics.mesh_reduce(tm, per_rank, ("mean",))


def test_config16_accounts_each_workload_at_a_small_size():
    """Config 16 on the CPU at toy sizes: a row a workload, each mode's
    buckets summing to its wall (``check`` ran inside), one preemption
    restarted in each."""
    from tpuscratch_torch.bench.record import config16_elastic_goodput

    out = []
    res = config16_elastic_goodput(out, device="cpu", train_steps=12, halo_grid=64,
                                   solver_tile=8)
    assert [r["metric"] for r in out] == ["elastic_goodput_train", "elastic_goodput_halo",
                                          "elastic_goodput_solver"]
    for name, r in res.items():
        row = r["row"]
        for mode in ("blocking", "async"):
            rep = r["reports"][mode]
            rep.check()
            assert 0.0 < row[f"goodput_fraction_{mode}"] <= 1.0
            assert row[f"restart_share_{mode}"] > 0.0 and rep.buckets["checkpoint"] > 0.0
        assert row["overlapped_write_s"] > 0.0
