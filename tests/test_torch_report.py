"""The port's run report (``tpuscratch_torch.obs.report``) against the JAX
package's: on one JSONL stream written with the port's sink (two hosts'
files: run metadata, chunk and save events, scoped metric snapshots,
cumulative ``trace/phase`` totals, ``reqtrace/request`` events with
segments and marks, a torn final line), ``summarize`` (whole and
``--event``-filtered), ``stragglers``, ``decompose``, ``format_table`` and
``request_waterfall`` give EQUAL results (the same loader, folds and
float arithmetic in the same order), and the command line prints the
same table."""

import json
import subprocess
import sys

import numpy as np
import pytest

from tpuscratch.obs import report as jr
from tpuscratch_torch.obs import report as tr
from tpuscratch_torch.obs.metrics import MetricsRegistry
from tpuscratch_torch.obs.sink import Sink


@pytest.fixture
def stream(tmp_path):
    rng = np.random.default_rng(11)
    paths = []
    for host in (0, 1):
        reg = MetricsRegistry()
        with Sink(str(tmp_path / "run.jsonl"), run={"bench": "twin", "mode": "x"},
                  host=host) as s:
            path = s.path   # host 1 writes run.h1.jsonl
            for step in range(6):
                s.emit("train/chunk", step=step, loss=float(rng.standard_normal()),
                       wall_s=float(rng.uniform(0.1, 0.3)), compile_s=0.0, tag="a",
                       ok=True, workload="train")
                reg.counter("steps").inc()
                reg.histogram("loss").observe(float(rng.uniform()))
                reg.gauge("lr").set(0.01 * (step + 1))
                if step % 2:
                    s.emit("ckpt/save", step=step, bytes=4096, wall_s=float(rng.uniform()))
                    s.emit_metrics(reg.snapshot(), scope=reg.id)
            for phase in ("train/chunk", "ckpt/save"):
                for k in range(2):   # cumulative: the newest wins
                    s.emit("trace/phase", phase=phase, host=host, scope="rec-1",
                           seconds=round(float(rng.uniform(1, 3)) * (1 + host) * (k + 1), 6),
                           count=3 + k, max_s=0.5)
            for rid in range(5):
                q = float(rng.uniform(0, 0.01))
                d = float(rng.uniform(0.01, 0.05))
                s.emit("reqtrace/request", rid=rid, cls="chat" if rid % 2 else "batch",
                       outcome="finished", attempts=1, queue_s=q, decode_s=d, e2e_s=q + d,
                       ttft_s=q + 0.001, segments=[[0, "queue", 0.0, q], [0, "decode", q, q + d]],
                       marks=[["submit", 0.0], ["finish", q + d]])
        paths.append(str(path))
    with open(paths[1], "a") as f:
        f.write('{"event": "train/chunk", "step": ')   # a torn tail
    return paths


def _load(mod, paths):
    with pytest.warns(RuntimeWarning, match="corrupt"):
        return mod.load_events(paths)


def test_summary_table_and_decomposition_equal(stream):
    ej, et = _load(jr, stream), _load(tr, stream)
    assert ej == et
    for only in (None, "train/chunk", "trace/phase", "ckpt/save"):
        sj, st = jr.summarize(ej, only_event=only), tr.summarize(et, only_event=only)
        assert sj == st
        assert jr.format_table(sj) == tr.format_table(st)
    full = tr.summarize(et)
    assert {"runs", "events", "stragglers", "metrics", "decomposition"} <= set(full)
    assert tr.stragglers(et) == jr.stragglers(ej) and len(tr.stragglers(et)) == 2
    assert tr.decompose(et) == jr.decompose(ej) and set(tr.decompose(et)) == {"batch", "chat"}
    for rid in (0, 3, 99):
        assert tr.request_waterfall(et, rid) == jr.request_waterfall(ej, rid)
    assert "exact" in tr.request_waterfall(et, 3)
    assert tr.format_table({}) == "no events"


def test_command_line(stream, capsys):
    with pytest.warns(RuntimeWarning):
        assert tr.main(stream) == 0
    table = capsys.readouterr().out
    with pytest.warns(RuntimeWarning):
        assert jr.main(stream) == 0
    assert capsys.readouterr().out == table
    assert tr.main([stream[0], "--json", "--event", "ckpt/save"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got["events"]) == ["ckpt/save"] and got["events"]["ckpt/save"]["count"] == 3
    assert tr.main([stream[0], "--request", "1"]) == 0
    assert capsys.readouterr().out.startswith("request 1")
    # the module's command line reads files only (no device, no JAX)
    p = subprocess.run([sys.executable, "-m", "tpuscratch_torch.obs.report", stream[0]],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.startswith("run: bench=twin")
    assert "sys.modules" not in p.stderr
