"""The port's profiling layer (``tpuscratch_torch.runtime.profiling``)
against the JAX package's: ``Timeline`` spans under an injected clock (the
same stamps), ``seconds``, ``report`` and ``cross_rank_span`` over three
ranks' timelines are EQUAL (the same arithmetic on the same floats); a
span closes on the exception path too. On the CPU, ``trace`` writes a
Chrome trace file that names an ``annotate`` region and the aten ops it
ran, and a profiler that cannot start warns and lets the run go on, as
the JAX package's contract says."""

import itertools
import json

import pytest
import torch

from tpuscratch.obs.trace import FlightRecorder as JRecorder
from tpuscratch.runtime import profiling as jp
from tpuscratch_torch import obs
from tpuscratch_torch.obs.trace import FlightRecorder as TRecorder
from tpuscratch_torch.runtime import profiling as tp

torch.set_num_threads(1)


def _timelines(mod, rec_cls):
    out = []
    for rank in range(3):
        stamps = itertools.count(10.0 * rank + 0.125, 0.375 + rank)
        tl = mod.Timeline(rec_cls(clock=lambda s=stamps: next(s)))
        for name in ("exchange", "update", "exchange"):
            with tl.span(name):
                pass
        with pytest.raises(RuntimeError):
            with tl.span("update"):
                raise RuntimeError("boom")
        out.append(tl)
    return out


def test_spans_and_cross_rank_span_equal():
    jt, tt = _timelines(jp, JRecorder), _timelines(tp, TRecorder)
    for a, b in zip(jt, tt):
        assert [(s.name, s.begin, s.end) for s in a.spans] == \
            [(s.name, s.begin, s.end) for s in b.spans]
        assert a.report() == b.report()
        for name in ("exchange", "update"):
            assert a.seconds(name) == b.seconds(name)
        assert len(b.recorder.events()) == 4   # the recorder holds the same spans
        with pytest.raises(KeyError):
            b.seconds("missing")
    for name in ("exchange", "update"):
        assert tp.cross_rank_span(tt, name) == jp.cross_rank_span(jt, name)
    assert obs.Timeline is tp.Timeline and obs.cross_rank_span is tp.cross_rank_span


def test_trace_writes_a_chrome_file(tmp_path):
    x = torch.randn(64, 64)
    with tp.trace(str(tmp_path / "prof")) as t:
        with tp.annotate("ledger/matmul"):
            y = x @ x
    assert t.path is not None and t.path.startswith(str(tmp_path / "prof"))
    events = json.loads(open(t.path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ledger/matmul" in names and "aten::mm" in names
    assert torch.equal(y, x @ x)
    with tp.trace(str(tmp_path / "prof")) as t2:
        pass
    assert t2.path != t.path   # one file a bracket


def test_a_profiler_that_cannot_start_warns(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    with pytest.warns(RuntimeWarning, match="failed to start"):
        with tp.trace(str(tmp_path / "never")) as t:
            ran.append(1)
    assert ran == [1] and t.path is None and not (tmp_path / "never").exists()
