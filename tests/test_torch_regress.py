"""The port's regression gate (``tpuscratch_torch.obs.regress``) against the
JAX package's: the same rows give the same findings, with one case each
for rows of platform "tpu" and "cpu" (the JAX gate's own cases) and for
the card's "cuda" rows, which keep the tight band as the TPU's do (the
JAX gate, which knows no "cuda", would widen them by its CPU noise
floors, so they are held to the JAX findings of the same rows as "tpu").
Directions of every field name equal the JAX gate's, and the fields that
only the port's rows carry have one. The command line's exit codes, and
``bench.record``'s ``--json`` / ``--check``. Findings are compared
exactly (same floats: the same divisions)."""

import dataclasses
import json
import subprocess
import sys

import pytest

from tpuscratch.obs import regress as jr
from tpuscratch_torch.bench import record
from tpuscratch_torch.obs import regress as tr


def _rows(platform, scale=1.0, p99=1.0, drop=False):
    rows = [
        {"config": 12, "metric": "serve_decode_tokens_per_s", "value": 4000.0 * scale,
         "p50_s": 0.007, "p99_s": 0.0118 * p99, "platform": platform, "tokens_per_s": 4000.0},
        {"config": 15, "metric": "solver_ca_smoothing", "value": 0.87,
         "ppermutes_per_sweep_s2": 3.375, "halo_bytes_per_sweep_s2": 29410.0 * scale,
         "cells_per_s_s1": 3.6e6 * scale, "deep_speedup": 0.87 / scale, "platform": platform},
        {"config": 16, "metric": "elastic_goodput_train", "value": 0.44,
         "copy_device_s_async": 0.12 / scale, "checkpoint_share_async": 0.38,
         "goodput_fraction_async": 0.44 * scale, "platform": platform,
         "detail": "text", "stacked": True},
        {"config": 18, "metric": "cosched_goodput_train_solver", "value": 0.63 * scale,
         "share_err": 0.12, "switch_s": 0.0001 * p99, "switches": 5,
         "share_train": 0.58, "platform": platform},
    ]
    if not drop:
        rows.append({"config": 5, "metric": "weak_scaling_efficiency", "value": 0.62 * scale,
                     "per_chip_tile": 1024, "platform": platform})
    return rows


def _findings(mod, base, new, noise=0.1):
    return [dataclasses.astuple(f) for f in mod.compare(mod.index_rows(base),
                                                          mod.index_rows(new), noise=noise)]


CASES = [dict(scale=1.0), dict(scale=0.5), dict(scale=1.3), dict(scale=0.85, p99=1.4),
         dict(scale=1.0, p99=2.1), dict(scale=0.95, drop=True)]


@pytest.mark.parametrize("platform", ["tpu", "cpu"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_findings_equal_jax(platform, case):
    base = _rows(platform)
    new = _rows(platform, **CASES[case])
    for noise in (0.05, 0.1):
        assert _findings(tr, base, new, noise) == _findings(jr, base, new, noise)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_cuda_rows_keep_the_chip_band(case):
    new = _rows("cuda", **CASES[case])
    as_tpu = [dict(r, platform="tpu") for r in new]
    assert _findings(tr, _rows("cuda"), new) == _findings(jr, _rows("tpu"), as_tpu)
    for name in ("p99_s", "switch_s", "goodput_fraction_async", "tokens_per_s"):
        assert tr.noise_floor(name, "cuda") == 0.0 == jr.noise_floor(name, "tpu")
        assert tr.noise_floor(name, "cpu") == jr.noise_floor(name, "cpu")


def test_a_tail_swing_cuda_gates_and_cpu_forgives():
    base = _rows("cuda")
    new = _rows("cuda", p99=1.4)
    assert tr.has_regression(tr.compare(tr.index_rows(base), tr.index_rows(new)))
    cpu = [dict(r, platform="cpu") for r in new]
    assert not tr.has_regression(tr.compare(tr.index_rows(_rows("cpu")), tr.index_rows(cpu)))


#: numeric fields that only the port's rows carry (bench/record.py)
PORT_FIELDS = ("copy_device_s_async", "bytes_per_token_fp8", "peak_mem_bytes",
               "zero_state_bytes_per_rank")


def test_directions_equal_and_port_fields_directed():
    names = set()
    for rows in (_rows("cpu"),):
        for r in rows:
            names |= set(r) | {r["metric"]}
    names |= {"ppermutes_per_sweep_s1", "halo_bytes_per_sweep_s1", "psums_total_classic",
              "psums_per_iter_pipelined", "iterations_classic", "cycles_s1", "comm_ratio",
              "efficiency", "solve_s", "cells_per_s", "pipelined_speedup", "solver_cycles",
              "goodput_fraction_cosched", "wall_s_solo", "points", "halo_bytes_per_cell"}
    for n in names:
        assert tr.direction(n) == jr.direction(n), n
    for n in PORT_FIELDS:
        assert tr.direction(n) == "lower", n
    assert tr.direction("copy_device") == "lower"


def test_cli_exit_codes(tmp_path, capsys):
    a, b, c = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "c.json"
    a.write_text("".join(json.dumps(r) + "\n" for r in _rows("cuda")))
    b.write_text("".join(json.dumps(r) + "\n" for r in _rows("cuda", scale=0.5)))
    c.write_text(a.read_text() + '{"torn": ')          # a torn tail line is skipped
    assert tr.main([str(a), str(a)]) == 0
    assert tr.main([str(a), str(b)]) == 1
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert tr.main([str(a), str(c)]) == 0
    assert tr.main([str(a), str(b), "--json"]) == 1
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert any(f["status"] == "regressed" for f in json.loads(out))
    # the module's command line reads files only (no device, no JAX)
    p = subprocess.run([sys.executable, "-m", "tpuscratch_torch.obs.regress", str(a), str(b)],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 1 and "REGRESSED" in p.stdout and "sys.modules" not in p.stderr


def test_record_json_and_check(tmp_path, monkeypatch, capsys):
    rows = _rows("cpu")

    def fake(out):
        for r in rows:
            out.append(dict(r))

    monkeypatch.setitem(record.CONFIGS, 99, fake)
    path = tmp_path / "run.json"
    assert record.main(["--configs", "99", "--json", str(path)]) == 0
    assert [json.loads(ln) for ln in path.read_text().splitlines()] == rows
    assert record.main(["--configs", "99", "--check", str(path)]) == 0
    rows = _rows("cpu", scale=0.5)
    assert record.main(["--configs", "99", "--check", str(path), "--noise", "0.2"]) == 1
    assert "REGRESSED" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="not ported"):
        record.main(["--configs", "7"])
