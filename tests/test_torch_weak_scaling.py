"""The port's weak-scaling harness (``tpuscratch_torch.bench.weak_scaling``)
and record configs 5, 15 and 18 against the JAX package's.

``halo_traffic_per_chip`` and ``halo3d_traffic_per_chip`` are pure plan
arithmetic: EQUAL over meshes x impls (2D) and meshes x depths x sweeps an
exchange (3D). The configs run here at cut sizes (config 5: 32^2 a rank,
2 steps; config 15: 8^3 a rank, 32^2 CG; config 18: d_model 32, 4 steps,
8^3 a rank) and must emit the JAX harness's metric names and field keys
(read from its source: ``_emit`` keywords and the ``row`` / ``cg_row``
keys, f-string parts as wildcards), plus the port's ``device``; each
config's own checks (bit-identical co-scheduling, partition checks) run
inside it. ``bench_weak_scaling`` on stacked ranks gives each point the
plan's analytic ``comm_ratio``."""

import ast
import inspect
import re
import textwrap

import pytest
import torch

from tpuscratch.bench import record as jrecord
from tpuscratch.bench import weak_scaling as jws
from tpuscratch_torch.bench import record
from tpuscratch_torch.bench import weak_scaling as tws

torch.set_num_threads(1)


@pytest.mark.parametrize("dims", [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 4), (3, 5)])
@pytest.mark.parametrize("impl", ["xla", "pallas", "deep", "deep:4", "deep-pallas:16", "resident:8"])
def test_halo_traffic_equal(dims, impl):
    for per_chip in ((1024, 1024), (64, 48), (40, 40)):
        assert tws.halo_traffic_per_chip(dims, per_chip, impl) == \
            jws.halo_traffic_per_chip(dims, per_chip, impl)
    assert tws.halo_traffic_per_chip(dims, (64, 48), impl, itemsize=2) == \
        jws.halo_traffic_per_chip(dims, (64, 48), impl, itemsize=2)


@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (1, 3, 2)])
def test_halo3d_traffic_equal(dims):
    for per_chip in ((32, 32, 32), (16, 8, 24)):
        for depth, sweeps in ((1, 1), (2, 2), (4, 2), (3, 3)):
            assert tws.halo3d_traffic_per_chip(dims, per_chip, depth=depth,
                                               sweeps_per_exchange=sweeps) == \
                jws.halo3d_traffic_per_chip(dims, per_chip, depth=depth,
                                            sweeps_per_exchange=sweeps)


def _pattern(node) -> str:
    """A regex for a constant or f-string key: the f-string's fields match
    anything."""
    if isinstance(node, ast.Constant):
        return re.escape(str(node.value))
    assert isinstance(node, ast.JoinedStr), ast.dump(node)
    return "".join(re.escape(str(v.value)) if isinstance(v, ast.Constant) else ".+"
                   for v in node.values)


def _jax_fields(fn) -> tuple[set, set]:
    """(metric patterns, field-key patterns) a JAX record config emits."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    metrics, keys = set(), {"platform", "metric"}    # platform: added by the JAX _emit
    rows = ("row", "cg_row")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit":
            for kw in node.keywords:
                if kw.arg == "metric":
                    metrics.add(_pattern(kw.value))
                elif kw.arg is not None:
                    keys.add(re.escape(kw.arg))
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id in rows and isinstance(node.value, ast.Dict):
                keys |= {_pattern(k) for k in node.value.keys}
            if isinstance(tgt, ast.Subscript) and getattr(tgt.value, "id", None) in rows:
                keys.add(_pattern(tgt.slice))
    return metrics, keys


def _check_rows(rows, jax_fn):
    metrics, keys = _jax_fields(jax_fn)
    seen_m, seen_k = set(), set()
    for r in rows:
        m = next((p for p in metrics if re.fullmatch(p, r["metric"])), None)
        assert m is not None, r["metric"]
        seen_m.add(m)
        for k in r:
            if k == "device":      # the port's rows name the card
                continue
            p = next((p for p in keys if re.fullmatch(p, k)), None)
            assert p is not None, (r["metric"], k)
            seen_k.add(p)
    assert seen_m == metrics
    assert seen_k == keys, keys - seen_k


def test_config5_rows():
    out = []
    pts = record.config5_weak_scaling(out, per_chip=32, iters=1, steps=2, device="cpu")
    assert [p.n_devices for p in pts] == [1, 2, 4, 8, 16]
    for p in pts:
        want, _ = tws.halo_traffic_per_chip(p.dims, (32, 32))
        assert p.comm_ratio == want / (32 * 32) and p.grid == (32 * p.dims[0], 32 * p.dims[1])
    assert out[0]["points"]["1"] == 1.0 and out[0]["platform"] == "cpu"
    _check_rows(out, jrecord.config5_weak_scaling)
    deep = tws.bench_weak_scaling(per_chip=(32, 32), steps=32, device_counts=[4],
                                  impl="deep-pallas:16", iters=1, device="cpu")
    assert deep[0].dims == (2, 2) and deep[0].comm_ratio == \
        tws.halo_traffic_per_chip((2, 2), (32, 32), "deep-pallas:16")[0] / 1024
    assert "eff 100.0%" in tws.report(pts)


def test_config15_rows():
    out = []
    rows = record.config15_solver(out, iters=1, per_chip=8, n2=32, device="cpu")
    assert [r["metric"] for r in out] == list(rows)
    sm, cg = rows["solver_ca_smoothing"], rows["solver_ca_cg"]
    assert (sm["ppermutes_per_sweep_s1"], sm["halo_bytes_per_sweep_s1"]) == (6.0, 1536.0)
    assert (sm["ppermutes_per_sweep_s2"], sm["halo_bytes_per_sweep_s2"]) == (3.375, 2554.0)
    assert sm["cycles_s1"] == sm["cycles_s2"]
    assert (cg["psums_total_classic"], cg["psums_per_iter_classic"],
            cg["psums_total_pipelined"], cg["psums_per_iter_pipelined"]) == (3, 2, 2, 1)
    assert rows["solver_weak_mg3d_8dev"]["comm_ratio"] == \
        tws.halo3d_traffic_per_chip((2, 2, 2), (8, 8, 8))[0] / 512
    _check_rows(out, jrecord.config15_solver)


def test_config18_rows():
    out = []
    res = record.config18_cosched(out, device="cpu", steps=4, d_model=32, solver_tile=8,
                                  max_cycles=12)
    row = res["row"]
    assert row["target_train"] == 0.7 and row["switches"] >= 1
    assert abs(row["share_train"] + row["share_solver"] - 1.0) < 1e-9
    assert row["share_err"] == max(abs(row["share_train"] - 0.7),
                                   abs(row["share_solver"] - 0.3))
    _check_rows(out, jrecord.config18_cosched)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (lambda: tws.bench_weak_scaling(per_chip=(8, 8), steps=1, device_counts=[1]),
                 lambda: record.config5_weak_scaling([], per_chip=8, iters=1, steps=1),
                 lambda: record.config15_solver([], iters=1, per_chip=8, n2=8),
                 lambda: record.config18_cosched([], steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    (p,) = tws.bench_weak_scaling(per_chip=(8, 8), steps=1, device_counts=[2], iters=1,
                                  device="cpu")
    assert p.result.items_per_s > 0 and p.dims == (1, 2)
