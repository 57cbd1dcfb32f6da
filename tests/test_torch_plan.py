"""The port's ShardingPlan and plan-composed ZeRO step
(``tpuscratch_torch.parallel.plan``, ``models.zero.train_step_plan``)
against the JAX package's, twins of tests/test_plan.py on its tiny config
(d_model 16, 2 heads, 2 experts, d_ff 32, 2 layers, seq 16) on a pp2 x dp2
mesh ("dp", "sp", "pp") = (2, 1, 2) at ``n_micro`` 2.

Tolerances against JAX after two steps: losses 1e-5 relative, params 1e-5
absolute, flat moments 1e-4 relative plus 1e-7, the grad norm 1e-5
relative (sums in other orders through attention, routing and the
reductions). Within the port, bit for bit: the overlap schedule equals the
serial one, the fused update the elementwise one, and ZeRO the stacked
replicated Adam (the reduce-scatter sums each element over the dp ranks
as the all-reduce does, and the ÷|dp|*|sp|*|pp| against ÷(|dp|*|sp|) then
÷|pp| differ by powers of two only).

Wire bytes: the port counts each collective call by the ledger's formulas
(``comm.count_wire_bytes``); the JAX ledger reads the compiled program.
The reduce-scatter and all-gather legs agree exactly, call counts too.
The all-reduce legs differ by two known terms, which the test pins: the
compiled JAX program also holds the backward's stage sum of the outputs'
cotangent (the psum transpose; the port's backward is autograd's, not a
collective call), 2048 B here, and the ledger drops scalar payloads, where
the port counts the aux term's stage sum and the loss's dp mean, 4 B each.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.models import transformer as jt
from tpuscratch.models import zero as jz
from tpuscratch.obs import ledger as obs_ledger
from tpuscratch.parallel.plan import ShardingPlan as JaxPlan
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.bench.record import config11_pp_row, config14_plan_overlap
from tpuscratch_torch.bench.train_bench import bench_train, train_throughput_program
from tpuscratch_torch.comm import count_wire_bytes
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.models import zero as tz
from tpuscratch_torch.parallel.plan import ShardingPlan
from tpuscratch_torch.runtime.mesh import make_mesh

AXES = ("dp", "sp", "pp")
KW = dict(d_model=16, n_heads=2, n_experts=2, d_ff=32, n_layers=2, capacity_factor=2.0)


def _cfgs():
    return jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed=0):
    return rand((4, 16, 16), seed), rand((4, 16, 16), seed + 1)


def _plans(dims=(2, 1, 2), **kw):
    jm = jax_mesh(dims, AXES, jax.devices()[:int(np.prod(dims))])
    return (JaxPlan(jm, pp="pp", n_micro=2, **kw),
            ShardingPlan(make_mesh(dims, AXES, device="cpu"), pp="pp", n_micro=2, **kw))


@functools.lru_cache(maxsize=None)
def _stacked(seed=0):
    return _np(jt.stack_layers(jt.init_params(seed, _cfgs()[0])))


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(tt._leaves(a), tt._leaves(b)))


def _spec(s):
    return tuple(s)


def _port_run(plan, steps, zero=True, **kw):
    _, tc = _cfgs()
    p = tt.params_from_numpy(_stacked(), "cpu")
    opt = tz.init_plan_zero_state(p, plan) if zero else tt.init_adam_state(p)
    x, y = (to_torch(a) for a in _data())
    fn = tz.train_step_plan(plan, tc, lr=0.01, zero=zero, **kw)
    losses = []
    for _ in range(steps):
        p, opt, loss = fn(p, opt, x, y)
        losses.append(float(loss))
    return np.asarray(losses), p, opt


# ---- the plan object --------------------------------------------------------------------


def test_plan_errors_name_the_axis_as_jax_does():
    jm = jax_mesh((2, 2), ("dp", "sp"), jax.devices()[:4])
    tm = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    for kw, match in (({"pp": "stage"}, "pp='stage'"), ({"dp": "data"}, "dp='data'"),
                      ({"n_micro": 2}, "pp axis"), ({"n_micro": 0}, "n_micro"),
                      ({"prefetch_blocks": 0}, "prefetch_blocks")):
        for make, mesh in ((JaxPlan, jm), (ShardingPlan, tm)):
            with pytest.raises(ValueError, match=match):
                make(mesh, **kw)


def test_plan_specs_and_describe_equal_jax():
    jp, tp = _plans()
    assert _spec(tp.spec("pp", "ep")) == _spec(jp.spec("pp", "ep")) == ("pp", "dp")
    assert _spec(tp.spec(("pp", "dp"))) == _spec(jp.spec(("pp", "dp")))
    assert _spec(tp.spec(None, "sp")) == _spec(jp.spec(None, "sp"))
    assert _spec(tp.data_spec(2)) == _spec(jp.data_spec(2))
    for name in ("dp_size", "sp_size", "pp_size", "pipelined", "overlap_blocks", "ep_axis"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.describe() == jp.describe()
    jd, td = _plans((2, 2, 1))
    assert td.describe() == jd.describe() == {"dp": 2, "sp": 2, "pp": 1, "n_micro": 2}
    j1 = JaxPlan(jd.mesh, pp="pp")
    t1 = ShardingPlan(td.mesh, pp="pp")
    assert t1.describe() == j1.describe() and not t1.pipelined
    assert ShardingPlan(td.mesh, overlap=False).overlap_blocks == 0
    with pytest.raises(ValueError, match="not mapped"):
        ShardingPlan(td.mesh).spec("pp")
    with pytest.raises(ValueError, match="unknown logical"):
        tp.spec("tp")
    tree = {"a": torch.zeros(2, 2), "b": {"c": torch.zeros(2)}, "l": [torch.zeros(1)]}
    spec = tp.tree_spec(tree, lambda path, leaf: ("pp",) if path[0] == "a" else ())
    assert {"a": _spec(spec["a"]), "c": _spec(spec["b"]["c"]), "l": _spec(spec["l"][0])} == \
        {"a": ("pp",), "c": (), "l": ()}


def test_plan_state_sizes_specs_and_put_equal_jax():
    jc, tc = _cfgs()
    jp, tp = _plans()
    stacked = _stacked()
    want = _np(jz.init_plan_zero_state(stacked, jp))
    got = tz.init_plan_zero_state(tt.params_from_numpy(stacked, "cpu"), tp)
    for (_, a), b in zip(tt._jax_paths(got), jax.tree_util.tree_leaves(want), strict=True):
        assert tuple(a.shape) == np.shape(b) and float(a.abs().sum()) == 0
    js, ts = jz.plan_zero_state_spec(jc, jp), tz.plan_zero_state_spec(tc, tp)
    for k in ("mu_flat", "nu_flat", "t"):
        assert _spec(ts[k]) == _spec(js[k]), k
    for k in ("mu_exp", "nu_exp"):
        assert [_spec(s) for s in ts[k]] == [_spec(s) for s in js[k]], k
    # a state from numpy (the JAX package's, moved one step) on the device, bit for bit
    rng = np.random.default_rng(3)
    state = {k: (rng.standard_normal(np.shape(v)).astype(np.float32) if k != "t" else v)
             for k, v in want.items() if k in ("mu_flat", "nu_flat", "t")}
    state["mu_exp"] = [rng.standard_normal(np.shape(v)).astype(np.float32) for v in want["mu_exp"]]
    state["nu_exp"] = [np.abs(v) for v in state["mu_exp"]]
    put = tz.put_plan_state(state, tp, tc)
    np.testing.assert_array_equal(put["mu_flat"].numpy(), state["mu_flat"])
    np.testing.assert_array_equal(put["nu_exp"][1].numpy(), state["nu_exp"][1])
    assert put["t"].dtype == torch.int32 and put["t"].ndim == 0
    assert tz.put_plan_state(put, tp, tc)["mu_flat"].data_ptr() != put["mu_flat"].data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        tz.put_plan_state({**state, "mu_flat": state["mu_flat"][:-1]}, tp, tc)


# ---- the plan step against JAX -----------------------------------------------------------


@pytest.mark.parametrize("zero", [True, False])
def test_train_step_plan_matches_jax(zero):
    jc, _ = _cfgs()
    jp, tp = _plans()
    stacked = _stacked()
    x, y = _data()
    p = jax.tree_util.tree_map(jnp.asarray, stacked)
    opt = (jz.put_plan_state(jz.init_plan_zero_state(p, jp), jp, jc) if zero
           else jt.init_adam_state(p))
    fn = jz.train_step_plan(jp, jc, lr=0.01, zero=zero, donate=False, with_grad_norm=True)
    want, norms = [], []
    for _ in range(2):
        p, opt, loss, gnorm = fn(p, opt, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))
        norms.append(float(gnorm))
    got, tp_, to = _port_run(tp, 2, zero=zero)
    # the grad norm of the first step, both layouts (_pp_grad_norm, _zero_grad_norm)
    _, tc = _cfgs()
    t0 = tt.params_from_numpy(stacked, "cpu")
    opt0 = tz.init_plan_zero_state(t0, tp) if zero else tt.init_adam_state(t0)
    gn = float(tz.train_step_plan(tp, tc, zero=zero, with_grad_norm=True)(
        t0, opt0, to_torch(x), to_torch(y))[3])
    assert abs(gn - norms[0]) <= 1e-5 * norms[0], (gn, norms[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for a, (_, b) in zip(jax.tree_util.tree_leaves(p), tt._jax_paths(tp_)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    keys = ("mu_flat", "nu_flat") if zero else ("mu", "nu")
    for k in keys:
        for a, (_, b) in zip(jax.tree_util.tree_leaves(opt[k]), tt._jax_paths(to[k])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-7)
    assert int(to["t"]) == int(opt["t"]) == 2


def test_counted_wire_bytes_match_the_jax_ledger_pp2_dp2():
    jc, tc = _cfgs()
    jp, tp = _plans()
    stacked = _stacked()
    xj = jnp.zeros((4, 16, 16), jnp.float32)
    led = obs_ledger.analyze(jz.train_step_plan(jp, jc, donate=False), stacked,
                             jz.init_plan_zero_state(stacked, jp), xj, xj)
    want = obs_ledger.grad_sync_wire_bytes(led)
    tstacked = tt.params_from_numpy(stacked, "cpu")
    xt = torch.zeros(4, 16, 16)
    with count_wire_bytes() as got:
        tz.train_step_plan(tp, tc)(tstacked, tz.init_plan_zero_state(tstacked, tp), xt, xt)
    assert got.reduce_scatter == want.reduce_scatter > 0
    assert got.all_gather == want.all_gather > 0
    counts = led.counts()
    assert got.ops["reduce_scatter"] == counts["reduce-scatter"] == tp.overlap_blocks
    assert got.ops["all_gather"] == counts["all-gather"] == tp.overlap_blocks
    shard = tz.zero_flat_size(tt.nonexpert_size(tstacked) // 2, 2) // 2
    assert got.reduce_scatter == (2 - 1) * shard * 4
    # all-reduce over 2 ranks moves its payload: the outputs' stage sum (a dp
    # rank's 2 x 16 x 16 f32), once in the port and twice in JAX, and two
    # scalars only the port counts
    outputs = 2 * 16 * 16 * 4
    assert got.all_reduce == outputs + 4 + 4
    assert want.all_reduce == 2 * outputs
    with count_wire_bytes() as serial:
        tz.train_step_plan(ShardingPlan(tp.mesh, pp="pp", n_micro=2, overlap=False), tc)(
            tstacked, tz.init_plan_zero_state(tstacked, tp), xt, xt)
    assert serial.total == got.total and serial.ops["reduce_scatter"] == 1


# ---- the plan step within the port -------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_overlap_equals_serial_bitwise(fused):
    _, tp = _plans()
    serial = ShardingPlan(tp.mesh, pp="pp", n_micro=2, overlap=False)
    a, pa, oa = _port_run(serial, 2, fused=fused)
    b, pb, ob = _port_run(tp, 2, fused=fused)
    assert np.array_equal(a, b) and _equal(pa, pb)
    assert torch.equal(oa["mu_flat"], ob["mu_flat"]) and torch.equal(oa["nu_flat"], ob["nu_flat"])


def test_zero_equals_replicated_and_fused_equals_elementwise_bitwise():
    _, tp = _plans()
    a, pa, _ = _port_run(tp, 2, zero=False)
    b, pb, ob = _port_run(tp, 2, zero=True, fused=False)
    c, pc, oc = _port_run(tp, 2, zero=True, fused=True)
    assert np.array_equal(a, b) and np.array_equal(b, c)
    assert _equal(pa, pb) and _equal(pb, pc) and torch.equal(ob["nu_flat"], oc["nu_flat"])


@pytest.mark.parametrize("dims", [(1, 1, 2), (2, 1, 2)])
def test_fused_launches_once_a_step_and_once_a_block_and_donates(dims):
    # in place where one stride walks the ranks' flat shards (pp2 x dp1); the
    # (pp, dp) layout of pp2 x dp2 is two strides, and that step writes new
    # tensors, leaving the passed state alone
    _, tc = _cfgs()
    _, tp = _plans(dims)
    p = tt.params_from_numpy(_stacked(), "cpu")
    x, y = (to_torch(a) for a in _data())
    for plan, want in ((ShardingPlan(tp.mesh, pp="pp", n_micro=2, overlap=False), 1), (tp, 4)):
        calls = []
        real = tz.fused_adam_tree
        tz.fused_adam_tree = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            opt = tz.init_plan_zero_state(p, plan)
            ptr = opt["mu_flat"].data_ptr()
            _, new, _ = tz.train_step_plan(plan, tc)(p, opt, x, y)
        finally:
            tz.fused_adam_tree = real
        assert len(calls) == want and float(new["mu_flat"].abs().sum()) > 0
        assert (new["mu_flat"].data_ptr() == ptr) == (dims[0] == 1)
        assert (float(opt["mu_flat"].abs().sum()) > 0) == (dims[0] == 1)


def test_plan_step_refusals():
    """The plan step's ``guard=`` and ``counter=`` levers (once refused
    here) against the JAX guarded plan step on pp2 x dp2: the same
    statuses; a clean guarded step bit-identical to the port's unguarded
    one; a NaN step keeps the stacked params and the plan state bit for
    bit; one build counted. Then the refusals."""
    from tpuscratch_torch.obs import CompileCounter

    jc, tc = _cfgs()
    jp, tp = _plans()
    counter = CompileCounter()
    x, y = _data()
    bad = x.copy()
    bad[0, 0, 0] = np.nan
    jfn = jz.train_step_plan(jp, jc, lr=0.01, guard=(1e30, 1e30))
    tfn = tz.train_step_plan(tp, tc, lr=0.01, guard=(1e30, 1e30), counter=counter)
    _, plain_p, plain_o = _port_run(tp, 1)
    for xb, want in ((x, 0), (bad, 2)):
        js = jfn(jax.tree_util.tree_map(jnp.asarray, _stacked()),
                 jz.init_plan_zero_state(jax.tree_util.tree_map(jnp.asarray, _stacked()), jp),
                 jnp.asarray(xb), jnp.asarray(y), jnp.float32(np.nan))[-1]
        p0 = tt.params_from_numpy(_stacked(), "cpu")
        o0 = tz.init_plan_zero_state(p0, tp)
        new_p, new_o, _, _, ts = tfn(p0, o0, to_torch(xb), to_torch(y), torch.tensor(np.nan))
        assert int(js) == int(ts) == want
        if want == 0:
            assert _equal(new_p, plain_p) and torch.equal(new_o["mu_flat"], plain_o["mu_flat"])
        else:
            assert _equal(new_p, p0) and torch.equal(new_o["mu_flat"], o0["mu_flat"])
    assert counter.count == 1
    with pytest.raises(ValueError, match="pipelined plan"):
        tz.train_step_plan(ShardingPlan(tp.mesh), tc)
    with pytest.raises(NotImplementedError, match="ep"):
        tz.train_step_plan(ShardingPlan(tp.mesh, pp="pp", ep="sp"), tc)
    with pytest.raises(ValueError, match="n_layers"):
        tz.train_step_plan(tp, dataclasses.replace(tc, n_layers=3))


# ---- the benches --------------------------------------------------------------------------


def test_bench_program_runs_plan():
    _, tc = _cfgs()
    _, tp = _plans()
    for ov in (False, True):
        plan = ShardingPlan(tp.mesh, pp="pp", n_micro=2, overlap=ov)
        r = bench_train(plan=plan, cfg=tc, batch=4, seq=16, steps=2, iters=1, fence="block",
                        optimizer="adam", zero=True)
        assert r.items_per_s > 0 and ("ov4" if ov else "serial") in r.name and "-pp2-M2" in r.name
    flat = ShardingPlan(make_mesh((2, 1, 1), AXES, device="cpu"), pp="pp")
    r = bench_train(plan=flat, cfg=tc, batch=4, seq=16, steps=1, iters=1, fence="block",
                    optimizer="adam", zero=True)
    assert "zero-adam-ov4 " in r.name
    with pytest.raises(ValueError, match="adam"):
        train_throughput_program(tp.mesh, tc, 1, plan=tp)
    with pytest.raises(ValueError, match="n_micro"):
        train_throughput_program(tp.mesh, tc, 1, optimizer="adam", zero=True, accum_steps=2,
                                 plan=tp)


def test_config14_and_the_pp_row_emit_the_jax_rows_keys():
    _, tc = _cfgs()
    out = []
    config11_pp_row(out, iters=1, steps=1, device="cpu")
    config14_plan_overlap(out, iters=1, steps=1, device="cpu", cfg=tc, seq=16, batch_per_dp=2)
    rows = {r["metric"]: r for r in out}
    assert sorted(rows) == ["plan_overlap_pp1_dp1_tokens_per_s", "plan_overlap_pp1_dp2_tokens_per_s",
                            "plan_overlap_pp2_dp1_tokens_per_s", "plan_overlap_pp2_dp2_tokens_per_s",
                            "train_pp_tokens_per_s"]
    pp = rows["train_pp_tokens_per_s"]
    assert pp["config"] == 11 and pp["value"] > 0 and "M=2" in pp["detail"]
    assert pp["reduced"] == ["steps 1 (JAX row: 2)", "iters 1 (JAX row: 3)"]
    for key, r in rows.items():
        if r["config"] != 14:
            continue
        for k in ("pp", "n_micro", "overlap_speedup", "value", "detail"):
            assert k in r
        for tag in ("serial", "overlap"):
            for k in ("wire_bytes", "rs_ops", "ag_ops", "tokens_per_s", "step_s",
                      "achieved_flops_per_s"):
                assert f"{k}_{tag}" in r, (key, k, tag)
            assert f"achieved_fraction_{tag}" not in r  # TPUSCRATCH_PEAK_FLOPS unset
        assert r["wire_bytes_overlap"] == r["wire_bytes_serial"]
        assert (r["rs_ops_serial"], r["rs_ops_overlap"]) == (1, 4)
        assert "train_flops_per_token" in r["detail"]
    assert rows["plan_overlap_pp2_dp2_tokens_per_s"]["n_micro"] == 2
