"""The port's ZeRO step (``tpuscratch_torch.models.zero``) against the JAX
package's (``tpuscratch.models.zero``, its fused kernel in the Mosaic
interpreter), twins of tests/test_zero.py on its tiny config (d_model 16, 2
heads, 2 experts, d_ff 32). Each run starts from the JAX weights
(``params_from_numpy``) and the JAX ZeRO state (``zero_state_from_numpy``).

Tolerances: against JAX, losses 1e-5 relative and params 1e-5 after 4
steps (sums in other orders through attention, routing and the gradient
sync; sound runs read about 4e-7 and 9e-7). Within the port: the 1x1
elementwise ZeRO step equals the replicated Adam step bit for bit (scatter
and gather are identities there), the fused kernel equals the elementwise
update bit for bit (same association), the overlap schedule equals the
serial one bit for bit, and accumulation over identical microbatches is
held at 1e-6.

Wire bytes: the port counts each collective call by the ledger's formulas
(``comm.count_wire_bytes``); the JAX ledger reads the compiled program. The
reduce-scatter and all-gather legs agree exactly. The port's all-reduce leg
holds 6 B more on the 2x2 mesh: one 4-byte scalar all-reduce over 4 ranks
(2 * 3/4 * 4 B) that the compiled JAX program does not show.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.models import transformer as jt
from tpuscratch.models import zero as jz
from tpuscratch.obs import ledger as obs_ledger
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.bench.record import config13_zero_train
from tpuscratch_torch.bench.train_bench import bench_train, train_throughput_program
from tpuscratch_torch.comm import count_wire_bytes
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.models import zero as tz
from tpuscratch_torch.ops import adam as tadam
from tpuscratch_torch.runtime.errors import CommError
from tpuscratch_torch.runtime.mesh import make_mesh

KW = dict(d_model=16, n_heads=2, d_ff=32, capacity_factor=2.0)


def _cfgs(n_experts=2):
    return (jt.TransformerConfig(n_experts=n_experts, **KW),
            tt.TransformerConfig(n_experts=n_experts, **KW))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(batch=4, seq=16):
    return rand((batch, seq, 16), 0), rand((batch, seq, 16), 1)


def _jax_zero(dims, cfg, params, steps, x, y, **kw):
    mesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:dims[0] * dims[1]])
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jz.put_zero_state(jz.init_zero_adam_state(p, dims[0]), mesh, cfg)
    fn = jz.train_step_zero(mesh, cfg, lr=0.01, donate=False, **kw)
    losses = []
    for _ in range(steps):
        p, opt, loss = fn(p, opt, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return np.asarray(losses), p, opt


def _port_zero(dims, cfg, params, steps, x, y, **kw):
    mesh = make_mesh(dims, ("dp", "sp"), device="cpu")
    p = tt.params_from_numpy(params, "cpu")
    opt = tz.zero_state_from_numpy(_np(jz.init_zero_adam_state(params, dims[0])), "cpu")
    fn = tz.train_step_zero(mesh, cfg, lr=0.01, **kw)
    losses = []
    for _ in range(steps):
        p, opt, loss = fn(p, opt, to_torch(x), to_torch(y))
        losses.append(float(loss))
    return np.asarray(losses), p, opt


def _port_replicated(dims, cfg, params, steps, x, y):
    mesh = make_mesh(dims, ("dp", "sp"), device="cpu")
    p = tt.params_from_numpy(params, "cpu")
    opt = tt.init_adam_state(p)
    fn = tt.train_step_adam(mesh, cfg, lr=0.01)
    losses = []
    for _ in range(steps):
        p, opt, loss = fn(p, opt, to_torch(x), to_torch(y))
        losses.append(float(loss))
    return np.asarray(losses), p


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(tt._leaves(a), tt._leaves(b)))


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
@pytest.mark.parametrize("fused", [False, True])
def test_zero_step_matches_jax(dims, fused):
    jc, tc = _cfgs()
    params = _np(jt.init_params(0, jc))
    x, y = _data()
    want, jp, jo = _jax_zero(dims, jc, params, 4, x, y, fused=fused)
    got, tp, to = _port_zero(dims, tc, params, 4, x, y, fused=fused)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    # the port's leaves in the JAX package's flatten order
    for a, (_, b) in zip(jax.tree_util.tree_leaves(jp), tt._jax_paths(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    for key in ("mu_flat", "nu_flat"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]), rtol=1e-4, atol=1e-7)
    assert int(to["t"]) == int(jo["t"]) == 4


def test_zero_1x1_elementwise_equals_replicated_bitwise():
    jc, tc = _cfgs()
    params = _np(jt.init_params(0, jc))
    x, y = _data()
    want, wp = _port_replicated((1, 1), tc, params, 5, x, y)
    got, gp, _ = _port_zero((1, 1), tc, params, 5, x, y, fused=False, donate=False)
    assert np.array_equal(want, got)
    assert _equal(wp, gp)


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_fused_equals_elementwise_bitwise(dims):
    jc, tc = _cfgs()
    params = _np(jt.init_params(1, jc))
    x, y = _data()
    a, pa, oa = _port_zero(dims, tc, params, 3, x, y, fused=False)
    b, pb, ob = _port_zero(dims, tc, params, 3, x, y, fused=True)
    assert np.array_equal(a, b) and _equal(pa, pb)
    assert torch.equal(oa["mu_flat"], ob["mu_flat"]) and torch.equal(oa["nu_flat"], ob["nu_flat"])


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("fused", [False, True])
def test_overlap_equals_serial_bitwise(blocks, fused):
    jc, tc = _cfgs()
    params = _np(jt.init_params(2, jc))
    x, y = _data()
    a, pa, oa = _port_zero((2, 2), tc, params, 3, x, y, fused=fused)
    b, pb, ob = _port_zero((2, 2), tc, params, 3, x, y, fused=fused, overlap_blocks=blocks)
    assert np.array_equal(a, b) and _equal(pa, pb)
    assert torch.equal(oa["mu_flat"], ob["mu_flat"])


def test_overlap_matches_jax_overlap():
    jc, tc = _cfgs()
    params = _np(jt.init_params(3, jc))
    x, y = _data()
    want, _, _ = _jax_zero((2, 2), jc, params, 3, x, y, overlap_blocks=4)
    got, _, _ = _port_zero((2, 2), tc, params, 3, x, y, overlap_blocks=4)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_accum_on_identical_microbatches():
    jc, tc = _cfgs()
    params = _np(jt.init_params(0, jc))
    x, y = _data()
    want, _, _ = _port_zero((2, 2), tc, params, 4, x, y, fused=False)
    got, _, _ = _port_zero((2, 2), tc, params, 4, np.stack([x, x]), np.stack([y, y]),
                           accum_steps=2, fused=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_accum_matches_jax_accum():
    jc, tc = _cfgs()
    params = _np(jt.init_params(4, jc))
    x, y = rand((2, 4, 16, 16), 5), rand((2, 4, 16, 16), 6)
    want, _, _ = _jax_zero((2, 2), jc, params, 2, x, y, accum_steps=2)
    got, _, _ = _port_zero((2, 2), tc, params, 2, x, y, accum_steps=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_grad_norm_matches_jax():
    jc, tc = _cfgs()
    params = _np(jt.init_params(0, jc))
    x, y = _data()
    mesh = jax_mesh((2, 2), ("dp", "sp"), jax.devices()[:4])
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jout = jz.train_step_zero(mesh, jc, with_grad_norm=True, donate=False)(
        p, jz.put_zero_state(jz.init_zero_adam_state(p, 2), mesh, jc), jnp.asarray(x),
        jnp.asarray(y))
    tp = tt.params_from_numpy(params, "cpu")
    tout = tz.train_step_zero(make_mesh((2, 2), ("dp", "sp"), device="cpu"), tc,
                              with_grad_norm=True)(tp, tz.init_zero_adam_state(tp, 2),
                                                   to_torch(x), to_torch(y))
    assert abs(float(tout[3]) - float(jout[3])) <= 1e-5 * float(jout[3])


def test_local_zero_state_is_the_split_of_the_global_one():
    from tpuscratch_torch.comm import P, run_spmd

    _, tc = _cfgs(n_experts=4)
    params = tt.init_params(0, tc, "cpu")
    mesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    spec = tz.zero_state_spec(tc)
    got = run_spmd(mesh, lambda p: tz.local_zero_state(p, 2), (tt.param_spec(tc),), spec)(params)
    want = tz.init_zero_adam_state(params, 2)
    for a, b in zip(tt._leaves(got), tt._leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype and float(a.abs().sum()) == 0


def test_donate_updates_the_flat_moments_in_place():
    _, tc = _cfgs()
    params = tt.init_params(0, tc, "cpu")
    x, y = (to_torch(a) for a in _data())
    mesh = make_mesh((2, 1), ("dp", "sp"), device="cpu")
    opt = tz.init_zero_adam_state(params, 2)
    ptr = opt["mu_flat"].data_ptr()
    _, new, _ = tz.train_step_zero(mesh, tc)(params, opt, x, y)
    assert new["mu_flat"].data_ptr() == ptr and float(new["mu_flat"].abs().sum()) > 0
    opt = tz.init_zero_adam_state(params, 2)
    _, new, _ = tz.train_step_zero(mesh, tc, donate=False)(params, opt, x, y)
    assert new["mu_flat"].data_ptr() != opt["mu_flat"].data_ptr()
    assert float(opt["mu_flat"].abs().sum()) == 0.0


def test_fused_launches_once_a_step_and_once_a_block():
    _, tc = _cfgs()
    params = tt.init_params(0, tc, "cpu")
    x, y = (to_torch(a) for a in _data())
    mesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    for blocks, want in ((0, 1), (4, 4)):
        step = tz.train_step_zero(mesh, tc, overlap_blocks=blocks)
        calls = []
        real = tz.fused_adam_tree
        tz.fused_adam_tree = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            step(params, tz.init_zero_adam_state(params, 2), x, y)
        finally:
            tz.fused_adam_tree = real
        assert len(calls) == want


def test_pack_unpack_roundtrip_equals_jax():
    jc, _ = _cfgs()
    params = _np(jt.init_params(0, dataclasses.replace(jc, n_layers=2)))
    tp = tt.params_from_numpy(params, "cpu")
    n = jt.nonexpert_size(params)
    assert tt.nonexpert_size(tp) == n
    flat = tt.pack_nonexpert(tp, n + 13)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jt.pack_nonexpert(params, n + 13)))
    for a, b in zip(tt.expert_leaves(tp), jt.expert_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tt.unpack_nonexpert(flat, tt.expert_leaves(tp), tp)
    assert _equal(back, tp)
    # stacked: a (2, 3) mesh's copies, each rank packing its own leaves
    stacked = tt._map(lambda _p, w: w.expand(2, 3, *w.shape), tp)
    sflat = tt.pack_nonexpert(stacked, n, lead=2)
    assert sflat.shape == (2, 3, n) and torch.equal(sflat[1, 2], flat[:n])
    assert tt.nonexpert_size(stacked, lead=2) == n
    assert _equal(tt.unpack_nonexpert(sflat, tt.expert_leaves(stacked), stacked, lead=2), stacked)


@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_sizes_equal_jax(n_dp):
    jc, tc = _cfgs(n_experts=4)
    params = _np(jt.init_params(0, jc))
    tp = tt.params_from_numpy(params, "cpu")
    for n in (0, 1, 7, 2176, 4099):
        assert tz.zero_flat_size(n, n_dp) == jz.zero_flat_size(n, n_dp)
    assert tz.zero_state_bytes_per_rank(tc, tp, n_dp) == \
        jz.zero_state_bytes_per_rank(jc, params, n_dp)
    state = tz.init_zero_adam_state(tp, n_dp)
    want = _np(jz.init_zero_adam_state(params, n_dp))
    assert state["mu_flat"].shape == want["mu_flat"].shape
    assert [tuple(x.shape) for x in state["mu_exp"]] == [x.shape for x in want["mu_exp"]]
    assert tz.zero_state_spec(tc) == jz.zero_state_spec(jc)


def test_reshard_dp4_to_dp2_equals_jax():
    jc, _ = _cfgs(n_experts=4)
    params = _np(jt.init_params(0, jc))
    rng = np.random.default_rng(7)
    opt = _np(jz.init_zero_adam_state(params, 4))
    n = jt.nonexpert_size(params)
    for key in ("mu_flat", "nu_flat"):
        opt[key] = np.zeros_like(opt[key])
        opt[key][:n] = rng.standard_normal(n).astype(np.float32)
    saved, live = {"dp": 4, "sp": 1, "pp": 1, "n_micro": 1}, {"dp": 2, "sp": 2, "pp": 1,
                                                               "n_micro": 1}
    want = jz.reshard_state(opt, params, saved, live)
    got = tz.reshard_state(opt, tt.params_from_numpy(params, "cpu"), saved, live)
    for key in ("mu_flat", "nu_flat"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert tz.reshard_state(opt, params, saved, saved) is opt


def test_reshard_pp_stage_regroup_equals_jax():
    jc, _ = _cfgs(n_experts=4)
    stacked = _np(jt.stack_layers(jt.init_params(0, dataclasses.replace(jc, n_layers=4))))
    n = jt.nonexpert_size(stacked)
    rng = np.random.default_rng(8)
    saved, live = {"dp": 2, "sp": 1, "pp": 2, "n_micro": 2}, {"dp": 1, "sp": 1, "pp": 4,
                                                               "n_micro": 2}
    flat_a = jz.zero_flat_size(n // 2, 2)
    opt = {"mu_flat": np.zeros(2 * flat_a, np.float32), "nu_flat": np.zeros(2 * flat_a, np.float32),
           "mu_exp": [], "nu_exp": [], "t": np.asarray(3, np.int32)}
    for key in ("mu_flat", "nu_flat"):
        for s in range(2):
            opt[key][s * flat_a: s * flat_a + n // 2] = rng.standard_normal(n // 2)
    want = jz.reshard_state(opt, stacked, saved, live)
    got = tz.reshard_state(opt, stacked, saved, live)
    for key in ("mu_flat", "nu_flat"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    with pytest.raises(CommError, match="families"):
        tz.reshard_state(opt, stacked, saved, {"dp": 2, "sp": 1, "pp": 1, "n_micro": 1})


def test_counted_wire_bytes_match_the_jax_ledger_2x2():
    jc, tc = _cfgs()
    params = jt.init_params(0, jc)
    mesh = jax_mesh((2, 2), ("dp", "sp"), jax.devices()[:4])
    xj = jnp.zeros((4, 16, 16), jnp.float32)
    tp = tt.params_from_numpy(_np(params), "cpu")
    tmesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    xt = torch.zeros(4, 16, 16)
    for jfn, jopt, tfn, topt in (
            (jz.train_step_zero(mesh, jc, donate=False), jz.init_zero_adam_state(params, 2),
             tz.train_step_zero(tmesh, tc), tz.init_zero_adam_state(tp, 2)),
            (jt.train_step_adam(mesh, jc), jt.init_adam_state(params),
             tt.train_step_adam(tmesh, tc), tt.init_adam_state(tp))):
        want = obs_ledger.grad_sync_wire_bytes(obs_ledger.analyze(jfn, params, jopt, xj, xj))
        with count_wire_bytes() as got:
            tfn(tp, topt, xt, xt)
        assert got.reduce_scatter == want.reduce_scatter
        assert got.all_gather == want.all_gather
        assert got.all_reduce - want.all_reduce == 2 * 3 / 4 * 4
    flat = tz.zero_flat_size(tt.nonexpert_size(tp), 2)
    assert got.all_gather == 0 and want.reduce_scatter == 0  # the replicated step
    with count_wire_bytes() as z:
        tz.train_step_zero(tmesh, tc)(tp, tz.init_zero_adam_state(tp, 2), xt, xt)
    assert z.reduce_scatter == z.all_gather == (2 - 1) * flat // 2 * 4
    assert z.per_microbatch(4) == z.total / 4


def test_grad_sync_regression_guard_dp4():
    _, tc = _cfgs(n_experts=4)
    tp = tt.init_params(0, tc, "cpu")
    mesh = make_mesh((4, 1), ("dp", "sp"), device="cpu")
    x = torch.zeros(8, 8, 16)
    with count_wire_bytes() as rep:
        tt.train_step_adam(mesh, tc)(tp, tt.init_adam_state(tp), x, x)
    with count_wire_bytes() as zero:
        tz.train_step_zero(mesh, tc)(tp, tz.init_zero_adam_state(tp, 4), x, x)
    assert rep.grad > 0 and zero.reduce_scatter > 0
    assert zero.grad <= 0.55 * rep.grad


def test_throughput_program_zero_accum_runs():
    _, tc = _cfgs()
    mesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    params = tt.init_params(0, tc, "cpu")
    x, y = (to_torch(a) for a in (rand((2, 4, 16, 16), 9), rand((2, 4, 16, 16), 10)))
    _, loss = train_throughput_program(mesh, tc, 2, optimizer="adam", zero=True,
                                       accum_steps=2)(params, x, y)
    assert bool(torch.isfinite(loss))
    r = bench_train(mesh=mesh, cfg=tc, batch=4, seq=16, steps=2, iters=1, fence="block",
                    optimizer="adam", zero=True, accum_steps=2)
    assert r.items_per_s > 0 and "zero-adam-accum2" in r.name
    with pytest.raises(ValueError, match="optimizer"):
        train_throughput_program(mesh, tc, 1, zero=True)
    with pytest.raises(ValueError, match="ZeRO"):
        train_throughput_program(mesh, tc, 1, optimizer="adam", accum_steps=2)


def test_levers_not_ported_raise():
    """The ZeRO step's ``guard=`` and ``counter=`` levers (once refused here)
    against the JAX guarded ZeRO step on 2x2: the same statuses, losses
    1e-5 relative and params 1e-5 (this file's tolerances) on a clipped
    step; a skipped step keeps params, flat shards, expert moments and the
    step count bit for bit (a guarded step writes no moment in place); the
    counter counts one build."""
    from tpuscratch_torch.obs import CompileCounter

    jc, tc = _cfgs()
    dims = (2, 2)
    params = _np(jt.init_params(0, jc))
    x, y = _data()
    bad = x.copy()
    bad[1, 2, 3] = np.nan
    jmesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:4])
    guard = (1e-3, 1e30)
    jfn = jz.train_step_zero(jmesh, jc, lr=0.01, donate=False, guard=guard)
    counter = CompileCounter()
    tfn = tz.train_step_zero(make_mesh(dims, ("dp", "sp"), device="cpu"), tc, lr=0.01,
                             guard=guard, counter=counter)
    jo0 = jz.put_zero_state(jz.init_zero_adam_state(jax.tree_util.tree_map(jnp.asarray, params),
                                                    2), jmesh, jc)
    for xb, want in ((x, 1), (bad, 2)):
        jp, jo, jl, _, js = jfn(jax.tree_util.tree_map(jnp.asarray, params), jo0,
                                jnp.asarray(xb), jnp.asarray(y), jnp.float32(np.nan))
        p0 = tt.params_from_numpy(params, "cpu")
        o0 = tz.zero_state_from_numpy(_np(jz.init_zero_adam_state(params, 2)), "cpu")
        tp, to, tl, _, ts = tfn(p0, o0, to_torch(xb), to_torch(y), torch.tensor(np.nan))
        assert int(js) == int(ts) == want
        if want == 2:
            assert _equal(tp, p0) and _equal(to, o0) and int(to["t"]) == 0
        else:
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
            for a, (_, b) in zip(jax.tree_util.tree_leaves(jp), tt._jax_paths(tp)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
            assert int(to["t"]) == int(jo["t"]) == 1
    assert counter.count == 1


def test_config13_emits_the_jax_rows_keys():
    out = []
    config13_zero_train(out, iters=1, device="cpu")
    rows = {r["metric"]: r for r in out}
    assert sorted(rows) == ["zero_accum_sweep", "zero_vs_replicated_dp1",
                            "zero_vs_replicated_dp2", "zero_vs_replicated_dp4"]
    for dp in (1, 2, 4):
        r = rows[f"zero_vs_replicated_dp{dp}"]
        for key in ("dp", "grad_sync_bytes_replicated", "grad_sync_bytes_zero", "grad_ratio",
                    "zero_all_gather_bytes", "repl_tokens_per_s", "zero_tokens_per_s",
                    "peak_mem_bytes", "zero_state_bytes_per_rank"):
            assert key in r
        assert r["peak_mem_bytes"] is None  # a CPU run reports no device memory
    assert rows["zero_vs_replicated_dp4"]["grad_ratio"] <= 0.55
    sweep = rows["zero_accum_sweep"]["sweep"]
    assert [e["accum"] for e in sweep] == [1, 2, 4]
    # one sync an update, so bytes a microbatch fall as 1/k (the loss's own
    # scalar all-reduce, 6 B a microbatch, aside)
    per = [e["sync_bytes_per_microbatch"] for e in sweep]
    for k, b in zip((1, 2, 4), per):
        assert abs(k * b - per[0]) <= 6 * k


def test_kernel_path_needs_contiguous_rows_only_to_write():
    # the stacked P(dp) moments of a |sp| > 1 mesh are copies: read, not written
    w = torch.zeros(2, 1, 8)
    assert tadam.writable_rows(w, 2)
    assert not tadam.writable_rows(torch.zeros(2, 1, 8).expand(2, 3, 8), 2)
