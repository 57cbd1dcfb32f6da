"""The port's ledger (``tpuscratch_torch.obs.ledger``) against the JAX
package's: the analytic formulas and ``CollectiveOp.wire_bytes``; the KV
byte counts; ``roofline``; and ``analyze``, which runs a program once on
the stacked mesh, against the JAX ``analyze``, which reads the compiled
program's HLO on the 8 virtual CPU devices.

Tolerances: every count, payload, group size and wire byte is held EQUAL
(psum, all_gather, reduce_scatter, all_to_all and ppermute on 1D and 2x2
meshes; the 2D halo exchange; CG's all-reduces; the s-step smoother's
``collective-permute`` count and bytes a sweep at s 1 and 2, 16 sweeps,
on 2x2x2, 2x2x1 and 1x1x1 — the self-wrap axes the JAX per-sweep
exchange still sends through a ``ppermute`` — at 8^3 a rank, and on
2x2x2 at config 15's 32^3). A matmul program's flops are within 1% of
XLA's ``cost_analysis``; ``roofline``'s rates and fractions are equal to
1e-12 relative (float division in the same order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from tpuscratch.comm import run_spmd as jax_spmd
from tpuscratch.halo.exchange import HaloSpec as JHaloSpec
from tpuscratch.halo.exchange import halo_exchange as jax_exchange
from tpuscratch.halo.halo3d import HaloSpec3D as JSpec3D
from tpuscratch.halo.halo3d import TileLayout3D as JLayout3D
from tpuscratch.halo.layout import TileLayout as JTileLayout
from tpuscratch.obs import ledger as jl
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.runtime.mesh import topology_of as jax_topology_of
from tpuscratch.solvers import multigrid3d as jmg3
from tpuscratch.solvers.cg import _poisson_program as jax_cg_program
from tpuscratch_torch.comm import collectives as tc
from tpuscratch_torch.comm import p2p as tp2p
from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.halo.driver import _setup, decompose
from tpuscratch_torch.halo.exchange import HaloSpec, halo_exchange
from tpuscratch_torch.halo.halo3d import HaloSpec3D, TileLayout3D
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.obs import ledger as tl
from tpuscratch_torch.runtime.mesh import make_mesh, topology_of
from tpuscratch_torch.solvers import multigrid3d as tmg3
from tpuscratch_torch.solvers.cg import _poisson_program

torch.set_num_threads(1)


def _ops(led):
    return [(o.kind, o.payload_bytes, o.group_size, o.wire_bytes) for o in led.collectives]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("payload", [0, 4, 512, 1000, 4096])
def test_formulas_equal(n, payload):
    for name in ("ring_all_reduce_wire_bytes", "all_gather_wire_bytes",
                 "reduce_scatter_wire_bytes", "all_to_all_wire_bytes"):
        assert getattr(tl, name)(n, payload) == getattr(jl, name)(n, payload)
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert tl.CollectiveOp(kind, payload, n).wire_bytes == \
            jl.CollectiveOp(kind, payload, n).wire_bytes


def _kv_trees():
    rng = np.random.default_rng(3)
    L, pages, page, H, D = 2, 6, 4, 3, 8
    np_tree = {"k": rng.standard_normal((L, pages, page, H, D)).astype(np.float32),
               "v": rng.standard_normal((L, pages, page, H, D)).astype(np.float32)}
    q_tree = {"k": np_tree["k"].astype(np.int8), "v": np_tree["v"].astype(np.int8),
              "k_scale": np.ones((L, pages, H), np.float32),
              "v_scale": np.ones((L, pages, H), np.float32)}
    return [({k: jnp.asarray(v) for k, v in t.items()},
             {k: torch.from_numpy(v) for k, v in t.items()}) for t in (np_tree, q_tree)]


def test_kv_bytes_and_host_traffic_equal():
    for jtree, ttree in _kv_trees():
        assert tl.kv_cache_bytes(ttree) == jl.kv_cache_bytes(jtree)
        assert tl.kv_page_bytes(ttree) == jl.kv_page_bytes(jtree)
        assert tl.kv_host_traffic_bytes(ttree, 5, 7) == \
            tl.KVHostTraffic(**vars(jl.kv_host_traffic_bytes(jtree, 5, 7)))
        assert tl.kv_host_traffic_bytes(ttree, 5, 7).per_token(3) == \
            jl.kv_host_traffic_bytes(jtree, 5, 7).per_token(3)
    # one definition: the serving cache and engine count with the ledger's
    from tpuscratch_torch.serve import engine, kvcache
    assert kvcache.kv_cache_bytes is tl.kv_cache_bytes
    assert engine.kv_cache_bytes is tl.kv_cache_bytes


def test_roofline_and_grad_sync_equal():
    ops = [("all-reduce", 4096, 4), ("reduce-scatter", 1024, 4), ("all-gather", 4096, 4),
           ("collective-permute", 512, 8)]
    jled = jl.Ledger(tuple(jl.CollectiveOp(*o) for o in ops), 3.2e9, 1.5e8)
    tled = tl.Ledger(tuple(tl.CollectiveOp(*o) for o in ops), 3.2e9, 1.5e8)
    assert vars(tl.grad_sync_wire_bytes(tled)) == vars(jl.grad_sync_wire_bytes(jled))
    assert tled.summary() == jled.summary()
    for peaks in ({}, dict(peak_flops_per_s=6.7e13, peak_hbm_bytes_per_s=3.35e12,
                           peak_wire_bytes_per_s=4.5e11)):
        a = tl.roofline(tled, 0.0123, executions=3, **peaks)
        b = jl.roofline(jled, 0.0123, executions=3, **peaks)
        for f in ("measured_s", "flops_per_s", "hbm_bytes_per_s", "wire_bytes_per_s",
                  "flops_fraction", "hbm_fraction", "wire_fraction"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or x == pytest.approx(y, rel=1e-12), f
        assert a.bound == b.bound and a.summary() == b.summary()
    with pytest.raises(ValueError):
        tl.roofline(tled, 0.0)


# ---- analyze: the collectives of one run against the compiled program's ----------

MESHES = [((8,), ("x",), "x"), ((4,), ("x",), "x"), ((2, 2), ("a", "b"), "b"),
          ((2, 2), ("a", "b"), ("a", "b"))]


def _axis_n(dims, names, ax):
    sizes = dict(zip(names, dims))
    return int(np.prod([sizes[a] for a in ((ax,) if isinstance(ax, str) else ax)]))


def _programs(dims, names, ax):
    """(jax fn, port fn) pairs over a (16, 8) block a rank."""
    n = _axis_n(dims, names, ax)
    ring = [(i, (i + 1) % n) for i in range(n)]
    return {
        "psum": (lambda a: lax.psum(a, ax), lambda a: tc.allreduce_sum(a, ax)),
        "all_gather": (lambda a: lax.all_gather(a, ax, tiled=True)[: a.shape[0]],
                       lambda a: tc.all_gather(a, ax, tiled=True)[..., :16, :]),
        "reduce_scatter": (
            lambda a: jnp.tile(lax.psum_scatter(a, ax, scatter_dimension=0, tiled=True), (n, 1)),
            lambda a: torch.cat([tc.reduce_scatter(a, ax, 0, tiled=True)] * n, dim=-2)),
        "all_to_all": (lambda a: lax.all_to_all(a, ax, 0, 0, tiled=True),
                       lambda a: tc.all_to_all(a, ax, 0, 0, tiled=True)),
        "ppermute": (lambda a: lax.ppermute(a, ax, ring),
                     lambda a: tp2p.ppermute(a, ax, ring)),
        "ppermute_then_psum": (
            lambda a: lax.psum(lax.ppermute(a * 2, ax, [(0, 1), (1, 0)]) + 1, ax),
            lambda a: tc.allreduce_sum(tp2p.ppermute(a * 2, ax, [(0, 1), (1, 0)]) + 1, ax)),
    }


@pytest.mark.parametrize("dims,names,ax", MESHES)
def test_analyze_collectives_equal(dims, names, ax):
    n = int(np.prod(dims))
    x = np.random.default_rng(0).standard_normal((n * 16, 8)).astype(np.float32)
    split = names if len(names) > 1 else names[0]
    jmesh = jax_mesh(dims, names, jax.devices()[:n])
    tmesh = make_mesh(dims, names, device="cpu")
    for name, (jf, tf) in _programs(dims, names, ax).items():
        jprog = jax_spmd(jmesh, jf, JP(split, None), JP(split, None))
        jled = jl.analyze(jprog, x)
        prog = run_spmd(tmesh, tf, P(split, None), P(split, None))
        tled = tl.analyze(prog, torch.from_numpy(x))
        assert _ops(tled) == _ops(jled), name
        assert tled.wire_bytes() == jled.wire_bytes() and tled.counts() == jled.counts(), name
        # the two programs compute the same thing
        np.testing.assert_allclose(prog(torch.from_numpy(x)).numpy(), np.asarray(jprog(x)),
                                   rtol=1e-6, atol=1e-5)


def test_wire_byte_counter_legs_unchanged_by_recording():
    """``count_wire_bytes``' legs and op counts read as before while a
    ledger records the same calls (configs 13 and 14 read them)."""
    mesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    x = torch.randn(4 * 16, 8)

    def body(a):
        a = tc.allreduce_sum(a, "dp")
        a = torch.cat([tc.reduce_scatter(a, "dp", 0, tiled=True)] * 2, dim=-2)
        a = tc.all_gather(a, "sp", tiled=True)[..., :16, :]
        return tc.all_to_all(tp2p.ppermute(a, "sp", [(0, 1), (1, 0)]), "dp", 0, 0, tiled=True)

    prog = run_spmd(mesh, body, P(("dp", "sp"), None), P(("dp", "sp"), None))
    with tc.count_wire_bytes() as plain:
        prog(x)
    with tc.count_wire_bytes() as wb:
        led = tl.analyze(prog, x)
    assert vars(wb) == vars(plain)
    assert (wb.all_reduce, wb.reduce_scatter, wb.all_gather) == (512.0, 256.0, 512.0)
    assert wb.ops == {"all_reduce": 1, "reduce_scatter": 1, "all_gather": 1}
    assert vars(tl.grad_sync_wire_bytes(led)) == {"all_reduce": 512.0, "reduce_scatter": 256.0,
                                                  "all_gather": 512.0}
    assert led.count("all-to-all") == 1 and led.count("collective-permute") == 1


def test_matmul_flops_within_one_percent_and_bytes():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((96, 128)).astype(np.float32)
    b = rng.standard_normal((128, 80)).astype(np.float32)
    jled = jl.analyze(jax.jit(lambda u, v: jnp.tanh(u @ v) @ v.T), a, b)
    tled = tl.analyze(lambda u, v: torch.tanh(u @ v) @ v.T, torch.from_numpy(a),
                      torch.from_numpy(b))
    assert tled.flops == pytest.approx(jled.flops, rel=0.01)
    assert tled.flops == 2 * 96 * 128 * 80 * 2
    # bytes accessed: the inputs read once and the output written once
    assert tled.bytes_accessed == (a.nbytes + b.nbytes + 96 * 128 * 4)
    assert tled.collectives == ()


@pytest.mark.parametrize("dims,periodic", [((2, 2), True), ((2, 1), True), ((1, 1), True),
                                           ((2, 2), False)])
def test_halo_exchange_transfers_equal(dims, periodic):
    """Each transfer of the 2D plan is one collective-permute, self-wrap
    ones included, as the JAX executor sends each through a ppermute."""
    lay = (12, 10, 2, 1)
    n = int(np.prod(dims))
    jmesh = jax_mesh(dims, ("row", "col"), jax.devices()[:n])
    jspec = JHaloSpec(layout=JTileLayout(*lay), topology=jax_topology_of(jmesh, periodic))
    tmesh = make_mesh(dims, ("row", "col"), device="cpu")
    tspec = HaloSpec(layout=TileLayout(*lay), topology=topology_of(tmesh, periodic))
    ph, pw = TileLayout(*lay).padded_shape
    tiles = np.random.default_rng(2).standard_normal(dims + (ph, pw)).astype(np.float32)
    sp = JP("row", "col", None, None)
    jled = jl.analyze(jax_spmd(jmesh, lambda t: jax_exchange(t[0, 0], jspec)[None, None],
                               sp, sp), tiles)
    tled = tl.analyze(halo_exchange, torch.from_numpy(tiles), tspec)
    assert tled.count("collective-permute") == jled.count("collective-permute") == 8
    # XLA schedules the 8 independent transfers in an order of its own
    assert sorted(_ops(tled)) == sorted(_ops(jled))


def test_cg_allreduces_equal():
    """One init plus one loop body: the JAX while body appears once; the
    port's run with max_iters=1 makes exactly one iteration."""
    n2, tol = 32, 1e-5
    b2 = np.random.default_rng(4).standard_normal((n2, n2)).astype(np.float32)
    jmesh = jax_mesh((2, 2), ("row", "col"), jax.devices()[:4])
    from tpuscratch.halo.driver import _setup as jax_setup
    jm, jtopo, _, jspec = jax_setup((n2, n2), jmesh, (1, 1), periodic=False, neighbors=4)
    tmesh = make_mesh((2, 2), ("row", "col"), device="cpu")
    tm, ttopo, tlay, tspec = _setup((n2, n2), tmesh, (1, 1), periodic=False, neighbors=4)
    flat = TileLayout(tlay.core_h, tlay.core_w, 0, 0)
    bt = torch.from_numpy(decompose(b2, ttopo, flat))
    want = {"cg": (3, 2), "pipelined": (2, 1)}
    for method in ("cg", "pipelined"):
        jled = jl.analyze(jax_cg_program(jm, jspec, tol, 4 * n2, method),
                          jnp.zeros((2, 2, n2 // 2, n2 // 2), jnp.float32))
        tled = tl.analyze(_poisson_program(tm, tspec, tol, 1, method), bt)
        total = tled.count("all-reduce")
        assert (total, total - 1) == want[method] == (jled.count("all-reduce"),
                                                      jled.count("all-reduce") - 1)


@functools.lru_cache(maxsize=None)
def _jax_smoother_ledger(dims, per_chip, s, sweeps):
    n = int(np.prod(dims))
    mesh = jax_mesh(dims, ("z", "row", "col"), jax.devices()[:n])
    spec = JSpec3D(layout=JLayout3D((per_chip,) * 3, (1, 1, 1)),
                   topology=jax_topology_of(mesh, periodic=True), axes=tuple(mesh.axis_names),
                   neighbors=6)
    sp = JP(*mesh.axis_names, None, None, None)
    if s == 1:
        fn, k = (lambda u, f: jmg3.jacobi_smooth3(u, f, spec, 6 / 7, 1)), 1
    else:
        fn, k = (lambda u, f: jmg3.jacobi_smooth3_deep(u, f, spec, 6 / 7, sweeps, s)), sweeps
    prog = jax_spmd(mesh, lambda a, f: fn(a[0, 0, 0], f[0, 0, 0])[None, None, None], (sp, sp), sp)
    arg = jnp.zeros(dims + (per_chip,) * 3, jnp.float32)
    led = jl.analyze(prog, arg, arg)
    return (led.count("collective-permute") / k,
            led.wire_bytes().get("collective-permute", 0.0) / k)


def _port_smoother_ledger(dims, per_chip, s, sweeps):
    mesh = make_mesh(dims, ("z", "row", "col"), device="cpu")
    spec = HaloSpec3D(layout=TileLayout3D((per_chip,) * 3, (1, 1, 1)),
                      topology=topology_of(mesh, periodic=True), axes=tuple(mesh.axis_names),
                      neighbors=6)
    arg = torch.zeros(dims + (per_chip,) * 3)
    if s == 1:
        fn, k = (lambda u, f: tmg3.jacobi_smooth3(u, f, spec, 6 / 7, 1)), 1
    else:
        fn, k = (lambda u, f: tmg3.jacobi_smooth3_deep(u, f, spec, 6 / 7, sweeps, s)), sweeps
    led = tl.analyze(fn, arg, arg)
    return (led.count("collective-permute") / k,
            led.wire_bytes().get("collective-permute", 0.0) / k)


@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 2, 1), (1, 1, 1)])
@pytest.mark.parametrize("s", [1, 2])
def test_s_step_smoother_per_sweep_equal(dims, s):
    got = _port_smoother_ledger(dims, 8, s, 16)
    assert got == _jax_smoother_ledger(dims, 8, s, 16)
    if dims == (1, 1, 1):
        # every pair a self-wrap: the per-sweep exchange still sends 6
        # one-rank ppermutes (no wire bytes), the deep one skips them
        assert got == ((6.0, 0.0) if s == 1 else (0.0, 0.0))


def test_config15_chip_columns_equal():
    """The numbers chip_smoke phase 29 holds config 15's columns to: 32^3 a
    rank on 2x2x2, 16 sweeps."""
    import chip_smoke

    want = chip_smoke.C15_LEDGER
    for s in (1, 2):
        got = _port_smoother_ledger((2, 2, 2), 32, s, 16)
        assert got == _jax_smoother_ledger((2, 2, 2), 32, s, 16)
        assert got == (want[f"ppermutes_per_sweep_s{s}"], want[f"halo_bytes_per_sweep_s{s}"])
