"""tpuscratch_torch's 3D multigrid (``solvers.multigrid3d``) against
tpuscratch's on the same seeded inputs, on the CPU.

The level operations run the JAX functions' operations in their order,
but XLA:CPU contracts a product and a sum into an FMA (the operator's 6u,
damped Jacobi, the transfers' weighted sums) and divides red-black GS's
sums by 6 as a product by the rounded 1/6, while the port rounds as
written (as the card does): an ulp an operation, so they are held to 1e-5
of max|value| on a 2x2x2 mesh. The streamed smoother runs the
JAX package's Pallas kernel in the Mosaic interpreter and the port's plain
version: the kernel test's ``rtol 1e-5, atol 1e-6``. The deep (s-step)
smoothers are held bit for bit to the port's per-sweep ones, as the JAX
package's own tests hold its. A solve sums in another order: cycles
within 1, x within 1e-4 of max|x| (the JAX tests' bounds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import rand, to_torch
from tpuscratch.comm import run_spmd as jax_run_spmd
from tpuscratch.halo.halo3d import decompose3d_cores as jax_decompose3d_cores
from tpuscratch.runtime.mesh import make_mesh as jax_make_mesh
from tpuscratch.solvers import multigrid3d as jm
from tpuscratch_torch.comm.spmd import mesh_context
from tpuscratch_torch.halo.halo3d import HaloSpec3D, TileLayout3D
from tpuscratch_torch.ops import stencil_stream as ss
from tpuscratch_torch.runtime.mesh import make_mesh, topology_of
from tpuscratch_torch.solvers import multigrid3d as tm

AXES = ("z", "row", "col")
TILES3 = JP("z", "row", "col", None, None, None)
CUBE = (2, 2, 2)
OMEGA = 6 / 7


def _lap3(x):
    return 6 * x - sum(np.roll(x, s, a) for a in range(3) for s in (1, -1))


def _meshes(dims):
    return jax_make_mesh(dims, AXES), make_mesh(dims, AXES, device="cpu")


def _specs(world, dims=CUBE):
    b = np.zeros(world, np.float32)
    jmesh, mesh = _meshes(dims)
    return jm._mg_prologue3(b, jmesh, None)[2], tm._mg_prologue3(b, mesh, None)[2], mesh


def _jax(dims, fn, *tiles):
    prog = jax_run_spmd(jax_make_mesh(dims, AXES),
                        lambda *t: fn(*(x[0, 0, 0] for x in t))[None, None, None],
                        (TILES3,) * len(tiles), TILES3)
    return np.asarray(prog(*(jnp.asarray(t) for t in tiles)))


def _port(mesh, fn, *tiles):
    with mesh_context(mesh):
        return fn(*(to_torch(t) for t in tiles)).numpy()


def _cores(world, dims, seed):
    return jax_decompose3d_cores(rand(world, seed), dims)


@pytest.mark.parametrize("what", ["laplacian", "jacobi", "rbgs", "rbgs-reverse",
                                  "restrict", "prolong", "v_cycle"])
def test_level_ops_twin(what):
    world = (16, 16, 32)
    js, ts, mesh = _specs(world)
    u, f = _cores(world, CUBE, 1), _cores(world, CUBE, 2)
    e = _cores((8, 8, 16), CUBE, 3)
    cases = {
        "laplacian": (lambda m, sp, a: m.periodic_laplacian3(a, sp[0][0]), (u,)),
        "jacobi": (lambda m, sp, a, b: m.jacobi_smooth3(a, b, sp[0][0], OMEGA, 3), (u, f)),
        "rbgs": (lambda m, sp, a, b: m.rbgs_smooth3(a, b, sp[0][0], 2), (u, f)),
        "rbgs-reverse": (lambda m, sp, a, b: m.rbgs_smooth3(a, b, sp[0][0], 2, reverse=True),
                         (u, f)),
        "restrict": (lambda m, sp, a: m.restrict_fw3(a, sp[0][1]), (u,)),
        "prolong": (lambda m, sp, a: m.prolong_trilinear(a, sp[1][1]), (e,)),
        "v_cycle": (lambda m, sp, a, b: m.v_cycle3(a, b, sp, 0, 2, 8, OMEGA, "rbgs"), (u, f)),
    }
    fn, args = cases[what]
    want = _jax(CUBE, lambda *a: fn(jm, js, *a), *args)
    got = _port(mesh, lambda *a: fn(tm, ts, *a), *args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_transfers_are_adjoint():
    """<P e, r>_fine == 8 <e, R r>_coarse (R = P^T / 8), on 2x2x2."""
    _, ts, _ = _specs((16, 16, 16))
    e, r = to_torch(_cores((8, 8, 8), CUBE, 4)), to_torch(_cores((16, 16, 16), CUBE, 5))
    lhs = (tm.prolong_trilinear(e, ts[1][1]) * r).double().sum()
    rhs = 8.0 * (e * tm.restrict_fw3(r, ts[0][1])).double().sum()
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5)


def _faces_spec(core, dims=CUBE, periodic=True):
    mesh = make_mesh(dims, AXES, device="cpu")
    return HaloSpec3D(TileLayout3D(core, (1, 1, 1)), topology_of(mesh, periodic=periodic),
                      AXES, 6), mesh


@pytest.mark.parametrize("sweeps,s", [(4, 2), (5, 2), (4, 4), (3, 3)])
def test_jacobi_deep_bit_identical(sweeps, s):
    spec, mesh = _faces_spec((8, 8, 8))
    u, f = _cores((16,) * 3, CUBE, 6), _cores((16,) * 3, CUBE, 7)
    shal = _port(mesh, lambda a, b: tm.jacobi_smooth3(a, b, spec, OMEGA, sweeps), u, f)
    deep = _port(mesh, lambda a, b: tm.jacobi_smooth3_deep(a, b, spec, OMEGA, sweeps, s), u, f)
    np.testing.assert_array_equal(deep, shal)


@pytest.mark.parametrize("sweeps,s,rev", [(4, 2, False), (3, 2, True), (4, 3, False)])
def test_rbgs_deep_bit_identical(sweeps, s, rev):
    spec, mesh = _faces_spec((8, 8, 8))
    u, f = _cores((16,) * 3, CUBE, 8), _cores((16,) * 3, CUBE, 9)
    shal = _port(mesh, lambda a, b: tm.rbgs_smooth3(a, b, spec, sweeps, rev), u, f)
    deep = _port(mesh, lambda a, b: tm.rbgs_smooth3_deep(a, b, spec, sweeps, s, rev), u, f)
    np.testing.assert_array_equal(deep, shal)


@pytest.mark.parametrize("dims,sweeps", [((1, 1, 1), 2), ((1, 1, 1), 5), ((2, 1, 1), 2)])
def test_jacobi_smooth3_stream_twin(dims, sweeps):
    # a (16, 8, 128) z-slab core: the streamed smoother's own level shape
    core = (16, 8, 128)
    world = tuple(c * d for c, d in zip(core, dims))
    js, ts, mesh = _specs(world, dims)
    u, f = _cores(world, dims, 10), _cores(world, dims, 11)
    assert jm._stream_smoothable(js[0][0], sweeps) and tm._stream_smoothable(ts[0][0], sweeps)
    want = _jax(dims, lambda a, b: jm.jacobi_smooth3_stream(a, b, js[0][0], OMEGA, sweeps), u, f)
    got = _port(mesh, lambda a, b: tm.jacobi_smooth3_stream(a, b, ts[0][0], OMEGA, sweeps), u, f)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the same sweeps through the port's per-sweep smoother (another op order)
    plain = _port(mesh, lambda a, b: tm.jacobi_smooth3(a, b, ts[0][0], OMEGA, sweeps), u, f)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1)])
def test_jacobi_stream_solve_counts_its_passes(monkeypatch, dims):
    """The streamed smoother converges like plain Jacobi (the JAX test's
    bounds), and it calls the streamed kernel's wrapper exactly
    ``stream_launches(specs)`` times a cycle — the count chip_smoke.py
    holds the card's launches to."""
    calls = []
    real = ss.seven_point_streamed_pallas

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ss, "seven_point_streamed_pallas", counted)
    b = rand((64, 16, 128), 12)
    b -= b.mean()
    mesh = make_mesh(dims, AXES, device="cpu")
    xj, cj, _ = tm.mg_poisson3d_solve(b, mesh, tol=1e-6, smoother="jacobi")
    assert not calls
    xs, cs, rs = tm.mg_poisson3d_solve(b, mesh, tol=1e-6, smoother="jacobi-stream")
    specs = tm._mg_prologue3(b, mesh, None)[2]
    per_cycle = tm.stream_launches(specs)
    assert per_cycle == 2 * sum(tm._stream_smoothable(s6, 2) for s6, _ in specs[:-1]) > 0
    assert len(calls) == per_cycle * cs
    assert rs <= 2.5e-6 and abs(cs - cj) <= 1
    assert np.abs(xs - xj).max() < 1e-4


@pytest.mark.parametrize("solver", ["mg_poisson3d_solve", "pcg_poisson3d_solve"])
def test_solve_twin(solver):
    b = rand((16, 16, 16), 13)
    b -= b.mean()
    jmesh, mesh = _meshes(CUBE)
    xj, kj, _ = getattr(jm, solver)(b, jmesh, tol=1e-6)
    xt, kt, rt = getattr(tm, solver)(b, mesh, tol=1e-6)
    assert abs(kt - kj) <= 1, (kt, kj)
    assert rt <= 2.5e-6 and 4 <= kt <= 14
    assert np.abs(xt - xj).max() <= 1e-4 * np.abs(xj).max()
    assert np.abs(_lap3(xt.astype(np.float64)) - b).max() < 1e-4
    assert abs(xt.mean()) < 1e-5


def test_s_step_same_cycles_and_solution():
    b = rand((16, 16, 16), 14)
    b -= b.mean()
    mesh = make_mesh(CUBE, AXES, device="cpu")
    x1, c1, _ = tm.mg_poisson3d_solve(b, mesh, tol=1e-6)
    x2, c2, r2 = tm.mg_poisson3d_solve(b, mesh, tol=1e-6, s_step=2)
    # the deep smoothers are bit-identical and eager torch fuses nothing
    assert c1 == c2 and r2 <= 2.5e-6
    np.testing.assert_array_equal(x1, x2)


def test_refusals():
    spec, mesh = _faces_spec((8, 8, 128), (2, 1, 1), periodic=False)
    z = torch.zeros((2, 1, 1, 8, 8, 128))
    with mesh_context(mesh):
        for call in (lambda: tm.jacobi_smooth3_deep(z, z, spec, OMEGA, 4, 2),
                     lambda: tm.rbgs_smooth3_deep(z, z, spec, 4, 2),
                     lambda: tm.jacobi_smooth3_stream(z, z, spec, OMEGA, 2)):
            with pytest.raises(ValueError, match="periodic-only"):
                call()
    spec, _ = _faces_spec((8, 8, 8))
    z = torch.zeros(CUBE + (8, 8, 8))
    with pytest.raises(ValueError, match="deeper than core"):
        tm.jacobi_smooth3_deep(z, z, spec, OMEGA, 9, 9)
    with pytest.raises(ValueError, match="ghost depth"):
        tm.rbgs_smooth3_deep(z, z, spec, 8, 5)
    odd, _ = _faces_spec((5, 8, 8))
    with pytest.raises(ValueError, match="even core"):
        tm.rbgs_smooth3(torch.zeros(CUBE + (5, 8, 8)), torch.zeros(CUBE + (5, 8, 8)), odd, 1)
    b = rand((16, 16, 16), 15)
    with pytest.raises(ValueError, match="unknown smoother"):
        tm.mg_poisson3d_solve(b, device="cpu", smoother="sor")
    with pytest.raises(ValueError, match="not divisible"):
        tm.mg_poisson3d_solve(rand((15, 16, 16), 16), make_mesh(CUBE, AXES, device="cpu"))
    if not torch.cuda.is_available():
        for fn in (tm.mg_poisson3d_solve, tm.pcg_poisson3d_solve):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(b)
