"""tpuscratch_torch's 2D multigrid (``solvers.multigrid``) against
tpuscratch's on the same seeded inputs, on the CPU.

The operator, the smoothers and the transfers run the JAX functions'
operations in their order on data the exchange only moves. The operator
and red-black GS (no product that is not exact) are held bit for bit on a
2x2 mesh; where a product meets a sum (damped Jacobi, the transfers'
weighted sums, a V-cycle), XLA:CPU contracts the two into an FMA while
the port rounds the product (as the card does), an ulp an operation, so
those are held to 1e-5 of max|value|. A solve adds allreduced sums in another
order (torch's against XLA's), which can move the f32 residual across the
stopping threshold by one cycle: cycles within 1 and x within 1e-4 of
max|x| (the JAX tests' mesh-invariance bounds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import rand, to_torch
from tpuscratch.comm import run_spmd as jax_run_spmd
from tpuscratch.runtime.mesh import make_mesh_2d as jax_mesh_2d
from tpuscratch.solvers import multigrid as jm
from tpuscratch.solvers.spectral import periodic_laplacian_np
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.runtime.mesh import make_mesh_2d, topology_of
from tpuscratch_torch.solvers import multigrid as tm

DIMS = (2, 2)
TILES = JP("row", "col", None, None)


def _specs(world, dims=DIMS):
    b = np.zeros(world, np.float32)
    return (jm._mg_prologue(b, jax_mesh_2d(dims), None)[3],
            tm._mg_prologue(b, make_mesh_2d(dims, device="cpu"), None)[3])


def _jax(fn, *tiles, dims=DIMS):
    """``fn`` of every rank's tiles under shard_map (one tile each)."""
    prog = jax_run_spmd(jax_mesh_2d(dims), lambda *t: fn(*(x[0, 0] for x in t))[None, None],
                        (TILES,) * len(tiles), TILES)
    return np.asarray(prog(*(jnp.asarray(t) for t in tiles)))


@pytest.mark.parametrize("what", ["laplacian", "jacobi", "rbgs", "rbgs-reverse",
                                  "restrict", "prolong", "v_cycle"])
def test_level_ops_twin(what):
    world = (32, 48)
    js, ts = _specs(world)
    u, f = rand(DIMS + (16, 24), 1), rand(DIMS + (16, 24), 2)
    e = rand(DIMS + (8, 12), 3)
    cases = {
        "laplacian": (lambda s, sp, a: s.periodic_laplacian(a, sp[0]), (u,)),
        "jacobi": (lambda s, sp, a, b: s.jacobi_smooth(a, b, sp[0], 0.8, 3), (u, f)),
        "rbgs": (lambda s, sp, a, b: s.rbgs_smooth(a, b, sp[0], 2), (u, f)),
        "rbgs-reverse": (lambda s, sp, a, b: s.rbgs_smooth(a, b, sp[0], 2, reverse=True),
                         (u, f)),
        "restrict": (lambda s, sp, a: s.restrict_fw(a, sp[0]), (u,)),
        "prolong": (lambda s, sp, a: s.prolong_bilinear(a, sp[1]), (e,)),
        "v_cycle": (lambda s, sp, a, b: s.v_cycle(a, b, sp, 0, 2, 8, 0.8, "rbgs"), (u, f)),
    }
    fn, args = cases[what]
    want = _jax(lambda *a: fn(jm, js, *a), *args)
    got = fn(tm, ts, *(to_torch(a) for a in args)).numpy()
    if what in ("laplacian", "rbgs", "rbgs-reverse"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_transfers_are_adjoint():
    """<P e, r>_fine == 4 <e, R r>_coarse (R = P^T / 4), on 2x2."""
    _, ts = _specs((32, 32))
    e, r = to_torch(rand(DIMS + (8, 8), 4)), to_torch(rand(DIMS + (16, 16), 5))
    lhs = (tm.prolong_bilinear(e, ts[1]) * r).double().sum()
    rhs = 4.0 * (e * tm.restrict_fw(r, ts[0])).double().sum()
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5)


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
@pytest.mark.parametrize("solver", ["mg_poisson_solve", "pcg_poisson_solve"])
def test_solve_twin(dims, solver):
    b = rand((64, 64), 6)
    b -= b.mean()
    xj, kj, rj = getattr(jm, solver)(b, jax_mesh_2d(dims), tol=1e-6)
    xt, kt, rt = getattr(tm, solver)(b, make_mesh_2d(dims, device="cpu"), tol=1e-6)
    assert abs(kt - kj) <= 1, (kt, kj)
    assert rt <= 2.5e-6
    assert np.abs(xt - xj).max() <= 1e-4 * np.abs(xj).max()
    assert abs(xt.mean()) < 1e-5
    assert np.abs(periodic_laplacian_np(xt.astype(np.float64)) - b).max() < 1e-4


def test_jacobi_smoother_and_odd_coarsest_twin():
    # 48 = 3 * 16: the coarsest level is 3x3, where rbgs falls back to
    # Jacobi; and the Jacobi smoother throughout
    b = rand((48, 48), 7)
    b -= b.mean()
    for smoother in ("rbgs", "jacobi"):
        xj, kj, _ = jm.mg_poisson_solve(b, jax_mesh_2d((1, 1)), tol=1e-6, smoother=smoother)
        xt, kt, rt = tm.mg_poisson_solve(b, make_mesh_2d((1, 1), device="cpu"), tol=1e-6,
                                         smoother=smoother)
        assert abs(kt - kj) <= 1 and rt <= 2.5e-6
        assert np.abs(xt - xj).max() <= 1e-4 * np.abs(xj).max()


def test_unconverged_warns_and_refusals():
    b = rand((32, 32), 8)
    mesh = make_mesh_2d((1, 1), device="cpu")
    with pytest.warns(RuntimeWarning, match="did not reach tol"):
        _, k, _ = tm.mg_poisson_solve(b, mesh, tol=1e-6, max_cycles=1)
    assert k == 1
    with pytest.raises(ValueError, match="unknown smoother"):
        tm.mg_poisson_solve(b, mesh, smoother="sor")
    with pytest.raises(ValueError, match="does not support"):
        tm.mg_poisson_solve(b, mesh, levels=7)
    spec = tm.level_specs(TileLayout(5, 8, 1, 1), topology_of(mesh, periodic=True),
                          mesh.axis_names, 1)[0]
    with pytest.raises(ValueError, match="even core"):
        tm.rbgs_smooth(torch.zeros(1, 1, 5, 8), torch.zeros(1, 1, 5, 8), spec, 1)
    if not torch.cuda.is_available():
        for fn in (tm.mg_poisson_solve, tm.pcg_poisson_solve):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(b)
