"""tpuscratch_torch's CG solvers (``solvers.cg``) against tpuscratch's on
the same seeded inputs, on the CPU.

The matvec moves data and runs the JAX function's operations in its
order, so ``dirichlet_laplacian`` is bit-equal. A solve's inner products
are sums whose order differs (torch's against XLA's), so classic CG
agrees to an iteration and to 1e-4 of max|x|. Pipelined CG's restarted
recurrence turns those roundings into iterations (the JAX package alone
takes 185 on 1x1 and 184 on 2x2 at 64^2, 1219 and 1232 at 256^2), so its
twin is held to 10% of the iterations and to the JAX test's 1e-3 of
max|x|, and both packages' true residuals to the JAX test's 10 tol."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import jax_tiles, rand, to_torch
from tpuscratch.halo.driver import _setup as jax_setup
from tpuscratch.runtime.mesh import make_mesh_2d as jax_mesh_2d
from tpuscratch_torch.comm import P, count_wire_bytes, run_spmd
from tpuscratch_torch.halo.driver import _setup
from tpuscratch_torch.runtime.mesh import make_mesh_2d

# the packages export the function cg, which shadows the module's name there
jcg = importlib.import_module("tpuscratch.solvers.cg")
tcg = importlib.import_module("tpuscratch_torch.solvers.cg")

MESHES = [(1, 1), (2, 2)]


def _rel(x, b):
    return np.linalg.norm(tcg.laplacian_apply_np(x.astype(np.float64)) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dims", [(2, 2), (1, 1), (2, 1)])
def test_dirichlet_laplacian_bit_equal(dims):
    core = (8, 12)
    world = (dims[0] * core[0], dims[1] * core[1])
    _, _, _, jspec = jax_setup(world, jax_mesh_2d(dims), (1, 1), periodic=False, neighbors=4)
    _, _, _, spec = _setup(world, make_mesh_2d(dims, device="cpu"), (1, 1), periodic=False,
                           neighbors=4)
    cores = rand(dims + core, 3)
    want = jax_tiles(dims, lambda c: jcg.dirichlet_laplacian(c, jspec), cores)
    got = tcg.dirichlet_laplacian(to_torch(cores), spec).numpy()
    np.testing.assert_array_equal(got, want)
    # and the numpy oracle on the whole grid
    whole = lambda t: t.transpose(0, 2, 1, 3).reshape(world)  # noqa: E731
    np.testing.assert_allclose(whole(got), tcg.laplacian_apply_np(whole(cores).astype(np.float64)),
                               atol=1e-5)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("method", ["cg", "pipelined"])
def test_poisson_solve_twin(dims, method):
    b = rand((64, 64), 11)
    xj, kj, rj = jcg.poisson_solve(b, jax_mesh_2d(dims), tol=1e-5, method=method)
    xt, kt, rt = tcg.poisson_solve(b, make_mesh_2d(dims, device="cpu"), tol=1e-5, method=method)
    assert rt <= 1e-5 and rj <= 1e-5
    scale = np.abs(xj).max()
    if method == "cg":
        assert abs(kt - kj) <= 1, (kt, kj)
        assert np.abs(xt - xj).max() <= 1e-4 * scale
        assert _rel(xt, b) <= 2e-5
    else:
        assert abs(kt - kj) <= 0.1 * kj, (kt, kj)
        assert np.abs(xt - xj).max() <= 1e-3 * scale
        assert _rel(xt, b) <= 10 * 1e-5 and _rel(xj, b) <= 10 * 1e-5


def test_zero_rhs_returns_zero_without_iterating():
    b = np.zeros((8, 8), dtype=np.float32)
    for method in ("cg", "pipelined"):
        x, iters, relres = tcg.poisson_solve(b, make_mesh_2d((2, 2), device="cpu"),
                                             method=method)
        assert iters == 0 and relres == 0.0 and not x.any()


@pytest.mark.parametrize("method,per_iter", [("cg", 2), ("pipelined", 1)])
def test_allreduce_count(method, per_iter):
    """The communication claim, counted: classic CG issues 1 + 2k
    allreduces (the stacked (r.z, r.r) pair once up front, then p.Ap and
    the pair every iteration), pipelined CG 1 + k (its fused triple)."""
    b = rand((32, 32), 12)
    with count_wire_bytes() as wb:
        _, k, _ = tcg.poisson_solve(b, make_mesh_2d((2, 2), device="cpu"), tol=1e-5,
                                    method=method)
    assert k > 10
    assert wb.ops == {"all_reduce": 1 + per_iter * k}
    # the stacked scalars: 2 (cg) or 3 (pipelined) f32 a rank, 2 (n-1)/n each
    payloads = (2 * 4 + k * (4 + 2 * 4)) if method == "cg" else (3 * 4 * (1 + k))
    assert wb.all_reduce == pytest.approx(2 * 3 / 4 * payloads)


def test_cg_with_a_preconditioner_twin():
    """``cg`` called directly with a diagonal preconditioner (exact here:
    it scales by the operator's diagonal 4)."""
    dims, core = (2, 2), (8, 8)
    world = (16, 16)
    _, _, _, jspec = jax_setup(world, jax_mesh_2d(dims), (1, 1), periodic=False, neighbors=4)
    mesh, _, _, spec = _setup(world, make_mesh_2d(dims, device="cpu"), (1, 1), periodic=False,
                              neighbors=4)
    b = rand(world, 13)
    from jax.sharding import PartitionSpec as JP
    from tpuscratch.comm import run_spmd as jax_run_spmd

    def jlocal(bt):
        x, k, rel = jcg.cg(lambda p: jcg.dirichlet_laplacian(p, jspec), bt, ("row", "col"),
                           tol=1e-6, max_iters=200, precond=lambda r: r / 4.0)
        return x, k, rel

    def tlocal(bt):
        x, k, rel = tcg.cg(lambda p: tcg.dirichlet_laplacian(p, spec), bt, ("row", "col"),
                           tol=1e-6, max_iters=200, precond=lambda r: r / 4.0)
        return x, torch.full(mesh.shape, k), rel.reshape(mesh.shape)

    xj, kj, _ = jax_run_spmd(jax_mesh_2d(dims), jlocal, JP("row", "col"),
                             (JP("row", "col"), JP(), JP()))(jnp.asarray(b))
    xt, kt, rt = run_spmd(mesh, tlocal, P("row", "col"), (P("row", "col"), P(), P()))(
        to_torch(b))
    assert abs(int(kt) - int(kj)) <= 1 and float(rt) <= 1e-6
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4 * np.abs(xj).max())


def test_refusals():
    b = rand((16, 16), 14)
    with pytest.raises(ValueError, match="unknown method"):
        tcg.poisson_solve(b, make_mesh_2d((1, 1), device="cpu"), method="bicg")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcg.poisson_solve(b)
    assert tcg.poisson_solve(b, device="cpu")[1] > 0
