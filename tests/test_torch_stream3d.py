"""tpuscratch_torch's streamed 3D stencil (``ops.stencil_stream``'s
``seven_point_streamed_pallas``, ``run_stencil3d_stream``, ``distributed_stencil3d``'s
``stream[:k]``) against tpuscratch's on the same seeded inputs, on the
CPU: the port's plain version against the Pallas kernel run in the
Mosaic interpreter, at the JAX tests' own sizes.

7 points: both sides sum w0..w6 in the same order; XLA:CPU may contract
the interpreted kernel's multiply-adds into FMAs, so the stated tolerance
is ``rtol 1e-5, atol 1e-6``, and coefficients with exact products are
compared bit for bit. 27 points: the TPU kernel sums its border columns
in another order than its interior, the port uses the interior's order
everywhere, so those cases use the JAX test's own ``atol 1e-4``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.halo import halo3d as jh
from tpuscratch.ops import stencil_stream as js
from tpuscratch.runtime.mesh import make_mesh as jax_make_mesh
from tpuscratch_torch.halo import halo3d as th
from tpuscratch_torch.ops import stencil_stream as ts
from tpuscratch_torch.runtime.mesh import make_mesh

AXES = ("z", "row", "col")
JACOBI7 = (1 / 6,) * 6 + (0.0,)
EXACT = (0.125, 0.25, 0.125, 0.0625, 0.125, 0.25, 0.0625)
GENERAL7 = (0.11, 0.13, 0.17, 0.19, 0.07, 0.05, 0.2)
C27 = tuple(np.linspace(0.01, 0.26, 26)) + (0.3,)
TOL = dict(rtol=1e-5, atol=1e-6)
TOL27 = dict(rtol=0, atol=1e-4)


def _close(got, want, coeffs):
    if coeffs == EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **(TOL27 if len(coeffs) == 27 else TOL))


def _inputs(shape, k, ghost_y, ghost_x, seed, rhs=False):
    cz, cy, cx = shape
    a = dict(core=rand(shape, seed), a_mz=rand((k, cy, cx), seed + 1),
             a_pz=rand((k, cy, cx), seed + 2))
    kw = {}
    if ghost_y:
        kw["gy"] = rand((cz + 2 * k, 2 * k, cx), seed + 3)
    if ghost_x:
        kw["gx"] = rand((cz + 2 * k, cy, 2 * k), seed + 4)
    if ghost_y and ghost_x:
        kw["gc"] = rand((cz + 2 * k, 2 * k, 2 * k), seed + 5)
    if rhs:
        kw["rhs"] = rand((cz + 2 * k, cy, cx), seed + 6)
    return a, kw


def _both(a, kw, shape, coeffs, k, flags=None, **extra):
    jflags = None if flags is None else jnp.asarray(flags, jnp.int32)
    want = np.asarray(js.seven_point_streamed_pallas(
        *(jnp.asarray(a[n]) for n in ("core", "a_mz", "a_pz")), shape, coeffs, k,
        open_flags=jflags, **{n: jnp.asarray(v) for n, v in kw.items()}, **extra))
    got = ts.seven_point_streamed_pallas(
        *(to_torch(a[n]) for n in ("core", "a_mz", "a_pz")), shape, coeffs, k,
        open_flags=None if flags is None else torch.tensor(flags),
        **{n: to_torch(v) for n, v in kw.items()}, **extra)
    return got.numpy(), want


class TestKernelTwin:
    @pytest.mark.parametrize("coeffs", [JACOBI7, EXACT, GENERAL7])
    @pytest.mark.parametrize("k", [1, 2, 3])
    @pytest.mark.parametrize("flags", [None, (1, 0), (0, 1, 0, 0, 0, 0)])
    def test_z_slab(self, coeffs, k, flags):
        shape = (16, 8, 8)
        a, kw = _inputs(shape, k, False, False, 500)
        _close(*_both(a, kw, shape, coeffs, k, flags), coeffs)

    @pytest.mark.parametrize("ghost", ["y", "x", "yx"])
    @pytest.mark.parametrize("k", [2, 3])
    @pytest.mark.parametrize("flags", [(0,) * 6, (1, 0, 0, 1, 1, 0), (0, 1, 1, 0, 0, 1)])
    def test_ghost_strips(self, ghost, k, flags):
        shape = (16, 8, 8)
        a, kw = _inputs(shape, k, "y" in ghost, "x" in ghost, 510)
        _close(*_both(a, kw, shape, EXACT, k, flags), EXACT)

    def test_ghost_strips_general_coeffs(self):
        shape = (16, 8, 16)
        a, kw = _inputs(shape, 2, True, True, 515)
        _close(*_both(a, kw, shape, GENERAL7, 2, (1, 1, 1, 0, 0, 1)), GENERAL7)

    @pytest.mark.parametrize("k", [1, 2])
    @pytest.mark.parametrize("flags", [None, (1, 1)])
    def test_27_point(self, k, flags):
        shape = (16, 8, 16)
        a, kw = _inputs(shape, k, False, False, 520)
        _close(*_both(a, kw, shape, C27, k, flags), C27)

    @pytest.mark.parametrize("coeffs", [EXACT, GENERAL7])
    @pytest.mark.parametrize("k", [1, 3])
    def test_rhs(self, coeffs, k):
        shape = (16, 8, 8)
        a, kw = _inputs(shape, k, False, False, 530, rhs=True)
        # 0.5 * rhs is exact, so the EXACT case stays bit for bit
        rc = 0.5 if coeffs == EXACT else 0.375
        _close(*_both(a, kw, shape, coeffs, k, (0, 1), rhs_coeff=rc), coeffs)

    def test_stacked_batch_matches_per_rank(self):
        lead, shape, k = (2, 1, 2), (6, 5, 7), 2
        one, kw1 = _inputs(shape, k, True, True, 0)
        a = {n: to_torch(rand(lead + v.shape, 540 + i)) for i, (n, v) in enumerate(one.items())}
        kw = {n: to_torch(rand(lead + v.shape, 545 + i)) for i, (n, v) in enumerate(kw1.items())}
        flags = torch.from_numpy(np.random.default_rng(549).integers(0, 2, lead + (6,))).int()
        got = ts.seven_point_streamed_pallas(a["core"], a["a_mz"], a["a_pz"], shape, GENERAL7, k,
                                             open_flags=flags, **kw)
        for r in np.ndindex(lead):
            want = ts.seven_point_streamed_pallas(
                a["core"][r], a["a_mz"][r], a["a_pz"][r], shape, GENERAL7, k,
                open_flags=flags[r], **{n: v[r] for n, v in kw.items()})
            assert torch.equal(got[r], want)

    def test_pure_functions_twin(self):
        assert th.OFFSETS26 == jh.OFFSETS26
        assert ts.weight_cube(C27, th.OFFSETS26) == js.weight_cube(C27, jh.OFFSETS26)
        for args, kw in (((256, 512, 512, 4, 4), {}), ((32, 8, 8, 2, 4), dict(has_rhs=True)),
                         ((16, 16, 16, 3, 4), dict(ghost_y=True, ghost_x=True)),
                         ((64, 128, 128, 2, 4), dict(budget_bytes=8 << 20, nbuf=3))):
            assert ts.stream_band(*args, **kw) == js.stream_band(*args, **kw)
        for fn in (ts.stream_band, js.stream_band):
            with pytest.raises(ValueError, match="lower the depth"):
                fn(7, 8, 8, 4, 4)
            with pytest.raises(ValueError, match="no band fits"):
                fn(8, 512, 512, 2, 4, budget_bytes=1 << 20)

    def test_drops_the_band_rules(self):
        # depth > band, a band that does not divide cz and carry_tail
        # without such a band are the TPU pipeline's refusals; a prime
        # depth of planes has no two bands at all
        core = jnp.zeros((8, 8, 8), jnp.float32)
        with pytest.raises(ValueError, match="depth"):
            js.seven_point_streamed_pallas(core, jnp.zeros((6, 8, 8)), jnp.zeros((6, 8, 8)),
                                           (8, 8, 8), JACOBI7, 6, band=4)
        with pytest.raises(ValueError, match="carry_tail"):
            js.seven_point_streamed_pallas(core, jnp.zeros((4, 8, 8)), jnp.zeros((4, 8, 8)),
                                           (8, 8, 8), JACOBI7, 4, band=4, carry_tail=True)
        shape, k = (7, 5, 9), 6
        a, _ = _inputs(shape, k, False, False, 550)
        t = {n: to_torch(v) for n, v in a.items()}
        got = ts.seven_point_streamed_pallas(t["core"], t["a_mz"], t["a_pz"], shape, JACOBI7, k,
                                             band=4, carry_tail=True)
        e = np.concatenate([a["a_mz"], a["core"], a["a_pz"]]).astype(np.float64)
        for _ in range(k):
            e = (e[:-2] + e[2:] + sum(np.roll(e[1:-1], s, ax) for ax in (1, 2) for s in (1, -1))) / 6
        np.testing.assert_allclose(got.numpy(), e, atol=1e-5)

    @pytest.mark.parametrize("case", ["depth", "slab", "core", "gy_shape", "gc_missing",
                                      "gc_alone", "ghost_depth", "27_ghost", "27_rhs",
                                      "rhs_ghost", "rhs_shape", "planes", "coeffs"])
    def test_kept_refusals_twin(self, case):
        shape, k, coeffs = (8, 8, 8), 2, JACOBI7
        a, kw = _inputs(shape, k, True, True, 560)
        if case == "depth":
            k, a["a_mz"], a["a_pz"], kw = 0, a["a_mz"][:0], a["a_pz"][:0], {}
        elif case == "slab":
            a["a_mz"], kw = a["a_mz"][:1], {}
        elif case == "core":
            a["core"], kw = a["core"][:6], {}
        elif case == "gy_shape":
            kw["gy"] = kw["gy"][:, :2]
        elif case == "gc_missing":
            del kw["gc"]
        elif case == "gc_alone":
            kw = dict(gc=kw["gc"], gy=kw["gy"])
        elif case == "ghost_depth":
            shape, k = (8, 8, 3), 4
            a, kw = _inputs(shape, k, False, True, 561)
        elif case == "27_ghost":
            coeffs = C27
        elif case == "27_rhs":
            coeffs, kw = C27, dict(rhs=rand((12, 8, 8), 562))
        elif case == "rhs_ghost":
            kw = dict(gy=kw["gy"], rhs=rand((12, 8, 8), 563))
        elif case == "rhs_shape":
            kw = dict(rhs=rand((8, 8, 8), 564))
        elif case == "planes":
            shape, kw = (8, 8, 2), {}
            a, _ = _inputs(shape, k, False, False, 565)
        elif case == "coeffs":
            coeffs, kw = (0.1,) * 9, {}
        with pytest.raises(ValueError):
            js.seven_point_streamed_pallas(
                *(jnp.asarray(a[n]) for n in ("core", "a_mz", "a_pz")), shape, coeffs, k,
                **{n: jnp.asarray(v) for n, v in kw.items()})
        with pytest.raises(ValueError):
            ts.seven_point_streamed_pallas(
                *(to_torch(a[n]) for n in ("core", "a_mz", "a_pz")), shape, coeffs, k,
                **{n: to_torch(v) for n, v in kw.items()})

    def test_depth_over_core_is_refused(self):
        # the slabs are the neighbours' planes: no pass is deeper than a core
        shape, k = (3, 8, 8), 4
        a, _ = _inputs(shape, k, False, False, 570)
        with pytest.raises(ValueError, match="core depth"):
            ts.seven_point_streamed_pallas(*(to_torch(a[n]) for n in ("core", "a_mz", "a_pz")),
                                           shape, JACOBI7, k)

    def test_tile_rule(self):
        def _tile(plan):
            return plan.ty, plan.tx

        optin = 232448  # what an H100 block may opt in to
        # the tile is the z-march's window less its j-cell apron
        assert _tile(ts.stream3d_plan((256, 512, 512), 1, 4, 7, 132, 2)) == (16, 56)
        assert _tile(ts.stream3d_plan((256, 512, 512), 1, 1, 7, 132, 2)) == (22, 62)
        assert _tile(ts.stream3d_plan((256, 512, 512), 1, 6, 7, 132, 2)) == (12, 20)
        # 10 and 11 substeps run as chains: one launch seats at most 8
        assert ts.stream3d_depth(optin, 7) == ts.stream3d_depth(optin, 27) == 8
        assert ts.stream3d_depth(ts.stream3d_smem(7, 1) - 1, 7) == 0
        for nt in (7, 27):
            for j in range(1, 9):
                assert ts.stream3d_smem(nt, j) <= optin


def _run_both(dims, impl, world, steps, periodic=True, coeffs=JACOBI7):
    want = jh.distributed_stencil3d(world, steps, jax_make_mesh(dims, AXES), impl=impl,
                                    periodic=periodic, coeffs=coeffs)
    got = th.distributed_stencil3d(world, steps, make_mesh(dims, AXES, "cpu"), impl=impl,
                                   periodic=periodic, coeffs=coeffs)
    return got, want


class TestDriverTwin:
    @pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1), (4, 1, 1)])
    @pytest.mark.parametrize("impl,steps", [("stream:2", 4), ("stream:4", 4), ("stream:3", 7)])
    def test_z_slab_periodic(self, devices, dims, impl, steps):
        got, want = _run_both(dims, impl, rand((32, 8, 8), 580), steps)
        _close(got, want, JACOBI7)

    @pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1)])
    def test_open_z(self, devices, dims):
        got, want = _run_both(dims, "stream:2", rand((16, 8, 8), 581), 5,
                              periodic=(False, True, True))
        _close(got, want, JACOBI7)

    @pytest.mark.parametrize("dims", [(1, 2, 1), (1, 1, 2), (1, 2, 2), (2, 2, 1), (2, 1, 2),
                                      (2, 2, 2)])
    def test_ghost_meshes(self, devices, dims):
        got, want = _run_both(dims, "stream:3", rand((16, 16, 16), 582), 5, coeffs=EXACT)
        _close(got, want, EXACT)

    @pytest.mark.parametrize("periodic", [(True, False, True), (True, True, False),
                                          (False, False, False)])
    def test_open_yx(self, devices, periodic):
        got, want = _run_both((2, 2, 2), "stream:2", rand((16, 16, 16), 583), 5,
                              periodic=periodic)
        _close(got, want, JACOBI7)

    @pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1)])
    @pytest.mark.parametrize("periodic", [True, (False, True, True)])
    def test_27_point(self, devices, dims, periodic):
        got, want = _run_both(dims, "stream:2", rand((16, 8, 16), 584), 5, periodic, C27)
        _close(got, want, C27)

    @pytest.mark.parametrize("dims,periodic", [((1, 1, 1), True), ((2, 2, 2), True),
                                               ((1, 2, 2), (False, True, False)),
                                               ((2, 1, 2), False)])
    def test_stream_equals_compact(self, dims, periodic):
        # default depth 4 with a remainder pass; ragged cores no band divides
        world = rand((14, 10, 18), 585)
        mesh = make_mesh(dims, AXES, "cpu")
        got = th.distributed_stencil3d(world, 6, mesh, impl="stream", periodic=periodic)
        ref = th.distributed_stencil3d(world, 6, mesh, impl="compact", periodic=periodic)
        np.testing.assert_allclose(got, ref, **TOL)

    def test_27_point_stream_equals_compact(self):
        world = rand((12, 6, 10), 586)
        mesh = make_mesh((2, 1, 1), AXES, "cpu")
        got = th.distributed_stencil3d(world, 3, mesh, impl="stream:2", coeffs=C27)
        ref = th.distributed_stencil3d(world, 3, mesh, impl="compact", coeffs=C27)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
