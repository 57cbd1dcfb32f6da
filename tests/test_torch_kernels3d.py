"""tpuscratch_torch's one-step 3D 7-point wrappers (``ops.stencil_kernel``)
against tpuscratch's Pallas kernels in interpret mode, on the same seeded
inputs, on the CPU (where a wrapper runs its kernel's plain version), and
the ``compact-*`` impls of ``distributed_stencil3d`` against their twins.

Each plain version sums its kernel's terms in the TPU kernel's order, so
with coefficients whose products are exact (powers of two) the results
are equal bit for bit. With 1/6 or general coefficients the products are
inexact and XLA:CPU may contract the interpreted kernel's multiply-adds
into FMAs: those cases are held to ``FMA_ATOL`` (2e-6: an ulp or two on
unit-normal data)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import FMA_ATOL, rand, to_torch
from tpuscratch.halo import halo3d as jh
from tpuscratch.ops import stencil_kernel as jk
from tpuscratch.runtime.mesh import make_mesh as jax_make_mesh
from tpuscratch_torch.halo import halo3d as th
from tpuscratch_torch.ops import stencil_kernel as tk
from tpuscratch_torch.runtime.mesh import make_mesh

AXES = ("z", "row", "col")
JACOBI7 = (1 / 6,) * 6 + (0.0,)
EXACT = (0.125, 0.25, 0.125, 0.0625, 0.125, 0.25, 0.0625)   # exact products, a centre
EXACT0 = (0.125, 0.25, 0.125, 0.0625, 0.125, 0.25, 0.0)     # exact products, no centre
GENERAL7 = (0.11, 0.13, 0.17, 0.19, 0.07, 0.05, 0.2)
COEFFS = [JACOBI7, EXACT, EXACT0, GENERAL7]
SHAPE = (8, 8, 16)


def _close(got, want, coeffs):
    if coeffs in (EXACT, EXACT0):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FMA_ATOL)


def _arrivals(shape, seed):
    cz, cy, cx = shape
    shapes = dict(core=shape, a_mz=(1, cy, cx), a_pz=(1, cy, cx), a_my=(cz, 1, cx),
                  a_py=(cz, 1, cx), a_mx=(cz, cy, 1), a_px=(cz, cy, 1))
    return {n: rand(s, seed + i) for i, (n, s) in enumerate(shapes.items())}


class TestKernelTwins:
    @pytest.mark.parametrize("coeffs", COEFFS)
    def test_banded(self, coeffs):
        padded = rand(tuple(n + 2 for n in SHAPE), 400)
        want = np.asarray(jk.seven_point_banded_pallas(jnp.asarray(padded), SHAPE, coeffs))
        got = tk.seven_point_banded_pallas(to_torch(padded), SHAPE, coeffs)
        _close(got.numpy(), want, coeffs)

    @pytest.mark.parametrize("coeffs", COEFFS)
    def test_strips(self, coeffs):
        a = _arrivals(SHAPE, 410)
        zpad = np.concatenate([a["a_mz"], a["core"], a["a_pz"]])
        strips = [a[n] for n in ("a_my", "a_py", "a_mx", "a_px")]
        want = np.asarray(jk.seven_point_strips_pallas(
            jnp.asarray(zpad), *map(jnp.asarray, strips), SHAPE, coeffs))
        got = tk.seven_point_strips_pallas(to_torch(zpad), *map(to_torch, strips), SHAPE, coeffs)
        _close(got.numpy(), want, coeffs)

    @pytest.mark.parametrize("coeffs", COEFFS)
    @pytest.mark.parametrize("none_axes", ["", "y", "x", "yx"])
    @pytest.mark.parametrize("budget", [None, "small"])
    def test_assembled(self, coeffs, none_axes, budget):
        # a forced small budget on the JAX side: bands of 2 planes, so its
        # first / middle / last band branches all run
        a = _arrivals(SHAPE, 420)
        for ax in none_axes:
            a[f"a_m{ax}"] = a[f"a_p{ax}"] = None
        names = ("core", "a_mz", "a_pz", "a_my", "a_py", "a_mx", "a_px")
        kw = {}
        if budget:
            plane = SHAPE[1] * SHAPE[2] * 4
            kw = dict(budget_bytes=int((2 * 4 + 2 * 2 + 3.5 * 2) * plane + 6 * plane))
        want = np.asarray(jk.seven_point_assembled_pallas(
            *(None if a[n] is None else jnp.asarray(a[n]) for n in names), SHAPE, coeffs, **kw))
        got = tk.seven_point_assembled_pallas(
            *(None if a[n] is None else to_torch(a[n]) for n in names), SHAPE, coeffs, **kw)
        _close(got.numpy(), want, coeffs)

    def test_three_forms_agree(self):
        # one step from the same ghosts through the three input forms; the
        # term order differs only in where the centre is added
        a = _arrivals(SHAPE, 430)
        t = {n: to_torch(v) for n, v in a.items()}
        padded = torch.zeros(tuple(n + 2 for n in SHAPE))
        padded[1:-1, 1:-1, 1:-1] = t["core"]
        padded[:1, 1:-1, 1:-1], padded[-1:, 1:-1, 1:-1] = t["a_mz"], t["a_pz"]
        padded[1:-1, :1, 1:-1], padded[1:-1, -1:, 1:-1] = t["a_my"], t["a_py"]
        padded[1:-1, 1:-1, :1], padded[1:-1, 1:-1, -1:] = t["a_mx"], t["a_px"]
        zpad = torch.cat([t["a_mz"], t["core"], t["a_pz"]])
        strips = [t[n] for n in ("a_my", "a_py", "a_mx", "a_px")]
        banded = tk.seven_point_banded_pallas(padded, SHAPE, EXACT0)
        assert torch.equal(banded, tk.seven_point_strips_pallas(zpad, *strips, SHAPE, EXACT0))
        assert torch.equal(banded, tk.seven_point_assembled_pallas(
            t["core"], t["a_mz"], t["a_pz"], *strips, SHAPE, EXACT0))

    def test_stacked_batch_matches_per_rank(self):
        lead = (2, 1, 2)
        a = {n: rand(lead + v.shape, 440 + i) for i, (n, v) in enumerate(_arrivals(SHAPE, 0).items())}
        t = {n: to_torch(v) for n, v in a.items()}
        names = ("core", "a_mz", "a_pz", "a_my", "a_py", "a_mx", "a_px")
        f = to_torch(rand(lead + SHAPE, 447))
        got = tk.seven_point_assembled_pallas(*(t[n] for n in names), SHAPE, GENERAL7,
                                              fterm=f, fc=0.3)
        for r in np.ndindex(lead):
            one = tk.seven_point_assembled_pallas(*(t[n][r] for n in names), SHAPE, GENERAL7,
                                                  fterm=f[r], fc=0.3)
            assert torch.equal(got[r], one)

    def test_fterm_twin(self):
        # the pointwise term of the TPU kernel's band update, reached there
        # through _asm3d_compute on a whole-core block
        a = _arrivals(SHAPE, 450)
        f = rand(SHAPE, 457)
        cz, cy, cx = SHAPE

        class Out:
            def __init__(self):
                self.v = np.zeros(SHAPE, np.float32)

            def __setitem__(self, idx, val):
                self.v[idx] = np.asarray(val)

        j = {n: jnp.asarray(v) for n, v in a.items()}
        up = jnp.concatenate([j["a_mz"], j["core"][:-1]])
        dn = jnp.concatenate([j["core"][1:], j["a_pz"]])
        out = Out()
        jk._asm3d_compute(out, up, dn, j["core"], j["a_my"], j["a_py"], j["a_mx"], j["a_px"],
                          cy, cx, EXACT, fterm=jnp.asarray(f), fc=0.5)
        names = ("core", "a_mz", "a_pz", "a_my", "a_py", "a_mx", "a_px")
        got = tk.seven_point_assembled_pallas(*(to_torch(a[n]) for n in names), SHAPE, EXACT,
                                              fterm=to_torch(f), fc=0.5)
        np.testing.assert_array_equal(got.numpy(), out.v)

    def test_drops_the_band_rules(self):
        # a core of 2 planes is "too small" for the TPU's band pipeline and
        # a prime extent leaves it one-plane bands; the port takes any core
        z = jnp.zeros((2, 4, 4))
        with pytest.raises(ValueError, match="too small"):
            jk.seven_point_assembled_pallas(z, z[:1], z[:1], z[:, :1], z[:, :1], z[:, :, :1],
                                            z[:, :, :1], (2, 4, 4), JACOBI7)
        shape = (2, 1, 5)
        a = {n: to_torch(v) for n, v in _arrivals(shape, 460).items()}
        got = tk.seven_point_assembled_pallas(a["core"], a["a_mz"], a["a_pz"], None, None,
                                              None, None, shape, EXACT)
        c = a["core"].double().numpy()
        want = (0.125 * np.concatenate([a["a_mz"].numpy(), c[:-1]])
                + 0.25 * np.concatenate([c[1:], a["a_pz"].numpy()])
                + 0.125 * np.roll(c, 1, 1) + 0.0625 * np.roll(c, -1, 1)
                + 0.125 * np.roll(c, 1, 2) + 0.25 * np.roll(c, -1, 2) + 0.0625 * c)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    @pytest.mark.parametrize("case", ["banded_shape", "strips_shape", "asm_shape", "asm_pair",
                                      "coeffs"])
    def test_kept_refusals_twin(self, case):
        a = _arrivals(SHAPE, 470)
        names = ("core", "a_mz", "a_pz", "a_my", "a_py", "a_mx", "a_px")
        zpad = np.concatenate([a["a_mz"], a["core"], a["a_pz"]])
        strips = [a[n] for n in ("a_my", "a_py", "a_mx", "a_px")]
        conv = {"jax": jnp.asarray, "torch": to_torch}
        for side, mod in (("jax", jk), ("torch", tk)):
            cv = lambda v: None if v is None else conv[side](v)  # noqa: E731
            with pytest.raises((ValueError, TypeError, IndexError)):
                if case == "banded_shape":
                    mod.seven_point_banded_pallas(cv(a["core"]), SHAPE, JACOBI7)
                elif case == "strips_shape":
                    mod.seven_point_strips_pallas(cv(a["core"]), *map(cv, strips), SHAPE, JACOBI7)
                elif case == "asm_shape":
                    mod.seven_point_assembled_pallas(cv(zpad), *(cv(a[n]) for n in names[1:]),
                                                     SHAPE, JACOBI7)
                elif case == "asm_pair":
                    args = [cv(a[n]) for n in names]
                    args[4] = None
                    mod.seven_point_assembled_pallas(*args, SHAPE, JACOBI7)
                else:
                    mod.seven_point_banded_pallas(
                        cv(rand(tuple(n + 2 for n in SHAPE), 471)), SHAPE, JACOBI7[:5])

    def test_port_only_shape_refusals(self):
        a = {n: to_torch(v) for n, v in _arrivals(SHAPE, 480).items()}
        names = ("core", "a_mz", "a_pz", "a_my", "a_py", "a_mx", "a_px")
        args = [a[n] for n in names]
        with pytest.raises(ValueError, match="a_mz"):
            tk.seven_point_assembled_pallas(args[0], args[1][:, :4], *args[2:], SHAPE, JACOBI7)
        with pytest.raises(ValueError, match="a_mx"):
            tk.seven_point_assembled_pallas(*args[:5], args[5][:, :4], args[6], SHAPE, JACOBI7)
        with pytest.raises(ValueError, match="fterm"):
            tk.seven_point_assembled_pallas(*args, SHAPE, JACOBI7, fterm=a["a_mz"], fc=1.0)
        assert "seven_point_assembled_pallas" in tk.launch_counts()


def _run_both(dims, impl, world, steps, periodic, coeffs):
    want = jh.distributed_stencil3d(world, steps, jax_make_mesh(dims, AXES), impl=impl,
                                    periodic=periodic, coeffs=coeffs)
    got = th.distributed_stencil3d(world, steps, make_mesh(dims, AXES, "cpu"), impl=impl,
                                   periodic=periodic, coeffs=coeffs)
    return got, want


class TestDriverTwin:
    @pytest.mark.parametrize("impl", ["compact-pallas", "compact-strips", "compact-asm"])
    @pytest.mark.parametrize("dims", [(1, 1, 1), (2, 2, 2), (1, 2, 2)])
    @pytest.mark.parametrize("periodic", [True, False])
    @pytest.mark.parametrize("coeffs", [JACOBI7, EXACT])
    def test_matches_jax(self, devices, impl, dims, periodic, coeffs):
        # 8 planes a rank at most, 4 at least: compact-asm's two-band minimum
        got, want = _run_both(dims, impl, rand((8, 8, 8), 490), 3, periodic, coeffs)
        _close(got, want, coeffs)

    @pytest.mark.parametrize("impl", ["compact-pallas", "compact-strips", "compact-asm"])
    def test_kernel_impls_equal_compact(self, impl):
        # exact products: the order of the terms cannot show
        world = rand((6, 10, 14), 491)
        mesh = make_mesh((2, 1, 2), AXES, "cpu")
        got = th.distributed_stencil3d(world, 4, mesh, impl=impl, coeffs=EXACT,
                                       periodic=(True, True, False))
        ref = th.distributed_stencil3d(world, 4, mesh, impl="compact", coeffs=EXACT,
                                       periodic=(True, True, False))
        np.testing.assert_allclose(got, ref, rtol=0, atol=FMA_ATOL)
