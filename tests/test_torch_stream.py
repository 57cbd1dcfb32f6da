"""tpuscratch_torch's streamed 2D stencil (``ops.stencil_stream``,
``run_stencil_stream``, the driver's ``stream[:k]``) against tpuscratch's
on the same seeded inputs, on the CPU: the port's plain version against
the Pallas kernel in interpret mode.

Both sides sum the weight grid row by row with zero weights skipped, so
with coefficients whose products are exact (Jacobi, NINE) the results
are equal bit for bit. With C9 the products are inexact and XLA:CPU may
contract the interpreted kernel's multiply-adds into FMAs, so those cases
use the JAX tests' own tolerance, rtol 1e-5 and atol 1e-6; so does every
comparison with the ``xla`` impl, which sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import JACOBI, rand, to_torch
from tpuscratch.halo import driver as jd
from tpuscratch.ops import stencil_stream as js
from tpuscratch.runtime.mesh import make_mesh_2d as jax_mesh_2d
from tpuscratch_torch.halo import driver as td
from tpuscratch_torch.ops import stencil_stream as ts
from tpuscratch_torch.runtime.mesh import make_mesh_2d

NINE = (0.125, 0.125, 0.125, 0.125, 0.0625, 0.0625, 0.0625, 0.0625, 0.0)
C9 = (0.15, 0.15, 0.1, 0.1, 0.05, 0.05, 0.08, 0.07, 0.25)
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, coeffs):
    if coeffs == C9:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(H, W, k, ghost, seed):
    core, top, bot = rand((H, W), seed), rand((k, W), seed + 1), rand((k, W), seed + 2)
    gl = rand((H + 2 * k, k), seed + 3) if ghost else None
    gr = rand((H + 2 * k, k), seed + 4) if ghost else None
    return core, top, bot, gl, gr


def _t(a):
    return None if a is None else to_torch(a)


class TestKernelTwin:
    @pytest.mark.parametrize("ghost", [False, True])
    @pytest.mark.parametrize("coeffs", [JACOBI, NINE, C9])
    @pytest.mark.parametrize("flags", [(0, 0, 0, 0), (1, 0, 1, 1)])
    def test_matches_jax(self, ghost, coeffs, flags):
        H, W, k = 32, 24, 3
        core, top, bot, gl, gr = _inputs(H, W, k, ghost, 80)
        j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        want = np.asarray(js.nine_point_streamed_2d(
            j(core), j(top), j(bot), (H, W), coeffs, k,
            open_flags=jnp.asarray(flags, jnp.int32), gl=j(gl), gr=j(gr)))
        got = ts.nine_point_streamed_2d(
            to_torch(core), to_torch(top), to_torch(bot), (H, W), coeffs, k,
            open_flags=torch.tensor(flags), gl=_t(gl), gr=_t(gr))
        _close(got.numpy(), want, coeffs)

    def test_stacked_batch_matches_per_rank(self):
        # leading dims are a batch of ranks, each with its own flags
        H, W, k = 12, 9, 2
        core, top, bot = rand((2, 3, H, W), 81), rand((2, 3, k, W), 82), rand((2, 3, k, W), 83)
        gl, gr = rand((2, 3, H + 2 * k, k), 84), rand((2, 3, H + 2 * k, k), 85)
        flags = torch.from_numpy(np.random.default_rng(86).integers(0, 2, (2, 3, 4))).int()
        got = ts.nine_point_streamed_2d(*map(to_torch, (core, top, bot)), (H, W), NINE, k,
                                        open_flags=flags, gl=to_torch(gl), gr=to_torch(gr))
        for r in range(2):
            for c in range(3):
                one = ts.nine_point_streamed_2d(
                    *(to_torch(a[r, c]) for a in (core, top, bot)), (H, W), NINE, k,
                    open_flags=flags[r, c], gl=to_torch(gl[r, c]), gr=to_torch(gr[r, c]))
                assert torch.equal(got[r, c], one)

    def test_weight_grid_and_band_twins(self):
        for coeffs in (JACOBI, NINE, C9):
            assert ts.weight_grid(coeffs) == js.weight_grid(coeffs)
            assert [(dy, dx) for dy, dx, _ in ts.stream_taps(coeffs)] == [
                (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                if js.weight_grid(coeffs)[dy + 1][dx + 1] != 0.0]
        for args in ((64, 32, 4, 4, 1 << 20, False), (2048, 2048, 16, 4, 50 << 20, True),
                     (96, 8, 8, 4, 1 << 16, False)):
            assert ts.stream2d_band(*args) == js.stream2d_band(*args)
        for fn in (ts.stream2d_band, js.stream2d_band):
            with pytest.raises(ValueError, match="8-aligned"):
                fn(36, 32, 4, 4, 1 << 20)

    def test_drops_the_tpu_alignment_rules(self):
        # H % 8 and the band rules are the TPU's; the port takes any H
        H, W, k = 37, 53, 3
        core, top, bot, _, _ = _inputs(H, W, k, False, 87)
        with pytest.raises(ValueError, match="multiple of 8"):
            js.nine_point_streamed_2d(jnp.asarray(core), jnp.asarray(top), jnp.asarray(bot),
                                      (H, W), JACOBI, k)
        with pytest.raises(ValueError, match="band"):
            js.nine_point_streamed_2d(*(jnp.asarray(a[:32]) for a in (core,)),
                                      jnp.asarray(top), jnp.asarray(bot), (32, W), JACOBI, k,
                                      band=12)
        got = ts.nine_point_streamed_2d(to_torch(core), to_torch(top), to_torch(bot), (H, W),
                                        JACOBI, k, band=12)
        assert got.shape == (H, W) and bool(torch.isfinite(got).all())

    @pytest.mark.parametrize("case", ["depth", "ghost_depth", "pair", "slab"])
    def test_kept_refusals_twin(self, case):
        H, W, k = 16, 8, 2
        core, top, bot, gl, gr = _inputs(H, W, k, True, 88)
        kw, shape, depth = {}, (H, W), k
        if case == "depth":
            depth, top, bot = 0, top[:0], bot[:0]
        elif case == "ghost_depth":
            W, depth = 2, 3
            core, top, bot = core[:, :2], rand((3, 2), 89), rand((3, 2), 90)
            shape = (H, W)
            kw = dict(gl=rand((H + 6, 3), 91), gr=rand((H + 6, 3), 92))
        elif case == "pair":
            kw = dict(gl=gl)
        else:
            top = top[:1]
        with pytest.raises(ValueError):
            js.nine_point_streamed_2d(jnp.asarray(core), jnp.asarray(top), jnp.asarray(bot),
                                      shape, JACOBI, depth,
                                      **{n: jnp.asarray(v) for n, v in kw.items()})
        with pytest.raises(ValueError):
            ts.nine_point_streamed_2d(to_torch(core), to_torch(top), to_torch(bot), shape,
                                      JACOBI, depth, **{n: to_torch(v) for n, v in kw.items()})


def _run_both(dims, impl, world, steps, periodic=True, coeffs=JACOBI):
    want = jd.distributed_stencil(world, steps, mesh=jax_mesh_2d(dims), impl=impl,
                                  periodic=periodic, coeffs=coeffs)
    got = td.distributed_stencil(world, steps, mesh=make_mesh_2d(dims, device="cpu"),
                                 impl=impl, periodic=periodic, coeffs=coeffs)
    return got, want


class TestDriverTwin:
    @pytest.mark.parametrize("dims", [(1, 1), (2, 1), (1, 2), (2, 2)])
    @pytest.mark.parametrize("periodic", [True, False])
    @pytest.mark.parametrize("impl,steps", [("stream:2", 5), ("stream:4", 9)])
    def test_matches_jax(self, dims, periodic, impl, steps):
        # wrap mode on (1,1)/(2,1) periodic, ghost mode elsewhere; steps
        # leave a remainder pass
        got, want = _run_both(dims, impl, rand((64, 64), 93), steps, periodic)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("dims,coeffs", [((2, 2), NINE), ((1, 1), C9)])
    def test_nine_point(self, dims, coeffs):
        got, want = _run_both(dims, "stream:2", rand((32, 32), 94), 5, coeffs=coeffs)
        _close(got, want, coeffs)

    @pytest.mark.parametrize("periodic", [(True, False), (False, True)])
    def test_mixed_ends_match_xla(self, periodic):
        world = rand((48, 40), 95)
        mesh = make_mesh_2d((2, 2), device="cpu")
        got = td.distributed_stencil(world, 7, mesh=mesh, impl="stream:3", periodic=periodic)
        xla = td.distributed_stencil(world, 7, mesh=mesh, impl="xla", periodic=periodic)
        np.testing.assert_allclose(got, xla, **TOL)

    def test_default_depth_and_ragged_cores(self):
        # `stream` is depth 8; 37 x 53 cores would be refused on the TPU
        world = rand((74, 53), 96)
        mesh = make_mesh_2d((2, 1), device="cpu")
        got = td.distributed_stencil(world, 11, mesh=mesh, impl="stream")
        xla = td.distributed_stencil(world, 11, mesh=mesh, impl="xla")
        np.testing.assert_allclose(got, xla, **TOL)
