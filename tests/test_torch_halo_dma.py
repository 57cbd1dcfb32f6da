"""tpuscratch_torch's DMA-halo stencil (``ops.halo_dma``: ``run_stencil_dma``
at depth 1 and depth k, ``run_stencil_dma_hbm``) against tpuscratch's on
the same seeded inputs, on the CPU: the port's plain versions against the
Pallas kernels in the Mosaic interpreter, at the JAX tests' own sizes.

Term orders match the TPU kernels', so with coefficients whose products
are exact (Jacobi, NINE) the padded tiles are equal bit for bit. With C9
the products are inexact and XLA:CPU may contract the interpreted
kernels' multiply-adds into FMAs: those cases use the JAX tests' own
tolerance, rtol 1e-5 and atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import JACOBI, jax_tiles, rand, to_torch
from tpuscratch.halo.exchange import HaloSpec as JHaloSpec
from tpuscratch.halo.layout import TileLayout as JLayout
from tpuscratch.ops import halo_dma as jh
from tpuscratch.runtime.topology import CartTopology as JTopo
from tpuscratch_torch.halo import driver as td
from tpuscratch_torch.halo.exchange import HaloSpec
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import run_stencil
from tpuscratch_torch.ops import halo_dma as th
from tpuscratch_torch.runtime.mesh import make_mesh_2d
from tpuscratch_torch.runtime.topology import CartTopology

NINE = (0.125, 0.125, 0.125, 0.125, 0.0625, 0.0625, 0.0625, 0.0625, 0.0)
C9 = (0.15, 0.15, 0.1, 0.1, 0.05, 0.05, 0.08, 0.07, 0.25)
TOL = dict(rtol=1e-5, atol=1e-6)


def _specs(dims, lay, periodic=(True, True), neighbors=8):
    return (HaloSpec(TileLayout(*lay), CartTopology(dims, periodic), neighbors=neighbors),
            JHaloSpec(JLayout(*lay), JTopo(dims, periodic), neighbors=neighbors))


def _both(dims, lay, t_fn, j_fn, seed):
    tspec, jspec = _specs(dims, lay)
    tiles = rand(tuple(dims) + tspec.layout.padded_shape, seed)
    want = jax_tiles(dims, lambda t: j_fn(t, jspec), tiles)
    got = t_fn(to_torch(tiles), tspec).numpy()
    return got, want


def _close(got, want, coeffs):
    if coeffs == C9:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


class TestRing:
    @pytest.mark.parametrize("dims", [(2, 4), (1, 4), (2, 1), (1, 1)])
    @pytest.mark.parametrize("steps", [1, 5, 7])
    def test_matches_jax(self, dims, steps):
        got, want = _both(dims, (4, 5, 1, 1),
                          lambda t, s: th.run_stencil_dma(t, s, steps),
                          lambda t, s: jh.run_stencil_dma(t, s, steps), 60)
        np.testing.assert_array_equal(got, want)

    def test_ring_plain_is_the_torus_step(self):
        # all ranks tile one torus: a 2x3 mesh of 5x4 cores == one 10x12 grid
        cores = to_torch(rand((2, 3, 5, 4), 61))
        world = cores.permute(0, 2, 1, 3).reshape(10, 12)
        got = th.dma_ring(cores, 3, (0.3, 0.15, 0.2, 0.25, 0.1))
        one = th.dma_ring(world[None, None], 3, (0.3, 0.15, 0.2, 0.25, 0.1))[0, 0]
        assert torch.equal(got.permute(0, 2, 1, 3).reshape(10, 12), one)


class TestDeep:
    @pytest.mark.parametrize("dims,depth,steps,coeffs", [
        ((2, 2), 2, 5, NINE), ((1, 1), 3, 7, C9), ((2, 1), 2, 4, JACOBI),
    ])
    def test_matches_jax(self, dims, depth, steps, coeffs):
        got, want = _both(dims, (6, 5, 1, 1),
                          lambda t, s: th.run_stencil_dma(t, s, steps, coeffs, depth),
                          lambda t, s: jh.run_stencil_dma(t, s, steps, coeffs, depth), 62)
        _close(got, want, coeffs)

    @pytest.mark.parametrize("depth", [1, 2, 3, 8])
    def test_depth_leaves_values_alone(self, depth):
        # on a torus every round's trapezoid reproduces the per-step values
        world = rand((24, 30), 63)
        mesh = make_mesh_2d((2, 3), device="cpu")
        impl = "dma-deep:%d" % depth
        nine = td.distributed_stencil(world, 11, mesh=mesh, impl=impl, coeffs=NINE)
        xla = td.distributed_stencil(world, 11, mesh=mesh, impl="xla", coeffs=NINE)
        np.testing.assert_array_equal(nine, xla)
        five = td.distributed_stencil(world, 11, mesh=mesh, impl=impl)
        np.testing.assert_array_equal(five, td.distributed_stencil(world, 11, mesh=mesh))


class TestHbm:
    @pytest.mark.parametrize("dims,steps,coeffs", [
        ((2, 2), 3, JACOBI), ((1, 1), 2, NINE), ((2, 1), 2, C9),
    ])
    def test_matches_jax(self, dims, steps, coeffs):
        got, want = _both(dims, (32, 8, 1, 1),
                          lambda t, s: th.run_stencil_dma_hbm(t, s, steps, coeffs, band=8),
                          lambda t, s: jh.run_stencil_dma_hbm(t, s, steps, coeffs, band=8), 64)
        _close(got, want, coeffs)

    def test_nine_point_matches_xla(self):
        # the centre term is not last here, unlike nine_point's order
        world = rand((40, 36), 65)
        mesh = make_mesh_2d((2, 2), device="cpu")
        got = td.distributed_stencil(world, 6, mesh=mesh, impl="dma-hbm", coeffs=C9)
        xla = td.distributed_stencil(world, 6, mesh=mesh, impl="xla", coeffs=C9)
        np.testing.assert_allclose(got, xla, **TOL)

    def test_band_rules_twin(self):
        for args in ((32, 8, 4, 1 << 20), (2048, 2048, 4, 100 << 20), (512, 512, 4, 8 << 20, True)):
            assert th.hbm_band(*args) == jh.hbm_band(*args)
        for fn in (th.hbm_band, jh.hbm_band):
            with pytest.raises(ValueError, match="8-aligned"):
                fn(36, 8, 4, 1 << 20)


class TestRefusals:
    def test_as_nine_twin(self):
        for coeffs in (JACOBI, NINE, C9):
            assert th.as_nine(coeffs) == jh.as_nine(coeffs)
        for fn in (th.as_nine, jh.as_nine):
            with pytest.raises(ValueError, match="5 or 9"):
                fn((1.0, 2.0))

    @pytest.mark.parametrize("case", ["open", "neighbors", "depth", "small", "steps"])
    def test_kept_refusals_twin(self, case):
        dims, lay, kw, coeffs, steps = (2, 2), (8, 8, 1, 1), {}, JACOBI, 3
        periodic, neighbors = (True, True), 8
        if case == "open":
            periodic = (True, False)
        elif case == "neighbors":
            coeffs, neighbors = NINE, 4
        elif case == "depth":
            kw = dict(depth=0)
        elif case == "small":
            lay, kw = (8, 2, 1, 1), dict(depth=1)
        else:
            steps = 0
        tspec, jspec = _specs(dims, lay, periodic, neighbors)
        pad = tspec.layout.padded_shape
        with pytest.raises(ValueError):
            jh.run_stencil_dma(jnp.zeros(pad), jspec, steps, coeffs, **kw)
        with pytest.raises(ValueError):
            th.run_stencil_dma(torch.zeros(dims + pad), tspec, steps, coeffs, **kw)
        if case in ("open", "neighbors", "steps"):
            with pytest.raises(ValueError):
                jh.run_stencil_dma_hbm(jnp.zeros(pad), jspec, steps, coeffs)
            with pytest.raises(ValueError):
                th.run_stencil_dma_hbm(torch.zeros(dims + pad), tspec, steps, coeffs)

    def test_drops_the_tpu_refusals(self):
        # H % 8, the band rules and every VMEM budget are the TPU's
        tspec, jspec = _specs((1, 1), (37, 53, 1, 1))
        pad = tspec.layout.padded_shape
        with pytest.raises(ValueError, match="multiple of 8"):
            jh.run_stencil_dma_hbm(jnp.zeros(pad), jspec, 1)
        with pytest.raises(ValueError, match="VMEM"):
            jh.run_stencil_dma(jnp.zeros(pad), jspec, 1, vmem_limit_bytes=1 << 10)
        tiles = to_torch(rand((1, 1) + pad, 66))
        core = (..., slice(1, -1), slice(1, -1))  # run_stencil's halo is a step stale
        want = run_stencil(tiles, tspec, 3)[core]
        assert torch.equal(th.run_stencil_dma_hbm(tiles, tspec, 3, band=5)[core], want)
        assert torch.equal(th.run_stencil_dma(tiles, tspec, 3, vmem_limit_bytes=1 << 10)[core],
                           want)
