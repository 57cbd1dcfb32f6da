"""tpuscratch_torch's stencil loop against tpuscratch's, tile for tile,
on the CPU (the kernel impls run their plain versions; the JAX ones run
their Pallas kernels in interpret mode). Jacobi coefficients keep every
rounding the same on both sides, so results are equal bit for bit except
where stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import JACOBI, jax_tiles, rand, to_torch
from tpuscratch.halo import stencil as js
from tpuscratch.halo.exchange import HaloSpec as JHaloSpec
from tpuscratch.halo.layout import TileLayout as JLayout
from tpuscratch.runtime.topology import CartTopology as JTopo
from tpuscratch_torch.halo import stencil as ts
from tpuscratch_torch.halo.exchange import HaloSpec
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.runtime.topology import CartTopology

NINE = (0.125, 0.125, 0.125, 0.125, 0.0625, 0.0625, 0.0625, 0.0625, 0.0)


def _specs(dims, periodic, lay, neighbors=8):
    return (
        HaloSpec(TileLayout(*lay), CartTopology(dims, periodic), neighbors=neighbors),
        JHaloSpec(JLayout(*lay), JTopo(dims, periodic), neighbors=neighbors),
    )


def _both(dims, periodic, lay, t_fn, j_fn, seed):
    tspec, jspec = _specs(dims, periodic, lay)
    tiles = rand(dims + tspec.layout.padded_shape, seed)
    want = jax_tiles(dims, lambda t: j_fn(t, jspec), tiles)
    got = t_fn(to_torch(tiles), tspec).numpy()
    return got, want


class TestComputeTwins:
    @pytest.mark.parametrize("lay", [(4, 4, 1, 1), (6, 5, 2, 3)])
    def test_five_and_nine_point(self, lay):
        tile = rand(TileLayout(*lay).padded_shape, 20)
        np.testing.assert_array_equal(
            ts.five_point(to_torch(tile), TileLayout(*lay)).numpy(),
            np.asarray(js.five_point(jnp.asarray(tile), JLayout(*lay))))
        np.testing.assert_array_equal(
            ts.nine_point(to_torch(tile), TileLayout(*lay), NINE).numpy(),
            np.asarray(js.nine_point(jnp.asarray(tile), JLayout(*lay), NINE)))

    def test_shrink_step_and_rebuild(self):
        a = rand((9, 11), 21)
        np.testing.assert_array_equal(ts.shrink_step(to_torch(a), JACOBI).numpy(),
                                      np.asarray(js.shrink_step(jnp.asarray(a), JACOBI)))
        lay = (5, 7, 2, 2)
        core = rand((5, 7), 22)
        np.testing.assert_array_equal(
            ts.rebuild(to_torch(a), to_torch(core), TileLayout(*lay)).numpy(),
            np.asarray(js.rebuild(jnp.asarray(a), jnp.asarray(core), JLayout(*lay))))

    def test_rebuild_writes_a_fresh_buffer(self):
        lay = TileLayout(4, 4, 1, 1)
        tile = torch.zeros(lay.padded_shape)
        out = ts.rebuild(tile, torch.ones(4, 4), lay)
        assert float(tile.sum()) == 0.0 and float(out.sum()) == 16.0


class TestRunStencil:
    @pytest.mark.parametrize("dims", [(1, 1), (2, 4), (4, 2)])
    @pytest.mark.parametrize("impl", ["xla", "pallas", "blocked", "overlap"])
    def test_per_step_impls(self, dims, impl):
        got, want = _both(dims, (True, True), (6, 5, 1, 1),
                          lambda t, s: ts.run_stencil(t, s, 3, impl=impl),
                          lambda t, s: js.run_stencil(t, s, 3, impl=impl), 23)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("periodic", [(False, False), (True, False)])
    def test_open_boundaries(self, periodic):
        got, want = _both((2, 4), periodic, (6, 5, 1, 1),
                          lambda t, s: ts.run_stencil(t, s, 3),
                          lambda t, s: js.run_stencil(t, s, 3), 24)
        np.testing.assert_array_equal(got, want)

    def test_nine_point(self):
        got, want = _both((2, 4), (True, True), (6, 5, 1, 1),
                          lambda t, s: ts.run_stencil(t, s, 2, NINE),
                          lambda t, s: js.run_stencil(t, s, 2, NINE), 25)
        np.testing.assert_array_equal(got, want)

    def test_overlap_tiny_core_falls_back(self):
        got, want = _both((2, 4), (True, True), (2, 2, 1, 1),
                          lambda t, s: ts.run_stencil(t, s, 1, impl="overlap"),
                          lambda t, s: js.run_stencil(t, s, 1, impl="overlap"), 26)
        np.testing.assert_array_equal(got, want)

    def test_refusals(self):
        tspec, _ = _specs((2, 4), (True, True), (4, 4, 1, 1))
        tiles = torch.zeros((2, 4) + tspec.layout.padded_shape)
        with pytest.raises(ValueError, match="unknown"):
            ts.stencil_step(tiles, tspec, impl="cuda")
        with pytest.raises(ValueError, match="only supported"):
            ts.stencil_step(tiles, tspec, NINE, impl="pallas")
        four, _ = _specs((2, 4), (True, True), (4, 4, 1, 1), neighbors=4)
        with pytest.raises(ValueError, match="neighbors=8"):
            ts.stencil_step(tiles, four, NINE)


class TestDeep:
    @pytest.mark.parametrize("dims", [(1, 1), (2, 4)])
    @pytest.mark.parametrize("depth,steps", [(2, 4), (2, 5), (3, 7)])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_matches_jax(self, dims, depth, steps, impl):
        got, want = _both(dims, (True, True), (6, 5, depth, depth),
                          lambda t, s: ts.run_stencil_deep(t, s, steps, impl=impl),
                          lambda t, s: js.run_stencil_deep(t, s, steps, impl=impl), 27)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("dims,periodic", [((2, 4), (False, False)), ((2, 4), (True, False)),
                                               ((2, 4), (False, True)), ((1, 1), (False, False))])
    @pytest.mark.parametrize("depth,steps", [(2, 5), (3, 7)])
    def test_open_boundary_rezeroing(self, dims, periodic, depth, steps):
        got, want = _both(dims, periodic, (6, 5, depth, depth),
                          lambda t, s: ts.run_stencil_deep(t, s, steps),
                          lambda t, s: js.run_stencil_deep(t, s, steps), 28)
        np.testing.assert_array_equal(got, want)

    def test_depth_below_halo(self):
        got, want = _both((1, 1), (True, True), (16, 16, 4, 4),
                          lambda t, s: ts.run_stencil_deep(t, s, 6, depth=2, impl="pallas"),
                          lambda t, s: js.run_stencil_deep(t, s, 6, depth=2, impl="pallas"), 29)
        np.testing.assert_array_equal(got, want)

    def test_refusals(self):
        open_spec, _ = _specs((2, 4), (True, False), (4, 4, 2, 2))
        tiles = torch.zeros((2, 4) + open_spec.layout.padded_shape)
        with pytest.raises(ValueError, match="periodic-only"):
            ts.run_stencil_deep(tiles, open_spec, 4, impl="pallas")
        asym, _ = _specs((2, 4), (True, True), (4, 4, 2, 1))
        with pytest.raises(ValueError, match="square"):
            ts.run_stencil_deep(torch.zeros((2, 4) + asym.layout.padded_shape), asym, 4)
        spec, _ = _specs((2, 4), (True, True), (4, 4, 2, 2))
        with pytest.raises(ValueError, match="depth"):
            ts.run_stencil_deep(tiles, spec, 4, depth=3)
        with pytest.raises(ValueError, match="unknown"):
            ts.run_stencil_deep(tiles, spec, 4, impl="cuda")


class TestResident:
    @pytest.mark.parametrize("steps", [1, 5, 16])
    def test_matches_jax(self, steps):
        # the symmetric Jacobi form cn*((N+S)+(W+E)) is the same on both sides
        got, want = _both((1, 1), (True, True), (32, 128, 1, 1),
                          lambda t, s: ts.run_stencil_resident(t, s, steps),
                          lambda t, s: js.run_stencil_resident(t, s, steps), 30)
        np.testing.assert_array_equal(got, want)

    def test_refusals(self):
        multi, _ = _specs((2, 4), (True, True), (8, 8, 1, 1))
        with pytest.raises(ValueError, match="single-device"):
            ts.run_stencil_resident(torch.zeros((2, 4) + multi.layout.padded_shape), multi, 2)
        open1, _ = _specs((1, 1), (False, False), (8, 8, 1, 1))
        with pytest.raises(ValueError, match="periodic"):
            ts.run_stencil_resident(torch.zeros((1, 1) + open1.layout.padded_shape), open1, 2)
