"""tpuscratch_torch's stacked-tile halo exchange against tpuscratch's
shard_map exchange, tile for tile. The exchange only copies values, so
the results must be equal bit for bit."""

import numpy as np
import pytest
import torch

from _torch_twins import jax_tiles, rand, to_torch
from tpuscratch.halo.exchange import HaloSpec as JHaloSpec
from tpuscratch.halo.exchange import halo_exchange as j_exchange
from tpuscratch.halo.layout import TileLayout as JLayout
from tpuscratch.runtime.topology import CartTopology as JTopo
from tpuscratch_torch.halo.exchange import (
    HaloSpec,
    halo_arrivals,
    halo_exchange,
    halo_scatter,
)
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.runtime.topology import ALL_DIRECTIONS, CartTopology, Direction

PERIODIC = [(True, True), (False, False), (True, False), (False, True)]


def _specs(dims, periodic, lay, neighbors):
    return (
        HaloSpec(TileLayout(*lay), CartTopology(dims, periodic), neighbors=neighbors),
        JHaloSpec(JLayout(*lay), JTopo(dims, periodic), neighbors=neighbors),
    )


class TestExchangeTwin:
    @pytest.mark.parametrize("dims", [(1, 1), (2, 4), (4, 2)])
    @pytest.mark.parametrize("periodic", PERIODIC)
    @pytest.mark.parametrize("neighbors", [4, 8])
    @pytest.mark.parametrize("lay", [(4, 5, 1, 1), (6, 5, 2, 3)])
    def test_matches_jax(self, dims, periodic, neighbors, lay):
        # random ghosts too: open edges must KEEP them, not zero them
        tspec, jspec = _specs(dims, periodic, lay, neighbors)
        tiles = rand(dims + tspec.layout.padded_shape, seed=sum(dims) + neighbors)
        want = jax_tiles(dims, lambda t: j_exchange(t, jspec), tiles)
        got = halo_exchange(to_torch(tiles), tspec).numpy()
        np.testing.assert_array_equal(got, want)

    def test_golden_rank_ids(self):
        # every halo piece holds the periodic neighbor's rank id
        lay = TileLayout(4, 4, 1, 1)
        topo = CartTopology((2, 4), (True, True))
        spec = HaloSpec(lay, topo)
        tiles = torch.full((2, 4) + lay.padded_shape, -1.0)
        for r in range(2):
            for c in range(4):
                tiles[r, c, 1:-1, 1:-1] = r * 4 + c
        out = halo_exchange(tiles, spec)
        for rank in topo.ranks():
            r, c = topo.coords(rank)
            for d in ALL_DIRECTIONS:
                assert bool((lay.halo_region(d).region(out[r, c]) == topo.neighbor(rank, d)).all())

    def test_open_corner_rank_keeps_ghosts(self):
        lay = TileLayout(4, 4, 1, 1)
        spec = HaloSpec(lay, CartTopology((2, 4), (False, False)))
        tiles = torch.full((2, 4) + lay.padded_shape, -1.0)
        tiles[..., 1:-1, 1:-1] = 7.0
        out = halo_exchange(tiles, spec)[0, 0]
        for d in (Direction.TOP, Direction.LEFT, Direction.TOP_LEFT,
                  Direction.TOP_RIGHT, Direction.BOTTOM_LEFT):
            assert bool((lay.halo_region(d).region(out) == -1.0).all()), d
        assert bool((lay.halo_region(Direction.RIGHT).region(out) == 7.0).all())


class TestExchangeContract:
    def _setup(self, periodic=(True, True)):
        lay = TileLayout(5, 6, 2, 2)
        spec = HaloSpec(lay, CartTopology((2, 4), periodic))
        return spec, to_torch(rand((2, 4) + lay.padded_shape, 3))

    @pytest.mark.parametrize("periodic", PERIODIC)
    def test_two_phases_compose(self, periodic):
        spec, tiles = self._setup(periodic)
        split = halo_scatter(tiles, spec, halo_arrivals(tiles, spec))
        assert torch.equal(split, halo_exchange(tiles, spec))

    def test_input_untouched_and_core_unchanged(self):
        spec, tiles = self._setup()
        before = tiles.clone()
        out = halo_exchange(tiles, spec)
        assert torch.equal(tiles, before)
        assert out.data_ptr() != tiles.data_ptr()
        assert torch.equal(spec.layout.core.region(out), spec.layout.core.region(tiles))

    def test_self_wrap_1x1(self):
        lay = TileLayout(4, 4, 1, 1)
        spec = HaloSpec(lay, CartTopology((1, 1), (True, True)))
        core = torch.arange(16.0).reshape(4, 4)
        tiles = torch.zeros((1, 1) + lay.padded_shape)
        tiles[0, 0, 1:-1, 1:-1] = core
        out = halo_exchange(tiles, spec)[0, 0]
        want = torch.nn.functional.pad(core[None, None], (1, 1, 1, 1), mode="circular")[0, 0]
        assert torch.equal(out, want)

    def test_rejects_unstacked_tile(self):
        spec, tiles = self._setup()
        with pytest.raises(ValueError, match="stacked"):
            halo_exchange(tiles[0, 0], spec)
