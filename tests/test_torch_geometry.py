"""tpuscratch_torch geometry against tpuscratch: topology, subarray specs,
tile layout and the halo plan tables. Pure Python on both sides, so
every comparison is exact."""

import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.dtypes import SubarraySpec as JSpec
from tpuscratch.halo.exchange import HaloSpec as JHaloSpec
from tpuscratch.halo.layout import Region as JRegion
from tpuscratch.halo.layout import TileLayout as JLayout
from tpuscratch.halo.layout import sub_region as j_sub_region
from tpuscratch.runtime import topology as jtopo
from tpuscratch_torch.dtypes import SubarraySpec
from tpuscratch_torch.halo.exchange import HaloSpec
from tpuscratch_torch.halo.layout import Region, TileLayout, sub_region
from tpuscratch_torch.runtime import topology as ttopo

# every mesh shape of tests/test_topology.py and tests/test_halo.py
DIMS = [(3, 4), (2, 3), (3, 3), (2, 4), (4, 2), (1, 1), (1, 4), (2, 1),
        (4, 1), (1, 2), (2, 2), (8,), (4,), (2, 3, 4)]
DIMS2 = [d for d in DIMS if len(d) == 2]


class TestTopology:
    @pytest.mark.parametrize("dims", DIMS)
    @pytest.mark.parametrize("periodic", [True, False])
    def test_tables_match(self, dims, periodic):
        per = (periodic,) * len(dims)
        t, j = ttopo.CartTopology(dims, per), jtopo.CartTopology(dims, per)
        assert (t.dims, t.periodic, t.ndim, t.size) == (j.dims, j.periodic, j.ndim, j.size)
        assert list(t.ranks()) == list(j.ranks())
        for r in t.ranks():
            assert t.coords(r) == j.coords(r)
            for axis in range(t.ndim):
                for disp in (1, -1, 2):
                    assert t.shift(r, axis, disp) == j.shift(r, axis, disp)
        for axis in range(t.ndim):
            assert t.ring_permutation(axis) == j.ring_permutation(axis)
        if t.ndim == 2:
            for d in ttopo.ALL_DIRECTIONS:
                jd = jtopo.Direction(d.value)
                assert t.send_permutation(d) == j.send_permutation(jd)
                assert d.opposite.value == jd.opposite.value
                assert d.is_diagonal == jd.is_diagonal
            for r in t.ranks():
                assert {k.name: v for k, v in t.neighbors8(r).items()} == {
                    k.name: v for k, v in j.neighbors8(r).items()}
            assert t.grid_string() == j.grid_string()

    def test_direction_order_matches(self):
        assert [d.value for d in ttopo.ALL_DIRECTIONS] == [d.value for d in jtopo.ALL_DIRECTIONS]

    @pytest.mark.parametrize("n", range(1, 65))
    def test_factor2d(self, n):
        assert ttopo.factor2d(n) == jtopo.factor2d(n)

    @pytest.mark.parametrize("args", [((),), ((2, 0),), ((2, 2), (True,))])
    def test_validation(self, args):
        with pytest.raises(ValueError):
            jtopo.CartTopology(*args)
        with pytest.raises(ValueError):
            ttopo.CartTopology(*args)

    def test_out_of_range_rank(self):
        with pytest.raises(ValueError):
            ttopo.CartTopology((4,)).coords(4)
        assert ttopo.CartTopology((3, 3)).rank_at((3, 0)) is None
        assert ttopo.CartTopology((3, 3), (True, True)).rank_at((3, -1)) == 2


class TestSubarraySpec:
    def test_region_pack_unpack_match(self):
        x = rand((7, 9), 1)
        t, j = SubarraySpec((2, 3), (3, 4)), JSpec((2, 3), (3, 4))
        assert (t.size, t.offsets, t.shape) == (j.size, j.offsets, j.shape)
        np.testing.assert_array_equal(t.region(to_torch(x)).numpy(), np.asarray(j.region(x)))
        np.testing.assert_array_equal(t.pack(to_torch(x)).numpy(), np.asarray(j.pack(x)))
        flat = rand((12,), 2)
        np.testing.assert_array_equal(
            t.unpack(to_torch(flat), to_torch(x)).numpy(), np.asarray(j.unpack(flat, x)))

    def test_unpack_never_aliases(self):
        x = torch.zeros(4, 4)
        out = SubarraySpec((1, 1), (2, 2)).unpack(torch.ones(4), x)
        assert float(x.sum()) == 0.0 and float(out.sum()) == 4.0

    def test_region_of_stacked_tiles(self):
        x = torch.arange(2 * 3 * 5 * 6.0).reshape(2, 3, 5, 6)
        got = SubarraySpec((1, 2), (2, 3)).region(x)
        assert tuple(got.shape) == (2, 3, 2, 3)
        assert torch.equal(got, x[:, :, 1:3, 2:5])

    @pytest.mark.parametrize("offsets,shape", [((0,), (1, 1)), ((-1, 0), (1, 1)), ((0, 0), (0, 1))])
    def test_validation(self, offsets, shape):
        with pytest.raises(ValueError):
            SubarraySpec(offsets, shape)
        with pytest.raises(ValueError):
            JSpec(offsets, shape)

    def test_bad_payload(self):
        with pytest.raises(ValueError, match="payload"):
            SubarraySpec((0, 0), (2, 2)).unpack(torch.ones(3), torch.zeros(4, 4))


LAYOUTS = [(4, 4, 1, 1), (6, 5, 1, 1), (16, 16, 5, 5), (32, 24, 3, 3), (4, 4, 2, 1),
           (13, 21, 2, 3), (1024, 1024, 16, 16)]


def _rect(spec):
    return spec.offsets, spec.shape


class TestLayout:
    @pytest.mark.parametrize("lay", LAYOUTS)
    def test_regions_match(self, lay):
        t, j = TileLayout(*lay), JLayout(*lay)
        assert t.padded_shape == j.padded_shape
        assert _rect(t.whole) == _rect(j.whole)
        assert _rect(t.core) == _rect(j.core)
        for d in ttopo.ALL_DIRECTIONS:
            jd = jtopo.Direction(d.value)
            assert _rect(t.halo_region(d)) == _rect(j.halo_region(jd))
            assert _rect(t.send_region(d)) == _rect(j.send_region(jd))
        for r in Region:
            assert _rect(sub_region(t.whole, lay[2], lay[3], r)) == _rect(
                j_sub_region(j.whole, lay[2], lay[3], JRegion(r.value)))

    def test_for_stencil(self):
        assert TileLayout.for_stencil(16, 16, 5, 3) == TileLayout(16, 16, 2, 1)

    @pytest.mark.parametrize("lay", [(0, 4, 1, 1), (4, 4, -1, 1), (4, 4, 5, 1)])
    def test_validation(self, lay):
        with pytest.raises(ValueError):
            JLayout(*lay)
        with pytest.raises(ValueError):
            TileLayout(*lay)

    def test_halo_swallows_base(self):
        with pytest.raises(ValueError, match="swallows"):
            sub_region(SubarraySpec((0, 0), (4, 4)), 2, 2, Region.CENTER)


class TestPlan:
    @pytest.mark.parametrize("dims", DIMS2)
    @pytest.mark.parametrize("periodic", [(True, True), (False, False), (True, False), (False, True)])
    @pytest.mark.parametrize("neighbors", [4, 8])
    def test_plan_tables_match(self, dims, periodic, neighbors):
        # the JAX plan comes from its native planner when that library is
        # built, else from the same pure-Python math the port keeps
        lay = (5, 7, 2, 1)
        t = HaloSpec(TileLayout(*lay), ttopo.CartTopology(dims, periodic), neighbors=neighbors)
        j = JHaloSpec(JLayout(*lay), jtopo.CartTopology(dims, periodic), neighbors=neighbors)
        tp, jp = t.plan(), j.plan()
        assert [x.direction.value for x in tp] == [x.direction.value for x in jp]
        assert [d.value for d in t.directions()] == [d.value for d in j.directions()]
        for a, b in zip(tp, jp):
            assert _rect(a.send) == _rect(b.send)
            assert _rect(a.recv) == _rect(b.recv)
            assert a.perm == b.perm
            assert a.has_sender == b.has_sender

    def test_plan_is_cached(self):
        spec = HaloSpec(TileLayout(4, 4, 1, 1), ttopo.CartTopology((2, 4), (True, True)))
        assert spec.plan() is spec.plan()

    @pytest.mark.parametrize("kw", [dict(neighbors=6), dict(topology=ttopo.CartTopology((8,)))])
    def test_validation(self, kw):
        args = dict(layout=TileLayout(4, 4, 1, 1), topology=ttopo.CartTopology((2, 4)))
        args.update(kw)
        with pytest.raises(ValueError):
            HaloSpec(**args)
