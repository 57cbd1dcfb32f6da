"""tpuscratch_torch's 3D halo module (``halo.halo3d``) against tpuscratch's
on the same seeded inputs, on the CPU.

The geometry, the plan and the exchanges move values and are compared bit
for bit. ``padded`` and ``compact`` sum the centre term and then the
neighbours in FACES / OFFSETS26 order on both sides, with one rounding a
product and a sum in torch; XLA:CPU may contract its multiply-adds into
FMAs, so stencil results are held to ``atol 1e-6`` (1/6 is inexact in
binary, so there is no bit-equal case against XLA). The 27-point
coefficients sum to 3.8, so three steps grow unit-normal data past 4,
where one float32 ulp is 4.8e-7: those cases add ``rtol 1e-6``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_twins import rand, to_torch
from tpuscratch.comm import run_spmd
from tpuscratch.halo import halo3d as jh
from tpuscratch.runtime.mesh import make_mesh as jax_make_mesh
from tpuscratch.runtime.topology import CartTopology as JaxTopology
from tpuscratch.runtime import topology as jtopo
from tpuscratch_torch.halo import halo3d as th
from tpuscratch_torch.halo.driver import cores3d_from_numpy, tiles3d_from_numpy
from tpuscratch_torch.runtime import topology as ttopo
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.runtime.topology import CartTopology

AXES = ("z", "row", "col")
SPEC6 = P("z", "row", "col", None, None, None)
ATOL = 1e-6
C27 = tuple(np.linspace(0.01, 0.26, 26)) + (0.3,)
C7 = (0.11, 0.13, 0.17, 0.19, 0.07, 0.05, 0.2)


def _jax_tiles(dims, tile_fn, tiles):
    f = run_spmd(jax_make_mesh(dims, AXES), lambda t: tile_fn(t[0, 0, 0])[None, None, None],
                 SPEC6, SPEC6)
    return np.asarray(f(jnp.asarray(tiles)))


def _specs(dims, core, halo, periodic, neighbors):
    per = (periodic,) * 3 if isinstance(periodic, bool) else tuple(periodic)
    js = jh.HaloSpec3D(layout=jh.TileLayout3D(core, halo), topology=JaxTopology(dims, per),
                       neighbors=neighbors)
    ts = th.HaloSpec3D(layout=th.TileLayout3D(core, halo), topology=CartTopology(dims, per),
                       neighbors=neighbors)
    return js, ts


class TestGeometry:
    def test_constants(self):
        assert th.FACES == jh.FACES and th.OFFSETS26 == jh.OFFSETS26
        assert th.JACOBI7 == jh.JACOBI7 and th.IMPLS3D == jh.IMPLS3D
        assert th._COMPACT_COMPUTE == jh._COMPACT_COMPUTE

    @pytest.mark.parametrize("core,halo", [((4, 6, 8), (1, 1, 1)), ((5, 4, 7), (3, 2, 1)),
                                           ((3, 3, 3), (1, 1, 2))])
    def test_layout_regions(self, core, halo):
        jl, tl = jh.TileLayout3D(core, halo), th.TileLayout3D(core, halo)
        assert tl.padded_shape == jl.padded_shape
        for d in th.OFFSETS26:
            for name in ("send_region", "halo_region"):
                a, b = getattr(jl, name)(d), getattr(tl, name)(d)
                assert (a.offsets, a.shape) == (b.offsets, b.shape)

    @pytest.mark.parametrize("args", [((4, 4), (1, 1, 1)), ((2, 2, 2), (3, 1, 1)),
                                      ((0, 2, 2), (1, 1, 1))])
    def test_layout_refusals(self, args):
        for cls in (jh.TileLayout3D, th.TileLayout3D):
            with pytest.raises(ValueError):
                cls(*args)

    @pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16, 27, 30, 64])
    def test_factor3d_and_square_grid(self, n):
        assert ttopo.factor3d(n) == jtopo.factor3d(n)
        side = int(round(n ** 0.5))
        if side * side == n:
            a, b = ttopo.square_grid(n, False), jtopo.square_grid(n, False)
            assert (a.dims, a.periodic) == (b.dims, b.periodic)
        else:
            for fn in (ttopo.square_grid, jtopo.square_grid):
                with pytest.raises(ValueError, match="square grid"):
                    fn(n)

    @pytest.mark.parametrize("neighbors", [6, 26])
    @pytest.mark.parametrize("dims,periodic", [((2, 2, 2), True), ((2, 2, 2), False),
                                               ((1, 2, 4), (True, False, True)),
                                               ((1, 1, 1), True)])
    def test_plan_field_for_field(self, dims, periodic, neighbors):
        js, ts = _specs(dims, (4, 3, 5), (2, 1, 1), periodic, neighbors)
        jp, tp = js.plan(), ts.plan()
        assert len(jp) == len(tp) == neighbors
        assert ts.directions() == js.directions()
        for a, b in zip(jp, tp):
            assert tuple(a.offset) == b.offset
            assert (a.send.offsets, a.send.shape) == (b.send.offsets, b.send.shape)
            assert (a.recv.offsets, a.recv.shape) == (b.recv.offsets, b.recv.shape)
            assert tuple(a.perm) == b.perm and tuple(a.has_sender) == b.has_sender

    def test_spec_refusals(self):
        lay = th.TileLayout3D((2, 2, 2))
        with pytest.raises(ValueError, match="3D topology"):
            th.HaloSpec3D(layout=lay, topology=CartTopology((2, 2), (True, True)))
        with pytest.raises(ValueError, match="6 or 26"):
            th.HaloSpec3D(layout=lay, topology=CartTopology((1, 1, 1), (True,) * 3), neighbors=8)

    def test_decompose_assemble_twins(self):
        world = rand((4, 6, 8), 300)
        topo, lay = CartTopology((2, 3, 2), (True,) * 3), th.TileLayout3D((2, 2, 4), (1, 2, 1))
        jt = jh.decompose3d(world, JaxTopology((2, 3, 2), (True,) * 3), jh.TileLayout3D((2, 2, 4), (1, 2, 1)))
        tt = th.decompose3d(world, topo, lay)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(th.assemble3d(tt, topo, lay), world)
        np.testing.assert_array_equal(th.decompose3d_cores(world, (2, 3, 2)),
                                      jh.decompose3d_cores(world, (2, 3, 2)))
        np.testing.assert_array_equal(
            th.assemble3d_cores(th.decompose3d_cores(world, (2, 3, 2))), world)
        with pytest.raises(ValueError, match="world"):
            th.decompose3d(world[:3], topo, lay)

    def test_state_from_numpy(self):
        tiles = rand((1, 2, 1, 3, 4, 5), 301)
        assert torch.equal(tiles3d_from_numpy(tiles, "cpu"), to_torch(tiles))
        assert torch.equal(cores3d_from_numpy(tiles, "cpu"), to_torch(tiles))
        with pytest.raises(ValueError, match="tiles"):
            tiles3d_from_numpy(tiles[0], "cpu")


class TestExchangeTwin:
    @pytest.mark.parametrize("neighbors", [6, 26])
    @pytest.mark.parametrize("periodic", [True, False, (True, False, True)])
    @pytest.mark.parametrize("halo", [(1, 1, 1), (2, 2, 2), (3, 2, 1)])
    def test_halo_exchange3d(self, devices, halo, periodic, neighbors):
        js, ts = _specs((2, 2, 2), (4, 4, 4), halo, periodic, neighbors)
        tiles = rand((2, 2, 2) + ts.layout.padded_shape, 310)  # ghosts poisoned
        want = _jax_tiles((2, 2, 2), lambda t: jh.halo_exchange3d(t, js), tiles)
        got = th.halo_exchange3d(to_torch(tiles), ts)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("dims,periodic", [
        ((2, 2, 2), True), ((2, 2, 2), False), ((1, 2, 2), (False, True, True)),
        ((1, 2, 4), (True, False, True))])
    @pytest.mark.parametrize("halo", [(1, 1, 1), (2, 2, 2), (3, 2, 1)])
    def test_halo_exchange3d_seq(self, devices, halo, dims, periodic):
        js, ts = _specs(dims, (4, 4, 4), halo, periodic, 6)
        tiles = rand(dims + ts.layout.padded_shape, 311)
        want = _jax_tiles(dims, lambda t: jh.halo_exchange3d_seq(t, js), tiles)
        got = th.halo_exchange3d_seq(to_torch(tiles), ts)
        np.testing.assert_array_equal(got.numpy(), want)
        assert th.seq_exchange_wire_bytes(ts) == jh.seq_exchange_wire_bytes(js)

    def test_seq_fills_what_26_transfers_fill(self):
        _, t26 = _specs((2, 2, 2), (4, 4, 4), (2, 2, 2), True, 26)
        _, t6 = _specs((2, 2, 2), (4, 4, 4), (2, 2, 2), True, 6)
        tiles = to_torch(th.decompose3d(rand((8, 8, 8), 312), t6.topology, t6.layout))
        assert torch.equal(th.halo_exchange3d_seq(tiles, t6), th.halo_exchange3d(tiles, t26))

    def test_shape_refusals(self):
        _, ts = _specs((2, 2, 2), (4, 4, 4), (1, 1, 1), True, 6)
        bad = torch.zeros((2, 2, 2, 6, 6, 5))
        for fn in (th.halo_exchange3d, th.halo_exchange3d_seq):
            with pytest.raises(ValueError, match="stacked padded"):
                fn(bad, ts)


def _run_both(dims, world, steps, **kw):
    want = jh.distributed_stencil3d(world, steps, jax_make_mesh(dims, AXES), **kw)
    got = th.distributed_stencil3d(world, steps, make_mesh(dims, AXES, "cpu"), **kw)
    return got, want


class TestDriverTwin:
    @pytest.mark.parametrize("dims", [(1, 1, 1), (2, 2, 2), (1, 2, 4)])
    @pytest.mark.parametrize("periodic", [True, False])
    @pytest.mark.parametrize("impl,coeffs", [("padded", th.JACOBI7), ("compact", th.JACOBI7),
                                             ("compact", C7), ("compact", C27),
                                             ("padded", C27)])
    def test_matches_jax(self, devices, dims, periodic, impl, coeffs):
        got, want = _run_both(dims, rand((4, 8, 8), 320), 3, impl=impl, coeffs=coeffs,
                              periodic=periodic)
        np.testing.assert_allclose(got, want, rtol=1e-6 if coeffs == C27 else 0, atol=ATOL)

    @pytest.mark.parametrize("halo", [(2, 2, 2), (2, 1, 3)])
    def test_deep_halo_defaults_to_padded(self, devices, halo):
        got, want = _run_both((2, 2, 1), rand((8, 8, 8), 321), 2, halo=halo,
                              periodic=(True, False, True))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    def test_compact_equals_padded_and_oracle(self):
        world = rand((8, 8, 8), 322)
        mesh = make_mesh((2, 2, 2), AXES, "cpu")
        a = th.distributed_stencil3d(world, 3, mesh, impl="compact")
        b = th.distributed_stencil3d(world, 3, mesh, impl="padded")
        np.testing.assert_array_equal(a, b)  # same terms in the same order
        e = world.astype(np.float64)
        for _ in range(3):
            e = sum(np.roll(e, s, ax) for ax in range(3) for s in (1, -1)) / 6.0
        np.testing.assert_allclose(a, e, atol=1e-5)

    def test_default_mesh_needs_a_card_or_the_cpu(self):
        world = rand((4, 4, 4), 323)
        out = th.distributed_stencil3d(world, 1, device="cpu")
        assert out.shape == world.shape
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                th.distributed_stencil3d(world, 1)

    @pytest.mark.parametrize("case", ["compact_deep_halo", "stream_deep_halo", "coeff_count",
                                      "27_on_kernel_impl", "unknown_impl", "indivisible",
                                      "stream_depth", "27_face_only", "stream_27_yx",
                                      "stream_coeffs"])
    def test_refusals_twin(self, devices, case):
        world = np.zeros((8, 8, 8), np.float32)
        dims, kw, match = (1, 1, 1), {}, None
        if case == "compact_deep_halo":
            kw, match = dict(halo=(2, 2, 2), impl="compact"), r"halo \(1,1,1\) only"
        elif case == "stream_deep_halo":
            kw, match = dict(halo=(2, 2, 2), impl="stream:2"), r"halo \(1,1,1\) only"
        elif case == "coeff_count":
            kw, match = dict(coeffs=(0.1,) * 9, impl="padded"), "6\\+1 or 26\\+1"
        elif case == "27_on_kernel_impl":
            kw, match = dict(coeffs=C27, impl="compact-strips"), "compute='xla' only"
        elif case == "unknown_impl":
            kw, match = dict(impl="resident"), "unknown 3D stencil impl"
        elif case == "indivisible":
            dims, world, match = (2, 1, 1), np.zeros((7, 8, 8), np.float32), "not divisible"
        elif case == "stream_depth":
            kw, match = dict(impl="stream:0"), "depth must be >= 1"
        elif case == "stream_27_yx":
            dims, kw, match = (1, 2, 1), dict(coeffs=C27, impl="stream:2"), "z-slab"
        elif case == "stream_coeffs":
            kw, match = dict(coeffs=(0.1,) * 9, impl="stream:2"), "7 or 27"
        if case == "27_face_only":
            topo = (1, 1, 1), (True,) * 3
            with pytest.raises(ValueError, match="neighbors=26"):
                jh.stencil_step3d(jnp.zeros((4, 4, 4)), jh.HaloSpec3D(
                    layout=jh.TileLayout3D((2, 2, 2)), topology=JaxTopology(*topo)), coeffs=C27)
            with pytest.raises(ValueError, match="neighbors=26"):
                th.stencil_step3d(torch.zeros((1, 1, 1, 4, 4, 4)), th.HaloSpec3D(
                    layout=th.TileLayout3D((2, 2, 2)), topology=CartTopology(*topo)), coeffs=C27)
            return
        with pytest.raises(ValueError, match=match):
            jh.distributed_stencil3d(world, 2, jax_make_mesh(dims, AXES), **kw)
        with pytest.raises(ValueError, match=match):
            th.distributed_stencil3d(world, 2, make_mesh(dims, AXES, "cpu"), **kw)

    def test_port_only_refusals(self):
        world = np.zeros((4, 4, 4), np.float32)
        with pytest.raises(ValueError, match="unknown 3D stencil impl"):
            th.distributed_stencil3d(world, 1, device="cpu", impl="compact:2")
        with pytest.raises(ValueError, match="3-axis mesh"):
            th.distributed_stencil3d(world, 1, make_mesh((1, 1), ("row", "col"), "cpu"))
        spec = th.HaloSpec3D(layout=th.TileLayout3D((4, 4, 4)),
                             topology=CartTopology((1, 1, 1), (True,) * 3))
        with pytest.raises(ValueError, match="spec topology"):
            th.make_stencil3d_program(make_mesh((2, 1, 1), AXES, "cpu"), spec, 1)
        with pytest.raises(ValueError, match="stacked cores"):
            th.run_stencil3d_compact(torch.zeros((1, 1, 1, 4, 4, 5)), spec, 1)
        with pytest.raises(ValueError, match="unknown compact compute"):
            th.stencil_step3d_compact(torch.zeros((1, 1, 1, 4, 4, 4)), spec, compute="mosaic")


class TestBenchTwin:
    def test_bench_stencil3d_and_config9_on_the_cpu(self):
        from tpuscratch_torch.bench.record import CONFIGS, config9_stencil3d
        from tpuscratch_torch.bench.stencil_bench import bench_stencil3d

        r = bench_stencil3d((8, 8, 8), 2, mesh=make_mesh((2, 1, 1), AXES, "cpu"),
                            impl="stream:2", iters=1)
        assert r.items == 8 * 8 * 8 * 2 and "2x1x1" in r.name
        r27 = bench_stencil3d((8, 8, 8), 1, impl="padded", iters=1, coeffs=C27, device="cpu")
        assert "27pt" in r27.name
        out: list = []
        res = config9_stencil3d(out, iters=1, tile=(8, 8, 8), screen_s=1e-4, final_s=2e-4,
                                device="cpu")
        assert CONFIGS[9] is config9_stencil3d
        assert set(res["screen"]) == {"compact", "compact-pallas", "compact-strips",
                                      "compact-asm", "stream:2", "stream:4"}
        line = out[-1]
        assert line["metric"] == "stencil3d_cell_updates_per_s" and line["platform"] == "cpu"
        assert line["value"] > 0 and set(line["us_per_step"]) == set(res["screen"])

    def test_config9_lets_a_failing_impl_fail(self):
        from tpuscratch_torch.bench.record import config9_stencil3d

        with pytest.raises(ValueError, match="unknown 3D stencil impl"):
            config9_stencil3d([], iters=1, tile=(8, 8, 8), impls=("compact", "nope"),
                              screen_s=1e-4, final_s=2e-4, device="cpu")
