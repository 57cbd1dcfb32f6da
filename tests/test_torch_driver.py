"""tpuscratch_torch's drivers and benchmark harness: ``distributed_stencil``
for every ported impl against tpuscratch's on the same world, the state
carried across from a JAX run, the refusals, and the headline race on
the CPU. Jacobi coefficients: bit-equal except ``resident``, whose
symmetric form rounds differently from the per-step path both sides use
as the comparison."""

import json
import sys

import numpy as np
import pytest
import torch

from _torch_twins import rand
from tpuscratch.halo import driver as jd
from tpuscratch.runtime.mesh import make_mesh_2d as jax_mesh_2d
from tpuscratch_torch.bench import headline
from tpuscratch_torch.bench.stencil_bench import bench_stencil
from tpuscratch_torch.bench.timing import BenchResult, percentile, time_device
from tpuscratch_torch.halo import driver as td
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.ops import halo_dma as th
from tpuscratch_torch.ops import stencil_kernel as tk
from tpuscratch_torch.ops import stencil_stream as ts
from tpuscratch_torch.runtime.mesh import make_mesh_2d, resolve_device, topology_of
from tpuscratch_torch.runtime.topology import CartTopology

# (impl, halo) for every impl the port runs; stream and dma are held to
# their JAX twins in test_torch_stream.py and test_torch_halo_dma.py
IMPLS = [("xla", 1), ("pallas", 1), ("blocked", 1), ("overlap", 1),
         ("deep", 2), ("deep", 3), ("deep-pallas", 2), ("deep-pallas", 4)]


def _run_both(dims, impl, halo, world, steps, periodic=True):
    want = jd.distributed_stencil(world, steps, mesh=jax_mesh_2d(dims), halo=(halo, halo),
                                  impl=impl, periodic=periodic)
    got = td.distributed_stencil(world, steps, mesh=make_mesh_2d(dims, device="cpu"),
                                 halo=(halo, halo), impl=impl, periodic=periodic)
    return got, want


class TestDistributedStencil:
    @pytest.mark.parametrize("dims", [(1, 1), (2, 4), (4, 2)])
    @pytest.mark.parametrize("impl,halo", IMPLS)
    def test_matches_jax(self, dims, impl, halo):
        got, want = _run_both(dims, impl, halo, rand((16, 24), 40), 6)
        np.testing.assert_array_equal(got, want)

    def test_resident_matches_jax(self):
        got, want = _run_both((1, 1), "resident", 1, rand((32, 128), 41), 5)
        np.testing.assert_array_equal(got, want)

    def test_resident_matches_xla(self):
        # the symmetric form rounds differently from the per-step form:
        # an ulp or so per step on unit-normal data
        world = rand((32, 48), 42)
        res = td.distributed_stencil(world, 16, impl="resident", device="cpu")
        xla = td.distributed_stencil(world, 16, impl="xla", device="cpu")
        np.testing.assert_allclose(res, xla, rtol=0, atol=1e-6)

    def test_open_boundary_matches_jax(self):
        got, want = _run_both((2, 4), "deep", 2, rand((16, 24), 43), 5, periodic=False)
        np.testing.assert_array_equal(got, want)

    def test_sink_event(self):
        events = []

        class Sink:
            def emit(self, kind, **kw):
                events.append((kind, kw))

            def flush(self):
                events.append(("flush", {}))

        td.distributed_stencil(rand((8, 8), 44), 2, device="cpu", sink=Sink())
        assert events[0][0] == "halo/run" and events[0][1]["steps"] == 2
        assert events[-1][0] == "flush"


class TestCarryAcross:
    def test_jax_state_continues_in_torch(self):
        # N steps in JAX, the numpy tiles carried across, M more here ==
        # N + M steps in JAX
        world = rand((16, 24), 45)
        dims, n, m = (2, 4), 3, 4
        mesh = jax_mesh_2d(dims)
        _, topo, lay, spec = jd._setup(world.shape, mesh, (1, 1), True)
        jtiles = jd.decompose(world, topo, lay)
        mid = np.asarray(jd.make_stencil_program(mesh, spec, n)(jtiles))
        want = np.asarray(jd.make_stencil_program(mesh, spec, n + m)(jtiles))

        tmesh = make_mesh_2d(dims, device="cpu")
        _, ttopo, tlay, tspec = td._setup(world.shape, tmesh, (1, 1), True)
        got = td.make_stencil_program(tmesh, tspec, m)(td.tiles_from_numpy(mid, "cpu"))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(td.assemble(got.numpy(), ttopo, tlay),
                                      jd.assemble(want, topo, lay))

    def test_decompose_assemble_match(self):
        world = rand((12, 20), 46)
        topo = CartTopology((2, 4), (True, True))
        lay = TileLayout(6, 5, 2, 2)
        from tpuscratch.halo.layout import TileLayout as JLayout
        from tpuscratch.runtime.topology import CartTopology as JTopo

        jt = jd.decompose(world, JTopo((2, 4), (True, True)), JLayout(6, 5, 2, 2))
        np.testing.assert_array_equal(td.decompose(world, topo, lay), jt)
        np.testing.assert_array_equal(td.assemble(jt, topo, lay), world)

    def test_tiles_from_numpy_wants_stacked_tiles(self):
        with pytest.raises(ValueError, match="rows, cols"):
            td.tiles_from_numpy(np.zeros((4, 4), np.float32), "cpu")


class TestDevice:
    def test_no_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            td.distributed_stencil(rand((8, 8), 47), 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")

    def test_mesh_and_device_must_agree(self):
        with pytest.raises(ValueError, match="mesh device"):
            td.distributed_stencil(rand((8, 8), 48), 1, mesh=make_mesh_2d(device="cpu"),
                                   device="meta")

    def test_mesh(self):
        mesh = make_mesh_2d((2, 4), device="cpu")
        assert mesh.size == 8 and mesh.device == torch.device("cpu")
        assert topology_of(mesh, (True, False)) == CartTopology((2, 4), (True, False))
        assert make_mesh_2d(device="cpu").shape == (1, 1)
        with pytest.raises(ValueError):
            make_mesh_2d((0, 2), device="cpu")


class TestImplStrings:
    @pytest.mark.parametrize("impl", ["stream", "stream:4", "dma", "dma-deep:2", "dma-hbm"])
    def test_unported_impls_name_their_roadmap_item(self, impl):
        # ROADMAP A9 ported these impls: each runs and matches its JAX twin
        got, want = _run_both((1, 1), impl, 1, rand((32, 32), 49), 5)
        np.testing.assert_array_equal(got, want)
        assert not hasattr(td, "NOT_PORTED")

    @pytest.mark.parametrize("impl", ["stream:0", "dma-deep:0", "dma-deep", "stream-x"])
    def test_bad_depths_and_names(self, impl):
        with pytest.raises(ValueError):
            td.distributed_stencil(rand((16, 16), 49), 1, impl=impl, device="cpu")

    def test_unknown_impl(self):
        with pytest.raises(ValueError, match="unknown"):
            td.distributed_stencil(rand((8, 8), 50), 1, impl="fast", device="cpu")

    def test_nine_point_needs_xla(self):
        nine = (0.125,) * 4 + (0.0625,) * 4 + (0.0,)
        with pytest.raises(ValueError, match="9-point"):
            td.distributed_stencil(rand((8, 8), 51), 1, coeffs=nine, impl="pallas", device="cpu")
        for impl in ("stream:2", "dma", "dma-deep:3", "dma-hbm"):  # as the JAX driver
            got = td.distributed_stencil(rand((16, 16), 51), 3, coeffs=nine, impl=impl,
                                         device="cpu")
            xla = td.distributed_stencil(rand((16, 16), 51), 3, coeffs=nine, device="cpu")
            np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-6)
        out = td.distributed_stencil(rand((8, 8), 51), 1, coeffs=nine, device="cpu")
        want = jd.distributed_stencil(rand((8, 8), 51), 1, mesh=jax_mesh_2d((1, 1)), coeffs=nine)
        np.testing.assert_array_equal(out, want)


class TestBench:
    @pytest.mark.parametrize("impl", ["xla", "deep:4", "deep-pallas:4", "resident:8",
                                      "pallas", "blocked", "xla+unroll", "stream:4", "dma",
                                      "dma-deep:8", "dma-hbm"])
    def test_bench_stencil_on_cpu(self, impl):
        r = bench_stencil((32, 32), 8, impl=impl, iters=2, device="cpu")
        assert isinstance(r, BenchResult) and len(r.times_s) == 2
        assert r.items == 32 * 32 * 8 and r.items_per_s > 0
        assert impl in r.name

    def test_timing_helpers(self):
        assert percentile([3.0, 1.0, 2.0], 50) == 2.0
        r = time_device(lambda x: x + 1, torch.zeros(4), iters=3, warmup=1, items=10)
        assert len(r.times_s) == 3 and "items/s" in r.summary()

    def test_headline_race_and_line(self, capsys):
        mesh = make_mesh_2d(device="cpu")
        final, winner, screen = headline.two_phase_stencil(
            ("xla", "deep:4"), (16, 16), mesh, iters=1, screen_s=0.001, final_s=0.002)
        assert winner in screen and set(screen) == {"xla", "deep:4"}
        line = headline.headline_line(final)
        assert list(line) == ["metric", "value", "unit", "vs_baseline"]
        assert line["metric"] == "stencil2d_1024x1024_cell_updates_per_s"
        assert line["vs_baseline"] is None and line["value"] > 0
        json.dumps(line)

    def test_race_does_not_swallow_a_failing_impl(self):
        # stream:32 needs a core at least 32 rows high
        with pytest.raises(ValueError, match="depth"):
            headline.race(("xla", "stream:32"), (16, 16), make_mesh_2d(device="cpu"),
                          iters=1, min_s=0.001)

    def test_headline_ladder_is_bench_py_s(self):
        import ast
        import pathlib
        import re

        src = (pathlib.Path(__file__).parents[1] / "bench.py").read_text()
        ladder = re.search(r"^\s*impls = (\(.*\))$", src, re.M).group(1)
        assert ast.literal_eval(ladder) == headline.IMPLS

    def test_kernels_launch_nothing_on_cpu(self):
        mods = (tk, th, ts)
        for m in mods:
            m.reset_launches()
        td.distributed_stencil(rand((16, 16), 52), 4, halo=(2, 2), impl="deep-pallas",
                               device="cpu")
        for impl in ("stream:2", "dma", "dma-deep:2", "dma-hbm"):
            td.distributed_stencil(rand((16, 16), 52), 4, impl=impl, device="cpu")
        assert sum(sum(m.launch_counts().values()) for m in mods) == 0
        assert "tpuscratch_torch.ops.stencil_kernel" in sys.modules
