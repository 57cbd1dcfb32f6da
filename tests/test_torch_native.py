"""tpuscratch_torch.native (the planner and the host pool over the native
library the port builds) against tpuscratch.native and the pure-Python
planner.

The planner: every neighbor, permutation and rectangle, and the full 2D
and 3D plans, equal the JAX package's native planner's and the port's
Python planner's (``halo.exchange.python_plan``, ``halo.halo3d.
python_plan3d``), transfer for transfer, on periodic, open, mixed and
ragged meshes up to 64x64 ranks; the halo plans the port's exchanges use
are the native ones. The host pool: the cases of tests/test_hostpool.py
(alignment, reuse, stats, views that refuse a free, finalizers) on the
port's binding, and its tensor views. Everything here is integer
bookkeeping, so every comparison is exact.
"""

import gc
import itertools
import threading
import weakref

import numpy as np
import pytest
import torch

from tpuscratch import native as jn
from tpuscratch.halo import halo3d as jh3
from tpuscratch.halo.exchange import HaloSpec as JHaloSpec
from tpuscratch.halo.layout import TileLayout as JLayout
from tpuscratch.runtime.topology import CartTopology as JTopo
from tpuscratch_torch import native
from tpuscratch_torch.halo import exchange as tex
from tpuscratch_torch.halo import halo3d as th3
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.native import hostpool
from tpuscratch_torch.ops import common
from tpuscratch_torch.runtime.topology import ALL_DIRECTIONS, CartTopology

torch.set_num_threads(1)

CONFIGS = [((2, 4), (True, True)), ((3, 3), (True, True)), ((3, 3), (False, False)),
           ((1, 1), (True, True)), ((4, 2), (True, False)), ((1, 5), (False, True)),
           ((5, 3), (False, True)), ((64, 64), (True, True)), ((64, 64), (False, False))]
CONFIGS_3D = [
    ((2, 2, 2), (True, True, True), (4, 6, 8), (1, 1, 1)),
    ((1, 2, 4), (False, True, False), (2, 2, 2), (1, 1, 1)),
    ((3, 2, 2), (True, False, True), (4, 4, 4), (2, 1, 1)),
    ((1, 1, 1), (True, True, True), (2, 2, 2), (1, 1, 1)),
    ((2, 3, 1), (False, False, False), (5, 3, 7), (2, 3, 1)),
]


@pytest.fixture(scope="module", autouse=True)
def _jax_native_built():
    # the JAX package's library as its own tests build it
    if not ((jn.available() and jn.has_plan3d()) or jn.build()):
        pytest.fail("the JAX package's native library did not build")


class TestBuild:
    def test_library_builds_into_the_kernels_build_dir(self):
        lib = native.load()
        assert native.BUILD_DIR == common.BUILD_DIR
        path = native.build()
        assert path.parent == common.BUILD_DIR and path.exists()
        assert path.name.startswith("libtpuscratch_native_")
        assert native.has_plan3d() and lib.ts_abi_version() == native.ABI_VERSION

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        bad = tmp_path / "broken.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCES", (bad,))
        with pytest.raises(RuntimeError, match="building the native library failed"):
            native.build()
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        monkeypatch.setattr(native, "SOURCES", (tmp_path / "other.cpp",))
        (tmp_path / "other.cpp").write_text("int x;\n")
        with pytest.raises(RuntimeError, match="cannot run"):
            native.build()


class TestPlanner:
    @pytest.mark.parametrize("dims,periodic", CONFIGS[:7])
    def test_neighbor_and_permutation(self, dims, periodic):
        topo = CartTopology(dims, periodic)
        for d in ALL_DIRECTIONS:
            want = jn.send_permutation(dims, periodic, d.offset)
            assert native.send_permutation(dims, periodic, d.offset) == want
            assert want == list(topo.send_permutation(d))
            for rank in topo.ranks():
                got = native.neighbor(dims, periodic, rank, d.offset)
                assert got == jn.neighbor(dims, periodic, rank, d.offset) == topo.neighbor(rank, d)

    @pytest.mark.parametrize("core,halo", [((16, 16), (2, 2)), ((8, 12), (1, 3)), ((6, 7), (2, 1))])
    def test_rects(self, core, halo):
        lay = TileLayout(core[0], core[1], halo[0], halo[1])
        for d in ALL_DIRECTIONS:
            hr = native.halo_rect(*core, *halo, d.offset)
            sr = native.send_rect(*core, *halo, d.offset)
            assert hr == jn.halo_rect(*core, *halo, d.offset)
            assert sr == jn.send_rect(*core, *halo, d.offset)
            r, s = lay.halo_region(d), lay.send_region(d)
            assert hr == (*r.offsets, *r.shape) and sr == (*s.offsets, *s.shape)

    @pytest.mark.parametrize("dims,periodic", CONFIGS)
    @pytest.mark.parametrize("neighbors", [4, 8])
    @pytest.mark.parametrize("lay", [(8, 8, 2, 2), (5, 9, 1, 3)])
    def test_full_plan(self, dims, periodic, neighbors, lay):
        want = jn.build_plan(dims, periodic, *lay, neighbors)
        assert native.build_plan(dims, periodic, *lay, neighbors) == want
        topo, layout = CartTopology(dims, periodic), TileLayout(*lay)
        plan = tex.HaloSpec(layout=layout, topology=topo, neighbors=neighbors).plan()
        assert plan == tex.python_plan(layout, topo, neighbors)
        jplan = JHaloSpec(layout=JLayout(*lay), topology=JTopo(dims, periodic),
                          neighbors=neighbors).plan()
        assert len(plan) == len(jplan) == len(want)
        for t, j, nat in zip(plan, jplan, want):
            assert t.direction.offset == j.direction.offset == nat["direction"]
            assert (t.send.offsets, t.send.shape) == (j.send.offsets, j.send.shape)
            assert (t.recv.offsets, t.recv.shape) == (j.recv.offsets, j.recv.shape)
            assert (*t.recv.offsets, *t.recv.shape) == nat["recv_rect"]
            assert t.perm == j.perm and list(t.perm) == nat["perm"]
            assert t.has_sender == j.has_sender

    @pytest.mark.parametrize("neighbors", [6, 26])
    @pytest.mark.parametrize("dims,periodic,core,halo", CONFIGS_3D)
    def test_plan3d(self, dims, periodic, core, halo, neighbors):
        want = jn.build_plan3d(dims, periodic, core, halo, neighbors)
        assert native.build_plan3d(dims, periodic, core, halo, neighbors) == want
        topo, lay = CartTopology(dims, periodic), th3.TileLayout3D(core, halo)
        plan = th3.HaloSpec3D(layout=lay, topology=topo, neighbors=neighbors).plan()
        assert len(plan) == neighbors
        assert plan == th3.python_plan3d(lay, topo, neighbors)
        jplan = jh3._cached_plan3d(jh3.TileLayout3D(core, halo), JTopo(dims, periodic),
                                   neighbors)
        for t, j in zip(plan, jplan):
            assert t.offset == j.offset and t.perm == j.perm and t.has_sender == j.has_sender
            assert (t.send.offsets, t.send.shape, t.recv.offsets, t.recv.shape) == (
                j.send.offsets, j.send.shape, j.recv.offsets, j.recv.shape)

    def test_rejects_bad_config(self):
        for call in (lambda m: m.build_plan((2, 4), (True, True), 8, 8, 9, 2),
                     lambda m: m.build_plan((2, 4), (True, True), 8, 8, 1, 1, neighbors=5),
                     lambda m: m.build_plan3d((2, 2, 2), (True,) * 3, (4, 4, 4), (1, 1, 1), 7)):
            with pytest.raises(ValueError):
                call(native)
            with pytest.raises(ValueError):
                call(jn)

    def test_neighbor3d_open_boundary(self):
        lib = native.load()
        for args in itertools.product((0, 1), (0, 3, 7), (-1, 1)):
            per, rank, dz = args
            got = lib.ts_neighbor3d(2, 2, 2, per, 0, 0, rank, dz, 0, 0)
            assert got == jn.load().ts_neighbor3d(2, 2, 2, per, 0, 0, rank, dz, 0, 0)
        assert lib.ts_neighbor3d(2, 2, 2, 0, 0, 0, 0, -1, 0, 0) == -1
        assert lib.ts_neighbor3d(2, 2, 2, 1, 0, 0, 0, -1, 0, 0) == 4


# ---- the host pool (tests/test_hostpool.py's cases) -------------------------


@pytest.fixture()
def pool():
    with hostpool.HostPool(lock_pages=False) as p:
        yield p


class TestHostPool:
    def test_alloc_is_page_aligned(self, pool):
        with pool.alloc(100) as buf:
            assert buf.ptr % 4096 == 0 and buf.nbytes == 100

    def test_data_roundtrip_through_view_and_tensor(self, pool):
        data = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
        with pool.alloc(data.nbytes) as buf:
            view = buf.view(np.float32, (1000,))
            np.copyto(view, data)
            t = buf.tensor(torch.float32, (1000,))
            assert t.data_ptr() == buf.ptr              # zero-copy
            np.testing.assert_array_equal(t.numpy(), data)
            t.mul_(2.0)
            np.testing.assert_array_equal(view, 2 * data)
            del view, t  # free() (the with-exit) refuses while views are alive

    def test_free_then_alloc_reuses_buffer(self, pool):
        buf = pool.alloc(5000)
        first = buf.ptr
        buf.free()
        buf2 = pool.alloc(6000)  # the same 8192-byte size class
        assert buf2.ptr == first and pool.stats()["reuse_hits"] == 1
        buf2.free()

    def test_stats_accounting(self, pool):
        assert tuple(pool.stats())[:8] == hostpool._STATS_FIELDS
        a, b = pool.alloc(4096), pool.alloc(4096)
        s = pool.stats()
        assert (s["bytes_in_use"], s["high_water"], s["alloc_calls"]) == (8192, 8192, 2)
        a.free()
        s = pool.stats()
        assert (s["bytes_in_use"], s["bytes_cached"], s["high_water"]) == (4096, 4096, 8192)
        b.free()
        pool.trim()
        s = pool.stats()
        assert (s["bytes_in_use"], s["bytes_cached"], s["page_class"]) == (0, 0, 4096)
        assert s["trim_calls"] == 1

    def test_alloc_pages_and_traffic_counters(self, pool):
        with pool.alloc_pages(4, 1000) as buf:
            assert buf.nbytes == 4000 and pool.stats()["live_buffers"] == 1
            with pool.alloc_pages(2, 1000):
                assert pool.stats()["live_buffers_hw"] >= 2
        pool.note_spill(4000)
        pool.note_spill(1000)
        pool.note_prefetch(2500)
        s = pool.stats()
        assert s["spill_bytes"] == 5000 and s["prefetch_bytes"] == 2500
        with pytest.raises(ValueError):
            pool.alloc_pages(0, 1000)

    def test_traffic_counters_are_thread_safe(self, pool):
        def worker():
            for _ in range(500):
                pool.note_spill(2)
                pool.note_prefetch(3)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert pool.stats()["spill_bytes"] == 4000 and pool.stats()["prefetch_bytes"] == 6000

    def test_size_class_rounding(self, pool):
        with pool.alloc(4097) as buf:
            assert buf.nbytes == 4097
        assert pool.stats()["bytes_cached"] == 8192

    def test_double_free_and_stale_view_guard(self, pool):
        buf = pool.alloc(64)
        buf.free()
        buf.free()  # idempotent
        with pytest.raises(ValueError):
            buf.view(np.uint8)
        with pytest.raises(ValueError):
            buf.tensor()
        with pytest.raises(ValueError):
            _ = buf.ptr

    def test_bad_sizes(self, pool):
        with pool.alloc(100) as buf:
            with pytest.raises(ValueError):
                buf.view(np.float32, (1000,))
            with pytest.raises(ValueError):
                buf.tensor(torch.float32, (1000,))
        with pytest.raises(ValueError):
            pool.alloc(0)
        with pytest.raises(MemoryError):
            pool.alloc(2**63 + 1)

    def test_lock_pages_graceful_fallback(self):
        with hostpool.HostPool(lock_pages=True) as p:
            with p.alloc(4096):
                s = p.stats()
                assert s["locked_bytes"] > 0 or s["lock_failures"] > 0

    def test_concurrent_alloc_free(self, pool):
        errors = []

        def churn():
            try:
                for _ in range(200):
                    with pool.alloc(2048) as buf:
                        buf.view(np.uint8)[0] = 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=churn) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors and pool.stats()["bytes_in_use"] == 0

    def test_free_refuses_while_a_view_or_tensor_lives(self, pool):
        buf = pool.alloc(4096)
        v = buf.view(np.float32)
        with pytest.raises(ValueError, match="live view"):
            buf.free()
        del v
        t = buf.tensor(torch.float32)
        with pytest.raises(ValueError, match="live view"):
            buf.free()
        del t
        buf.free()
        assert buf._ptr is None

    def test_abandoned_pool_finalized(self):
        p = hostpool.HostPool(lock_pages=False)
        fin = p._finalizer
        assert fin.alive
        del p
        gc.collect()
        assert not fin.alive

    def test_close_then_finalizer_single_destroy(self):
        p = hostpool.HostPool(lock_pages=False)
        p.close()
        assert p._handle is None and not p._finalizer.alive
        p.close()  # idempotent

    def test_view_keeps_pool_alive(self):
        # a live tensor view pins its buffer and the pool, or the pool's
        # finalizer would free the pages under it
        p = hostpool.HostPool(lock_pages=False)
        ref = weakref.ref(p)
        t = p.alloc(4096).tensor(torch.float32)
        del p
        gc.collect()
        assert ref() is not None and ref()._finalizer.alive
        t[:] = 1.0
        assert float(t[0]) == 1.0
        del t
        gc.collect()
        assert ref() is None

    def test_default_pool_singleton_and_staging_bench(self):
        from tpuscratch_torch.bench.pingpong import (native_pool_staging_roundtrip,
                                                     pageable_buffer_staging_roundtrip)

        assert hostpool.default_pool() is hostpool.default_pool()
        res = native_pool_staging_roundtrip(1024, iters=2, device="cpu")
        control = pageable_buffer_staging_roundtrip(1024, iters=2, device="cpu")
        assert res.p50 > 0 and control.p50 > 0
        assert res.bytes_moved == control.bytes_moved == 2 * 1024 * 4
        assert hostpool.default_pool().stats()["live_buffers"] == 0

    def test_registering_needs_the_card(self, pool):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pool.alloc(4096) as buf:
            with pytest.raises((RuntimeError, AssertionError)):
                buf.register_with_card()
            buf.unregister_from_card()  # nothing registered: a no-op


def test_async_checkpointer_takes_a_pool(tmp_path):
    # on the CPU the leaves are copied at once (the pool stages only CUDA
    # leaves): the same published checkpoint with and without a pool
    from tpuscratch_torch.runtime import checkpoint
    from tpuscratch_torch.runtime.async_ckpt import AsyncCheckpointer

    tree = {"w": torch.arange(12.0).reshape(3, 4), "n": np.int32(5)}
    with hostpool.HostPool(lock_pages=False) as p:
        for name, pool in (("a", None), ("b", p)):
            with AsyncCheckpointer(pool=pool) as ck:
                ck.snapshot(tmp_path / name, 3, tree)
        assert p.stats()["live_buffers"] == 0
    for name in ("a", "b"):
        got, step, _ = checkpoint.restore(tmp_path / name, tree)
        assert step == 3 and torch.equal(got["w"], tree["w"]) and int(got["n"]) == 5
