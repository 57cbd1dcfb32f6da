"""tpuscratch_torch.dtypes held to tpuscratch.dtypes bit for bit: every case
of tests/test_dtypes.py (mpi7's indexed blocks, mpi8's struct scatter,
mpi-complex-types' hindexed payload, the subarray exchange ring, the serve
KV dtype ladder) run through both packages on the same numpy inputs, the
port's SPMD cases on an 8-rank mesh stacked on the CPU. Specs only move
values, so every comparison is exact; the KV ladder's quantization is the
port's own bit-equal twin of the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import to_torch
from tpuscratch import dtypes as jd
from tpuscratch.comm import broadcast as jbroadcast
from tpuscratch.comm import run_spmd as jrun_spmd
from tpuscratch.comm import scatter_from_root as jscatter
from tpuscratch.runtime.mesh import make_mesh_1d as jmesh_1d
from tpuscratch_torch import dtypes as td
from tpuscratch_torch.comm import P, broadcast, run_spmd, scatter_from_root
from tpuscratch_torch.runtime.mesh import make_mesh_1d

N = 8


def _mesh():
    return make_mesh_1d("x", N, device="cpu")


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


class TestIndexedSpec:
    def test_mpi7_blocks(self):
        t, j = td.IndexedSpec(((5, 4), (12, 2))), jd.IndexedSpec(((5, 4), (12, 2)))
        assert t.size == j.size == 6 and t.blocks == j.blocks
        x = np.arange(16.0, dtype=np.float32)
        _eq(t.pack(to_torch(x)), j.pack(jnp.asarray(x)))

    def test_roundtrip(self):
        t, j = td.IndexedSpec(((0, 2), (6, 3))), jd.IndexedSpec(((0, 2), (6, 3)))
        x, flat = np.zeros(10, np.float32), np.arange(1.0, 6.0, dtype=np.float32)
        x_t = to_torch(x)
        got = t.unpack(to_torch(flat), x_t)
        want = j.unpack(jnp.asarray(flat), jnp.asarray(x))
        _eq(got, want)
        _eq(t.pack(got), j.pack(want))
        assert float(x_t.abs().sum()) == 0.0          # unpack wrote a copy

    def test_validation(self):
        for blocks in (((0, 0),), ((-1, 3),)):
            with pytest.raises(ValueError):
                td.IndexedSpec(blocks)
            with pytest.raises(ValueError):
                jd.IndexedSpec(blocks)
        with pytest.raises(ValueError, match="payload"):
            td.IndexedSpec(((0, 2),)).unpack(torch.ones(3), torch.zeros(4))

    def test_distributed_indexed_send(self):
        # root broadcasts its two blocks; every rank holds them as 6 floats
        t, j = td.IndexedSpec(((5, 4), (12, 2))), jd.IndexedSpec(((5, 4), (12, 2)))
        x = np.arange(16.0, dtype=np.float32)
        want = jrun_spmd(jmesh_1d("x"), lambda a: jbroadcast(j.pack(a), "x", root=0),
                         JP(), JP(None))(jnp.asarray(x))
        got = run_spmd(_mesh(), lambda a: broadcast(t.pack(a), "x", root=0),
                       P(), P(None))(to_torch(x))
        _eq(got, want)


class TestSubarraySpec:
    def test_region_extraction(self):
        t, j = td.SubarraySpec((1, 2), (2, 3)), jd.SubarraySpec((1, 2), (2, 3))
        x = np.arange(30.0, dtype=np.float32).reshape(5, 6)
        _eq(t.region(to_torch(x)), j.region(jnp.asarray(x)))
        assert t.size == j.size == 6

    def test_roundtrip(self):
        t, j = td.SubarraySpec((0, 1), (2, 2)), jd.SubarraySpec((0, 1), (2, 2))
        x, flat = np.zeros((3, 4), np.float32), np.array([1.0, 2, 3, 4], np.float32)
        _eq(t.unpack(to_torch(flat), to_torch(x)), j.unpack(jnp.asarray(flat), jnp.asarray(x)))

    def test_rank_mismatch(self):
        with pytest.raises(ValueError):
            td.SubarraySpec((0,), (2, 2))
        with pytest.raises(ValueError):
            jd.SubarraySpec((0,), (2, 2))

    def test_exchange_packed_ring(self):
        # each rank's top-left 2x2 goes one step around the ring and lands
        # in the bottom-right 2x2 there (send and recv specs differ)
        perm = [(i, (i + 1) % N) for i in range(N)]
        tiles = np.stack([np.full((4, 4), float(i), np.float32) for i in range(N)])
        js, jr = jd.SubarraySpec((0, 0), (2, 2)), jd.SubarraySpec((2, 2), (2, 2))
        want = jrun_spmd(
            jmesh_1d("x"),
            lambda x: jd.exchange_packed(js, x[0], "x", perm, dest_spec=jr)[None],
            JP("x", None, None), JP("x", None, None))(jnp.asarray(tiles))
        ts, tr = td.SubarraySpec((0, 0), (2, 2)), td.SubarraySpec((2, 2), (2, 2))
        # the stacked tile is (ranks, 1, 4, 4): the spec acts on the trailing dims
        got = run_spmd(
            _mesh(), lambda x: td.exchange_packed(ts, x, "x", perm, dest_spec=tr),
            P("x", None, None), P("x", None, None))(to_torch(tiles))
        _eq(got, want)
        assert (got[1, 2:, 2:] == 0.0).all() and (got[0, 2:, 2:] == 7.0).all()


class TestStructSpec:
    FIELDS = ("pos", "vel", "charge", "mass", "id", "flag")

    @staticmethod
    def _particles(n):
        # mpi8's Particle {4 floats; 2 ints} as struct-of-arrays, in numpy
        return {"pos": np.arange(n, dtype=np.float32),
                "vel": np.arange(n, dtype=np.float32) * 2,
                "charge": np.ones(n, np.float32), "mass": np.full(n, 3.0, np.float32),
                "id": np.arange(n, dtype=np.int32), "flag": np.zeros(n, np.int32)}

    def _both(self, n):
        tree = self._particles(n)
        return ({k: to_torch(v) for k, v in tree.items()},
                {k: jnp.asarray(v) for k, v in tree.items()})

    def test_validate(self):
        t, j = td.StructSpec(self.FIELDS), jd.StructSpec(self.FIELDS)
        tt, jt = self._both(16)
        assert t.validate(tt) == j.validate(jt) == 16
        for spec, tree, zeros in ((t, tt, torch.zeros), (j, jt, jnp.zeros)):
            with pytest.raises(ValueError, match="fields"):
                spec.validate(dict(tree, extra=zeros(16)))
            with pytest.raises(ValueError, match="ragged"):
                spec.validate(dict(tree, pos=zeros(3)))

    def test_records_slice(self):
        t, j = td.StructSpec(self.FIELDS), jd.StructSpec(self.FIELDS)
        tt, jt = self._both(16)
        got, want = t.records(tt, 4, 2), j.records(jt, 4, 2)
        for k in self.FIELDS:
            _eq(got[k], want[k])
        assert got["id"].dtype == torch.int32       # mixed dtypes preserved
        # a start past the end clamps as lax.dynamic_slice does
        for k in self.FIELDS:
            _eq(t.records(tt, 15, 2)[k], j.records(jt, 15, 2)[k])

    def test_concat_roundtrip(self):
        t, j = td.StructSpec(self.FIELDS), jd.StructSpec(self.FIELDS)
        tt, jt = self._both(6)
        got = t.concat([t.records(tt, i * 2, 2) for i in range(3)])
        want = j.concat([j.records(jt, i * 2, 2) for i in range(3)])
        for k in self.FIELDS:
            _eq(got[k], want[k])
            _eq(got[k], np.asarray(jt[k]))

    def test_mpi8_scatter(self):
        # root's 16 particles scattered 2 a rank: one collective a field
        tt, jt = self._both(16)
        want = jrun_spmd(jmesh_1d("x"),
                         lambda t: jax.tree.map(lambda a: jscatter(a, "x"), t),
                         JP(), JP("x"))(jt)
        got = run_spmd(_mesh(), lambda t: {k: scatter_from_root(v, "x") for k, v in t.items()},
                       P(), P("x"))(tt)
        for k in self.FIELDS:
            _eq(got[k], want[k])
        assert got["id"].dtype == torch.int32


class TestHIndexedSpec:
    @staticmethod
    def _specs(mod, parts):
        return mod.HIndexedSpec(tuple((i, build(mod)) for i, build in parts))

    def test_complex_types_parity(self):
        parts = ((0, lambda m: m.IndexedSpec(((2, 3),))), (1, lambda m: m.IndexedSpec(((0, 3),))),
                 (2, lambda m: m.IndexedSpec(((5, 3),))))
        t, j = self._specs(td, parts), self._specs(jd, parts)
        arrays = [np.arange(10.0 * i, 10.0 * (i + 1), dtype=np.float32) for i in range(3)]
        assert t.size == j.size == 9
        _eq(t.pack([to_torch(a) for a in arrays]), j.pack([jnp.asarray(a) for a in arrays]))

    def test_unpack_into_separate_arrays(self):
        parts = ((0, lambda m: m.IndexedSpec(((0, 2),))),
                 (1, lambda m: m.SubarraySpec((1, 1), (1, 2))))
        t, j = self._specs(td, parts), self._specs(jd, parts)
        flat, x0, x1 = np.array([1.0, 2, 3, 4], np.float32), np.zeros(4, np.float32), np.zeros(
            (3, 3), np.float32)
        got = t.unpack(to_torch(flat), [to_torch(x0), to_torch(x1)])
        want = j.unpack(jnp.asarray(flat), [jnp.asarray(x0), jnp.asarray(x1)])
        for g, w in zip(got, want):
            _eq(g, w)
        with pytest.raises(ValueError, match="payload"):
            t.unpack(torch.ones(3), [to_torch(x0), to_torch(x1)])

    def test_pack_unpack_inverse(self):
        parts = ((0, lambda m: m.IndexedSpec(((1, 2), (5, 1)))),
                 (1, lambda m: m.SubarraySpec((0, 0), (2, 2))))
        t, j = self._specs(td, parts), self._specs(jd, parts)
        arrays = [np.arange(8.0, dtype=np.float32), np.arange(9.0, dtype=np.float32).reshape(3, 3)]
        tarr = [to_torch(a) for a in arrays]
        payload = t.pack(tarr)
        _eq(payload, j.pack([jnp.asarray(a) for a in arrays]))
        for orig, back in zip(arrays, t.unpack(payload, tarr)):
            _eq(back, orig)


# ---- the serve KV dtype ladder (the JAX file's dtype-contract home) ---------

from tpuscratch.obs.ledger import kv_cache_bytes as j_kv_cache_bytes  # noqa: E402
from tpuscratch.serve import kvcache as jkv  # noqa: E402
from tpuscratch_torch.obs.ledger import kv_cache_bytes  # noqa: E402
from tpuscratch_torch.serve import kvcache as tkv  # noqa: E402


def _fp8_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


class TestKVDtypeLadder:
    def test_fp8_roundtrip_error_bound(self):
        x = np.random.default_rng(0).standard_normal((5, 4, 3, 8)).astype(np.float32) * 3.0
        q, s = tkv.quantize_pages(to_torch(x), torch.float8_e4m3fn)
        jq, js = jkv.quantize_pages(jnp.asarray(x), jnp.float8_e4m3fn)
        assert q.dtype == torch.float8_e4m3fn and tuple(s.shape) == (5, 3)
        np.testing.assert_array_equal(_fp8_bits(q), np.asarray(jq).view(np.uint8))
        _eq(s, js)
        back = tkv.dequantize_pages(q, s).numpy()
        _eq(tkv.dequantize_pages(q, s), jkv.dequantize_pages(jq, js))
        bound = np.abs(x) * 2.0 ** -4 + s.numpy()[:, None, :, None] * 2.0 ** -9 + 1e-7
        assert (np.abs(back - x) <= bound).all()
        amax = np.abs(x).max(axis=(1, 3))
        np.testing.assert_allclose(s.numpy() * tkv.FP8_QMAX, amax, rtol=1e-6)
        np.testing.assert_allclose(np.abs(np.abs(back).max(axis=(1, 3)) - amax), 0.0, atol=1e-6)

    def test_fp8_zero_page_quantizes_to_zero(self):
        q, s = tkv.quantize_pages(torch.zeros(2, 4, 2, 8), torch.float8_e4m3fn)
        assert float(tkv.dequantize_pages(q, s).abs().max()) == 0.0

    def test_fp8_beats_int8_on_outlier_pages(self):
        # one outlier an (page, head): int8's uniform grid loses every
        # inlier's resolution, e4m3's relative grid loses none
        x = np.random.default_rng(1).standard_normal((4, 8, 2, 16)).astype(np.float32) * 0.1
        x[:, 0, :, 0] = 50.0
        inlier = np.ones_like(x, bool)
        inlier[:, 0, :, 0] = False
        errs = {}
        for tdt, jdt in ((torch.int8, jnp.int8), (torch.float8_e4m3fn, jnp.float8_e4m3fn)):
            q, s = tkv.quantize_pages(to_torch(x), tdt)
            jq, js = jkv.quantize_pages(jnp.asarray(x), jdt)
            back = tkv.dequantize_pages(q, s)
            _eq(back, jkv.dequantize_pages(jq, js))
            errs[tdt] = np.abs(back.numpy() - x)[inlier].max()
        assert errs[torch.float8_e4m3fn] < errs[torch.int8] / 5

    def test_quantize_rejects_non_ladder_dtype(self):
        with pytest.raises(ValueError):
            tkv.quantize_pages(torch.zeros(1, 4, 2, 8), torch.int16)
        with pytest.raises(ValueError):
            tkv.init_kv_cache(tkv.CacheGeometry(1, 4, 4, 2, 8), dtype=torch.bfloat16, device="cpu")

    def test_ladder_predicate(self):
        for tdt, jdt in ((torch.int8, jnp.int8), (torch.float8_e4m3fn, jnp.float8_e4m3fn),
                         (torch.float32, jnp.float32)):
            assert tkv.is_quantized_kv_dtype(tdt) == jkv.is_quantized_kv_dtype(jdt)

    def test_fp8_ledger_bytes_match_int8_and_pin(self):
        # fp8 cache bytes == int8's (1 byte an element, the same f32 scale
        # planes) and <= 0.30 of f32's, at both record geometries, equal to
        # the JAX package's bytes
        from tpuscratch.bench.decode_bench import default_decode_setup as j_setup
        from tpuscratch_torch.bench.decode_bench import default_decode_setup

        for on_card in (False, True):
            cfg, scfg, _, _ = default_decode_setup(on_card)
            jcfg, jscfg, _, _ = j_setup(on_card)
            geom = tkv.CacheGeometry(cfg.n_layers, scfg.n_pages, scfg.page_size, cfg.n_heads,
                                     cfg.d_head)
            jgeom = jkv.CacheGeometry(jcfg.n_layers, jscfg.n_pages, jscfg.page_size,
                                      jcfg.n_heads, jcfg.d_head)
            got = {dt: kv_cache_bytes(tkv.init_kv_cache(geom, dtype=dt, device="cpu"))
                   for dt in (torch.float32, torch.int8, torch.float8_e4m3fn)}
            assert got[torch.float32] == j_kv_cache_bytes(jkv.init_kv_cache(jgeom))
            assert got[torch.float8_e4m3fn] == got[torch.int8]
            ratio = got[torch.float8_e4m3fn] / got[torch.float32]
            assert abs(ratio - (0.25 + 1.0 / (geom.page_size * geom.d_head))) < 1e-9
            assert ratio <= 0.30
