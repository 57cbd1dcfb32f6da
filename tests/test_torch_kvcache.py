"""The port's paged KV cache (``tpuscratch_torch.serve.kvcache``) against
the JAX package's: int8/fp8 page quantization bit for bit, the allocator's
id sequence, the cache layout and its byte count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import to_torch
from tpuscratch.obs.ledger import kv_cache_bytes as jax_kv_cache_bytes
from tpuscratch.serve import kvcache as jk
from tpuscratch_torch.serve import kvcache as tk

LADDER = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]


def _pages(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., 0, -1, -1] *= 40.0  # an outlier: the int8 grid flattens small entries
    return x


@pytest.mark.parametrize("jdt,tdt", LADDER)
@pytest.mark.parametrize("shape", [(3, 4, 2, 8), (2, 5, 4, 3, 16), (4, 2, 1)])
def test_quantize_dequantize_bit_equal(jdt, tdt, shape):
    x = _pages(len(shape), shape)
    x[0] = 0.0  # an all-zero page: the scale floor
    jq, js = jk.quantize_pages(jnp.asarray(x), jdt)
    tq, ts = tk.quantize_pages(to_torch(x), tdt)
    assert tq.dtype == tdt and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.dequantize_pages(tq, ts).numpy(),
                                  np.asarray(jk.dequantize_pages(jq, js)))


def test_quantize_refuses_f32():
    with pytest.raises(ValueError, match="not a quantized rung"):
        tk.quantize_pages(torch.zeros(1, 4, 2, 8), torch.float32)


def test_allocator_matches_jax_under_a_scripted_sequence():
    script = [("alloc", 3), ("alloc", 2), ("free", [1, 3]), ("share", [0, 4]), ("alloc", 4),
              ("free", [0]), ("free", [0, 4, 2]), ("alloc", 9), ("alloc", 2), ("free", [4]),
              ("alloc", 1), ("free", [5, 6, 1]), ("alloc", 4)]
    a, b = jk.PageAllocator(8), tk.PageAllocator(8)
    for op, arg in script:
        if op == "alloc":
            assert a.alloc(arg) == b.alloc(arg)
        elif op == "free":
            assert a.free(arg) == b.free(arg)
        else:
            a.share(arg)
            b.share(arg)
        assert (a.n_free, a.n_live) == (b.n_free, b.n_live)
        assert [a.refcount(p) for p in range(8)] == [b.refcount(p) for p in range(8)]
    for bad in (lambda x: x.free([99]), lambda x: x.share([99]), lambda x: x.alloc(-1)):
        for x in (a, b):
            with pytest.raises(ValueError):
                bad(x)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32)] + LADDER)
def test_cache_layout_and_bytes(jdt, tdt):
    geom_args = (4, 512, 16, 8, 128)  # config 12's geometry
    jc = jk.init_kv_cache(jk.CacheGeometry(*geom_args), 2, jdt)
    tc = tk.init_kv_cache(tk.CacheGeometry(*geom_args), 2, tdt, device="meta")
    assert {n: tuple(t.shape) for n, t in tc.items()} == {n: t.shape for n, t in jc.items()}
    assert tk.kv_cache_bytes(tc) == jax_kv_cache_bytes(jc)
    quant = tk.is_quantized_kv_dtype(tdt)
    assert quant == jk.is_quantized_kv_dtype(jdt)
    assert {n: tuple(s) for n, s in tk.kv_cache_spec(quantized=quant).items()} == {
        n: tuple(s) for n, s in jk.kv_cache_spec(quantized=quant).items()}


def test_geometry_and_ladder_refusals():
    g = tk.CacheGeometry(1, 4, 4, 2, 8)
    assert (g.max_tokens, g.pages_for(9)) == (16, 3)
    with pytest.raises(ValueError, match="n_pages"):
        tk.CacheGeometry(1, 0, 4, 2, 8)
    with pytest.raises(ValueError, match="ladder"):
        tk.init_kv_cache(g, dtype=torch.float16)
