"""The port's cached decode programs (``tpuscratch_torch.serve.decode``)
against the JAX package's: ``build_prefill``, ``build_decode_step`` and
``build_context_prefill`` outputs and cache contents on a 1x1 and a 2x2
(dp, sp) mesh, for f32, int8 and fp8 pools. The JAX side runs its dense
attention oracle (``fused=False``); the parameters cross over through
``params_from_numpy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import to_torch
from tpuscratch.models.transformer import TransformerConfig as JaxConfig
from tpuscratch.models.transformer import init_params as jax_init_params
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.serve import decode as jd
from tpuscratch.serve import kvcache as jk
from tpuscratch_torch.models.transformer import TransformerConfig, params_from_numpy
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.serve import decode as td
from tpuscratch_torch.serve import kvcache as tk

# f32 outputs of a 2-layer model: matmuls and softmax sums in another order
ATOL = 1e-5
CFG = dict(d_model=32, n_heads=4, n_experts=4, d_ff=48, n_layers=2, capacity_factor=2.0)
DTYPES = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
PAGE, N_PAGES, MAX_PAGES, B = 4, 8, 4, 4


def _np(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == np.dtype(jnp.float8_e4m3fn) else a


def _same_cache(tkv, jkv, quantized):
    for name in tkv:
        got, want = _np(tkv[name]), _jnp(jkv[name])
        if quantized and name in ("k", "v"):
            np.testing.assert_array_equal(got, want, err_msg=name)  # the quantized pages
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_prefill_decode_and_context_prefill(dims, kv):
    jdt, tdt = DTYPES[kv]
    quant = kv != "float32"
    cfg, jcfg = TransformerConfig(**CFG), JaxConfig(**CFG)
    n = dims[0] * dims[1]
    jm = jax_mesh(dims, ("dp", "sp"), jax.devices()[:n])
    tm = make_mesh(dims, ("dp", "sp"), device="cpu")
    jparams = jax_init_params(1, jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    geom_args = (cfg.n_layers, N_PAGES, PAGE, cfg.n_heads, cfg.d_head)
    jkv = jk.init_kv_cache(jk.CacheGeometry(*geom_args), dims[0], jdt)
    tkv = tk.init_kv_cache(tk.CacheGeometry(*geom_args), dims[0], tdt, device="cpu")
    jgeom, tgeom = jk.CacheGeometry(*geom_args), tk.CacheGeometry(*geom_args)
    rng = np.random.default_rng(7)
    per_group = B // dims[0]
    pages = [[0, 1, 2], [3, 4, 5], [6, 7], [0, 1, 2]] if dims[0] == 1 else \
        [[0, 1, 2], [3, 4, 5], [0, 1, 2], [3, 4, 5]]
    if dims[0] == 1:
        pages[3] = []  # slot 3 stays idle on one group (8 pages)
    lens = [3, 5, 6, 0] if dims[0] == 1 else [3, 5, 6, 2]

    # prefill, one sequence per call at its bucket (8)
    jpre = jd.build_prefill(jm, jcfg, jgeom, quantized=quant)
    tpre = td.build_prefill(tm, cfg, tgeom, quantized=quant)
    for b in range(B):
        if not lens[b]:
            continue
        x = np.zeros((8, cfg.d_model), np.float32)
        x[:lens[b]] = rng.standard_normal((lens[b], cfg.d_model))
        rows = np.full((dims[0], MAX_PAGES), N_PAGES, np.int32)
        rows[b // per_group, :len(pages[b])] = pages[b]
        jout, jkv = jpre(jparams, jkv, jnp.asarray(x), jnp.asarray(rows), jnp.int32(lens[b]))
        tout, tkv = tpre(tparams, tkv, to_torch(x), to_torch(rows), lens[b])
        np.testing.assert_allclose(tout.numpy()[:lens[b]], np.asarray(jout)[:lens[b]], atol=ATOL)
    _same_cache(tkv, jkv, quant)

    def tables():
        t = np.full((B, MAX_PAGES), N_PAGES, np.int32)
        for b in range(B):
            t[b, :len(pages[b])] = pages[b]
        return t

    # two decode steps (the idle slot carries the sentinel and seq_len 0)
    jdec = jd.build_decode_step(jm, jcfg, jgeom, quantized=quant, fused=False)
    tdec = td.build_decode_step(tm, cfg, tgeom, quantized=quant)
    for _ in range(2):
        x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
        wp = np.array([pages[b][lens[b] // PAGE] if lens[b] else N_PAGES for b in range(B)],
                      np.int32)
        wo = np.array([lens[b] % PAGE for b in range(B)], np.int32)
        sl = np.array([lens[b] + 1 if lens[b] else 0 for b in range(B)], np.int32)
        args = (x, tables(), wp, wo, sl)
        jout, jkv = jdec(jparams, jkv, *map(jnp.asarray, args))
        tout, tkv = tdec(tparams, tkv, *map(to_torch, args))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
        _same_cache(tkv, jkv, quant)
        lens = [n + 1 if n else 0 for n in lens]

    # one context-prefill chunk of 3 (K = 3 queries through one sweep);
    # slot 1 takes 2 tokens, the third position padding
    chunk = 3
    jctx = jd.build_context_prefill(jm, jcfg, jgeom, chunk, quantized=quant, fused=False)
    tctx = td.build_context_prefill(tm, cfg, tgeom, chunk, quantized=quant)
    take = [3, 2, 0, 1 if lens[3] else 0]
    x = rng.standard_normal((B, chunk, cfg.d_model)).astype(np.float32)
    wp = np.full((B, chunk), N_PAGES, np.int32)
    wo = np.zeros((B, chunk), np.int32)
    for b in range(B):
        for j in range(take[b]):
            wp[b, j] = pages[b][(lens[b] + j) // PAGE]
            wo[b, j] = (lens[b] + j) % PAGE
        x[b, take[b]:] = 0.0
    sl = np.array([lens[b] + 1 if take[b] else 0 for b in range(B)], np.int32)
    args = (x, tables(), wp, wo, sl)
    jout, jkv = jctx(jparams, jkv, *map(jnp.asarray, args))
    tout, tkv = tctx(tparams, tkv, *map(to_torch, args))
    for b in range(B):
        np.testing.assert_allclose(tout.numpy()[b, :take[b]], np.asarray(jout)[b, :take[b]],
                                   atol=ATOL)
    _same_cache(tkv, jkv, quant)


def test_program_counter_and_refusals():
    cfg = TransformerConfig(**CFG)
    geom = tk.CacheGeometry(cfg.n_layers, N_PAGES, PAGE, cfg.n_heads, cfg.d_head)
    counter = td.ProgramCounter()
    step = td.build_decode_step(make_mesh((1, 1), ("dp", "sp"), device="cpu"), cfg, geom,
                                counter=counter)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_init_params(0, JaxConfig(**CFG))), "cpu")
    kv = tk.init_kv_cache(geom, device="cpu")
    z = torch.zeros(2, dtype=torch.int32)
    for _ in range(3):
        step(params, kv, torch.zeros(2, cfg.d_model), torch.full((2, 1), N_PAGES, dtype=torch.int32),
             z + N_PAGES, z, z)
    assert counter.count == 1
    assert not kv["k"].any()  # idle slots write nothing
    with pytest.raises(ValueError, match="does not match"):
        td.build_decode_step(make_mesh((1, 1), ("dp", "sp"), device="cpu"), cfg,
                             tk.CacheGeometry(1, 4, 4, 4, 8))
    with pytest.raises(ValueError, match="n_heads"):
        td.check_serve_mesh(make_mesh((1, 3), ("dp", "sp"), device="cpu"), cfg)
    assert td.propose_draft((1, 2, 3, 1, 2), 2) == jd.propose_draft((1, 2, 3, 1, 2), 2) == (3, 1)
    needs = [(0, 0, frozenset({1, 2})), (1, 0, frozenset({3})), (2, 0, frozenset({1, 2, 4}))]
    for reorder in (True, False):
        assert td.plan_sweep_waves(needs, 3, reorder) == jd.plan_sweep_waves(needs, 3, reorder)
