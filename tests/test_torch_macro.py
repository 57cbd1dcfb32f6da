"""Macro-step decode in the port (``serve.decode.build_decode_loop``,
``build_spec_decode_loop``, ``macro_occupancy``, the engine's
``macro_steps`` and ``async_macro``) against the JAX package's on the CPU.

Tolerances: none at greedy. Each loop round is one engine tick, so the
tokens, the active masks and the carried slot state equal the JAX loop's,
and the engines' tokens and counters (dispatches, host syncs, rounds)
equal the JAX engine's; every round runs here (no early exit), which
writes and emits nothing in an idle round, so the outputs are the same.
The cache a loop writes is held within 1e-6 of the JAX loop's (XLA's and
torch's float32 products may sum in other orders; the tokens are equal).
The one counter that differs is ``decode_compiles`` under
``async_macro``: the JAX engine traces its loop a second time when a
chained call takes the previous call's device carry; the port builds one
program."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve_twins import (CAPACITY, CFG, SCFG, assert_reports_equal, engines, requests,
                                run_both)
from tpuscratch.models.transformer import TransformerConfig as JaxConfig
from tpuscratch.models.transformer import init_params as jax_init_params
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.serve import decode as jdecode
from tpuscratch.serve.kvcache import init_kv_cache as jax_init_kv
from tpuscratch_torch.models.transformer import TransformerConfig, params_from_numpy
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.serve import decode as tdecode
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.comm.spmd import mesh_context
from tpuscratch_torch.serve.kvcache import CacheGeometry, init_kv_cache, kv_cache_spec
from tpuscratch_torch.serve.sampling import key

# six requests over four slots: mixed prompts (two buckets), budgets 1 to 9
TRAFFIC = [(i, tuple(t % 16 for t in range(1, 2 + (i * 5) % 11)), 1 + (i * 5) % 9)
           for i in range(6)]
# the same with stop tokens: some hit mid-scan, some never
STOPS = [(i, p, 9, (3 + i,) if i % 2 else (11,)) for i, p, _ in TRAFFIC]


@pytest.mark.parametrize("kw", [dict(macro_steps=1), dict(macro_steps=4),
                                dict(macro_steps=4, async_macro=True)],
                         ids=["T1", "T4", "T4-async"])
@CAPACITY
def test_macro_engine_equals_jax(kw, cfg):
    jeng, want, eng, got = run_both(TRAFFIC, cfg=cfg, **kw)
    assert_reports_equal(got, want, skip=("decode_compiles",) if "async_macro" in kw else ())
    assert eng.decode_rounds == jeng.decode_rounds
    assert eng.macro_steps_effective == jeng.macro_steps_effective == kw["macro_steps"]
    assert eng.free_pages() == [32]
    assert got.decode_compiles == 1


def test_outputs_equal_across_T():
    base = None
    for T in (1, 4, 16):
        _, make = engines(macro_steps=T)
        rep = make().run(requests(TRAFFIC))
        base = base or rep
        assert rep.outputs == base.outputs and rep.tokens_generated == base.tokens_generated


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_in_carry_stop_tokens_equal_jax_and_T1(kv_dtype):
    _, want, eng, got = run_both(STOPS, macro_steps=4, kv_dtype=kv_dtype)
    assert_reports_equal(got, want)
    _, make = engines(kv_dtype=kv_dtype)
    ref = make().run(requests(STOPS))
    assert got.outputs == ref.outputs
    stops = {r: s for r, _, _, s in STOPS}
    hit = 0
    for rid, toks in got.outputs:
        at = [j for j, t in enumerate(toks) if t in stops[rid]]
        if at:
            hit += 1
            assert at[0] == len(toks) - 1          # nothing emitted past a stop
    assert hit >= 1 and eng.free_pages() == [32] and eng.cached_pages == 0


@CAPACITY
@pytest.mark.parametrize("dims", [(1, 1), (2, 1)])
def test_spec_composed_with_macro_equals_jax(dims, cfg):
    traffic = [(i, (1 + i % 3, 2) * 4, 8, (2,) if i == 1 else ()) for i in range(4)]
    _, want, _, got = run_both(traffic, dims, cfg, spec_k=3, macro_steps=3)
    assert_reports_equal(got, want)
    assert got.accepted > 0
    if cfg is CFG:   # a dropping MoE's tokens depend on which slots share a round
        _, make = engines(dims, spec_k=3)
        assert got.outputs == make().run(requests(traffic)).outputs


@pytest.mark.parametrize("T", [1, 4, 16])
def test_single_stream_dispatch_identity(T):
    _, make = engines(macro_steps=T)
    eng = make()
    rep = eng.run(requests([(0, (1, 2, 3), 10)]))
    assert rep.dispatches == math.ceil(rep.slot_steps / T) == rep.host_syncs
    assert eng.decode_rounds == rep.slot_steps  # the last dispatch's tail rounds idle


def test_budget_ends_mid_scan_and_mixed_budgets():
    _, make = engines(macro_steps=4)
    rep = make().run(requests([(i, (1 + i, 2), 1 + 3 * i) for i in range(4)]))
    assert {r: len(t) for r, t in rep.outputs} == {i: 1 + 3 * i for i in range(4)}


def test_macro_occupancy_equals_jax():
    mask = np.zeros((6, 4), bool)
    mask[:5, 0] = mask[:2, 1] = mask[:6, 3] = True
    r, occ = tdecode.macro_occupancy(mask)
    jr, jocc = jdecode.macro_occupancy(mask)
    assert (r, occ.tolist()) == (jr, jocc.tolist()) == (6, [5, 2, 0, 6])
    assert tdecode.macro_occupancy(np.zeros((4, 3), bool))[0] == 0


def test_decode_loop_program_equals_jax():
    """One dispatch of the plain loop from the same cache and carry:
    tokens, masks, the carried state and the written cache equal the JAX
    loop's (two slots mid-stream, one idle, one finishing in the scan)."""
    cfg, T = CFG, 5
    geom = CacheGeometry(cfg["n_layers"], 16, 4, cfg["n_heads"],
                         cfg["d_model"] // cfg["n_heads"])
    jparams = jax_init_params(2, JaxConfig(**cfg))
    rng = np.random.default_rng(0)
    kv = {n: (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
          for n, a in jax_init_kv(geom, 1).items()}
    embed = (rng.standard_normal((16, cfg["d_model"])) / 6).astype(np.float32)
    tables = np.full((4, 8), 16, np.int32)
    tables[0, :4], tables[1, :4], tables[3, :3] = [3, 5, 7, 9], [0, 1, 2, 4], [10, 11, 12]
    carry = dict(n_cached=np.array([6, 9, 0, 3], np.int32), rids=np.arange(4, dtype=np.int32),
                 positions=np.array([2, 4, 0, 1], np.int32),
                 budgets=np.array([6, 9, 0, 2], np.int32),
                 last_tok=np.array([3, 7, 0, 5], np.int32))
    stop = np.zeros((4, 16), bool)
    stopped, emitted = np.zeros(4, bool), np.zeros(4, np.int32)
    args = (tables, *carry.values(), stop, stopped, emitted)
    jloop = jdecode.build_decode_loop(jax_mesh((1, 1), ("dp", "sp"), jax.devices()[:1]),
                                      JaxConfig(**cfg), geom, T)
    jout = jloop(jparams, {n: jnp.asarray(a) for n, a in kv.items()}, jnp.asarray(embed),
                 jax.random.key_data(jax.random.key(3)), *(jnp.asarray(a) for a in args))
    tloop = tdecode.build_decode_loop(make_mesh((1, 1), ("dp", "sp"), device="cpu"),
                                      TransformerConfig(**cfg), geom, T)
    tkv = init_kv_cache(geom, device="cpu")             # pools with their write sink
    for n, a in kv.items():
        tkv[n].copy_(torch.from_numpy(a))
    tout = tloop(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"), tkv,
                 torch.from_numpy(embed), key(3, "cpu"), *(torch.from_numpy(a) for a in args))
    for i, (t, j) in enumerate(zip(tout, jout)):
        if i == 2:      # the cache
            for n in kv:
                np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]), rtol=0, atol=1e-6)
        else:
            assert np.array_equal(t.numpy(), np.asarray(j)), i
    assert tout[1][:, 2].sum() == 0 and tout[1][:, 3].sum() == 2   # idle, finishing


def test_macro_steps_validation():
    from tpuscratch_torch.serve import ServeConfig, ServeEngine

    with pytest.raises(ValueError, match="macro_steps"):
        ServeEngine(make_mesh((1, 1), ("dp", "sp"), device="cpu"), TransformerConfig(**CFG),
                    ServeConfig(**dict(SCFG, macro_steps=0)))
    with pytest.raises(ValueError, match="macro_steps"):
        tdecode.build_decode_loop(make_mesh((1, 1), ("dp", "sp"), device="cpu"),
                                  TransformerConfig(**CFG), CacheGeometry(2, 4, 4, 4, 8), 0)


def _masked_write_case(dims, kv_dtype, device):
    """A masked write through ``serve.decode._put`` on a ``dims`` (dp, sp)
    mesh and the same write made entry by entry on the host: (got, want)
    global pools. Token writes (page, offset) on an f32 pool, whole-page
    writes on a quantized one; dropped entries share a kept entry's page,
    and dp rank 1 keeps nothing."""
    from tpuscratch_torch.serve.decode import _put, _Writes

    dp, B, L, li = dims[0], 5, 3, 1
    geom = CacheGeometry(L, 6, 4, 4, 8)
    g = torch.Generator().manual_seed(7)
    pool = init_kv_cache(geom, dp, kv_dtype, device=device)["k"]
    pool.copy_(torch.randn(pool.shape, generator=g).mul(50).to(kv_dtype))
    pages = torch.randint(0, geom.n_pages + 2, (dp, B), generator=g, dtype=torch.int32)
    offs = torch.randint(0, geom.page_size, (dp, B), generator=g, dtype=torch.int32)
    pages[0] = torch.tensor([0, geom.n_pages, 3, 1, geom.n_pages + 1])
    offs[0] = torch.tensor([1, 1, 2, 1, 3])
    if dp > 1:
        pages[1] = geom.n_pages
    tokens = kv_dtype == torch.float32
    row = (geom.n_heads, geom.d_head) if tokens else (geom.page_size, geom.n_heads, geom.d_head)
    vals = torch.randn((dp, B, *row), generator=g).mul(50).to(kv_dtype)
    want = pool.cpu().clone()
    for r in range(dp):
        for b in range(B):
            if pages[r, b] < geom.n_pages:
                at = (li, r * geom.n_pages + int(pages[r, b]))
                want[at + ((int(offs[r, b]),) if tokens else ())] = vals[r, b]

    def body(dst, pg, off, v):
        idx = (pg, off) if tokens else (pg,)
        _put(dst, li, _Writes(idx, pg < geom.n_pages, geom.n_pages, L), v)
        return pg

    vspec = P("dp", "sp", None) if tokens else P("dp", None, "sp", None)   # heads over sp
    prog = run_spmd(make_mesh(dims, ("dp", "sp"), device=device), body,
                    (kv_cache_spec()["k"], P("dp"), P("dp"), vspec), P("dp"))
    prog(pool, *(t.reshape(dp * B, *t.shape[2:]).to(device) for t in (pages, offs, vals)))
    return pool.cpu(), want


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8, torch.float8_e4m3fn],
                         ids=["f32", "int8", "fp8"])
@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_masked_write_lands_bit_equal_dropped_entries_in_the_sink(dims, kv_dtype):
    got, want = _masked_write_case(dims, kv_dtype, "cpu")
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_a_pool_without_the_write_sink_is_refused():
    from tpuscratch_torch.serve.decode import _put, _Writes

    geom = CacheGeometry(2, 4, 4, 2, 8)
    bare = torch.zeros(1, 1, 2, 4, 4, 2, 8)
    pages = torch.zeros(1, 1, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="write sink"):
        with mesh_context(make_mesh((1, 1), ("dp", "sp"), device="cpu")):
            _put(bare, 0, _Writes((pages, pages), pages < geom.n_pages, geom.n_pages, 2),
                 torch.zeros(1, 1, 3, 2, 8))
