"""Single-token decode, K-token verify / context prefill, and prompt prefill
over the paged KV cache.

The twin of ``tpuscratch.serve.decode`` (its default-path part): the same
parameter tree, ``_rms_norm``, projections and MoE as the transformer, but
attention reads and extends the block-paged cache
(``ops.attention.decode_attention`` / ``verify_attention``, which launch
the paged-attention kernel on the card).

Mesh mapping, as in the JAX package: decode slots split over "dp" (each
group decodes its own slots against its own page pool); heads split over
"sp" (every rank projects q/k/v from the replicated weights, keeps its
head slice, attends its cached head slice, and the output projection sums
row blocks of ``wo`` over sp); the MoE FFN runs ``expert_parallel_ffn``
over "dp". Every body runs under ``comm.run_spmd`` on stacked ``(*mesh,
...)`` tensors.

The JAX programs donate the cache and return the new one; here the cache
tensors are updated in place (``index_put_`` through the stacked views of
each layer), and each ``build_*`` program returns the same cache dict
beside its output. A JAX ``mode="drop"`` scatter becomes a write of only
the entries whose page id is in range (sentinel ids ``>= n_pages`` write
nothing).

Each ``build_*`` program is counted by a :class:`ProgramCounter` at its
first call, the number the JAX package's compile counter reports (one per
prefill bucket, one decode program).

The device-resident loops (``build_decode_loop``, ``build_spec_decode_loop``)
run T whole engine ticks in one call with the slot state carried on the
device: no value crosses to the host until the caller pulls the outputs.
The JAX loops skip idle rounds with ``lax.cond`` on a mesh-wide psum; that
predicate would need a host read here, so every round runs, masked (an
idle round writes nothing and emits nothing, so the outputs are the
same), and a dispatch launches each layer's attention T times.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.spmd import P, axis_index, axis_size, lead_index, run_spmd
from tpuscratch_torch.models.transformer import (
    TransformerConfig,
    _lead,
    _mm,
    _nmesh,
    _rms_norm,
    param_spec,
)
from tpuscratch_torch.ops.attention import decode_attention, verify_attention
from tpuscratch_torch.parallel.expert import expert_parallel_ffn
from tpuscratch_torch.parallel.scores import masked_scores, masked_softmax
from tpuscratch_torch.runtime.mesh import StackedMesh
from tpuscratch_torch.serve.kvcache import (
    CacheGeometry,
    dequantize_pages,
    kv_cache_spec,
    quantize_pages,
)
from tpuscratch_torch.serve.sampling import accept_batch, request_keys, sample_batch


class ProgramCounter:
    """Counts the ``build_*`` programs that have run: ``wrap`` returns
    a program that adds one to ``count`` at its first call (the JAX
    package counts a trace there, which is when it compiles)."""

    def __init__(self) -> None:
        self.count = 0

    def wrap(self, fn):
        first = [True]

        def counted(*args):
            if first[0]:
                first[0] = False
                self.count += 1
            return fn(*args)

        return counted


def plan_sweep_waves(needs: Sequence[tuple[int, int, frozenset]], capacity: int,
                     reorder: bool = True) -> list[list[int]]:
    """Partition sweeping slots into waves whose page footprints fit one
    group's device pool together (a copy of the JAX package's planner).
    ``needs`` is ``(slot, group, frozenset_of_pages)`` per slot in slot
    order; ``reorder`` grows each wave greedily by the slot sharing the
    most pages with it (ties: fewest fresh pages, then lowest slot id),
    else slot-order first fit. Waves are returned slot-sorted."""
    if not reorder:
        waves: list[list[int]] = []
        cur: list[int] = []
        cur_pages: dict[int, set] = {}
        for slot, group, pages in needs:
            merged = cur_pages.get(group, set()) | pages
            if cur and len(merged) > capacity:
                waves.append(cur)
                cur, cur_pages = [], {}
                merged = set(pages)
            cur.append(slot)
            cur_pages[group] = merged
        if cur:
            waves.append(cur)
        return waves
    remaining = list(needs)
    waves = []
    while remaining:
        slot, group, pages = remaining.pop(0)
        cur = [slot]
        cur_pages = {group: set(pages)}
        while True:
            best = None  # (overlap, -added, -idx) maximized
            for idx, (s, g, pg) in enumerate(remaining):
                have = cur_pages.get(g, set())
                merged = have | pg
                if len(merged) > capacity:
                    continue
                key = (len(have & pg), -(len(merged) - len(have)), -idx)
                if best is None or key > best[0]:
                    best = (key, idx)
            if best is None:
                break
            s, g, pg = remaining.pop(best[1])
            cur.append(s)
            cur_pages[g] = cur_pages.get(g, set()) | pg
        waves.append(sorted(cur))
    return waves


def propose_draft(context: Sequence[int], k: int, ngram: int = 2) -> tuple[int, ...]:
    """Self-drafting prompt-lookup proposal (a copy of the JAX package's):
    the (up to) ``k`` tokens that followed the most recent earlier
    occurrence of the context's final ``ngram`` tokens, preferring a full
    ``k``-token continuation; ``()`` when the suffix never repeats."""
    if k < 1 or ngram < 1:
        return ()
    ctx = tuple(int(t) for t in context)
    n = len(ctx)
    if n < ngram + 1:
        return ()
    suffix = ctx[n - ngram:]
    partial: tuple[int, ...] = ()
    for i in range(n - ngram - 1, -1, -1):
        if ctx[i:i + ngram] == suffix:
            cont = ctx[i + ngram: i + ngram + k]
            if len(cont) == k:
                return cont
            if not partial:
                partial = cont
    return partial


def _axis_len(mesh: StackedMesh, name: str) -> int:
    if name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} lack {name!r}")
    return mesh.shape[mesh.axis_names.index(name)]


def check_serve_mesh(mesh: StackedMesh, cfg: TransformerConfig, dp: str = "dp",
                     sp: str = "sp") -> None:
    """The serve-side mesh preconditions (decode and prefill share them)."""
    if cfg.n_experts % _axis_len(mesh, dp):
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by dp size "
                         f"{_axis_len(mesh, dp)}")
    if cfg.n_heads % _axis_len(mesh, sp):
        raise ValueError(f"serving shards heads over sp: n_heads {cfg.n_heads} not "
                         f"divisible by sp size {_axis_len(mesh, sp)}")


def _check_geometry(cfg: TransformerConfig, geom: CacheGeometry) -> None:
    """A cache built for a different model fails at build time."""
    if (geom.n_layers, geom.n_heads, geom.d_head) != (cfg.n_layers, cfg.n_heads, cfg.d_head):
        raise ValueError(
            f"cache geometry (layers={geom.n_layers}, heads={geom.n_heads}, "
            f"d_head={geom.d_head}) does not match the model (layers={cfg.n_layers}, "
            f"heads={cfg.n_heads}, d_head={cfg.d_head})")


def _own_block(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (cut into the axis size):
    the stacked ``dynamic_slice(t, axis_index(axis) * size, size)``."""
    n = axis_size(axis)
    if n == 1:
        return t
    dim = dim % t.ndim
    u = t.unflatten(dim, (n, t.shape[dim] // n))
    idx = axis_index(axis)
    idx = idx.view(*idx.shape, *([1] * (u.ndim - idx.ndim)))
    return torch.take_along_dim(u, idx, dim=dim).squeeze(dim)


def _head_slice(t: torch.Tensor, sp: str) -> torch.Tensor:
    """This sp rank's head slice of a ``(..., n_heads, d_head)`` projection."""
    return _own_block(t, sp, -2)


def _attn_residual(p, attn_loc, x, cfg: TransformerConfig, sp: str):
    """Output projection of this rank's head slice: its row block of the
    replicated ``wo``, summed over sp."""
    rows_loc = (cfg.n_heads // axis_size(sp)) * cfg.d_head
    wo_rows = _own_block(p["wo"], sp, -2)
    flat = attn_loc.reshape(*attn_loc.shape[:-2], rows_loc)
    y = _mm(flat, wo_rows)
    return x + (allreduce_sum(y, sp) if axis_size(sp) > 1 else y)


def _moe_residual(p, x, cfg: TransformerConfig, dp: str):
    h = _rms_norm(x, _lead(p["ln2"], x.ndim))
    moe, _ = expert_parallel_ffn(h, p["gate"], p["w_in"], p["w_out"], dp,
                                 capacity_factor=cfg.capacity_factor)
    return x + moe


class _Writes:
    """Where one masked write lands, planned once for every layer and pool
    it writes (the JAX ``.at[li, *idx].set(vals, mode="drop")``, with no
    read of the device from the host).

    Kept entries land on their targets, which they never share (distinct
    positions, or distinct pages). Dropped entries all land on the pool's
    write sink, the page that ``init_kv_cache`` leaves in each pool's
    storage past its end: in the stacked view it is page ``n_pages`` of
    the last layer at every mesh dim's last index, which no table
    reaches. So a scatter with duplicate indices (no defined winner on
    the card) only ever races on the sink, and the pool reads as after
    the masked write, bit for bit. ``idx`` tensors (a page id first) and
    ``valid`` are ``(*mesh, *b)``."""

    def __init__(self, idx: tuple, valid: torch.Tensor, n_pages: int, n_layers: int):
        m = _nmesh()
        lead = valid.shape[:m]
        self.at = tuple(torch.where(valid, i, n - 1)
                        for i, n in zip(lead_index(lead, valid.ndim, valid.device), lead))
        self.idx = (torch.where(valid, idx[0], n_pages),
                    *(torch.where(valid, i, 0) for i in idx[1:]))
        layers = torch.arange(n_layers, device=valid.device).view(n_layers, *[1] * valid.ndim)
        self.layer = torch.where(valid, layers, n_layers - 1)     # one row a layer


def _with_sink(dst: torch.Tensor) -> torch.Tensor:
    """``dst`` ``(*mesh, L, n_pages, ...)`` seen with one more page, whose
    last is the write sink past the pool's end (see :class:`_Writes`)."""
    m = _nmesh()
    shape = list(dst.shape)
    shape[m + 1] += 1
    sink = sum((n - 1) * s for n, s in zip(shape[:m + 1], dst.stride()))
    sink += dst.shape[m + 1] * dst.stride(m + 1)
    end = sum((n - 1) * s for n, s in zip(dst.shape, dst.stride()))
    why = ("serve programs write into pools made by init_kv_cache, whose storage holds a "
           "write sink one page past the pool")
    if sink <= end:
        raise ValueError(why)
    try:
        return dst.as_strided(shape, dst.stride(), dst.storage_offset())
    except RuntimeError as e:   # no room past the pool's end
        raise ValueError(why) from e


def _put(dst: torch.Tensor, li: int, w: _Writes, vals: torch.Tensor) -> None:
    """``dst[rank, li, *idx] = vals`` where valid, in place, in one scatter
    as ``w`` planned it: dst ``(*mesh, L, n_pages, ...)`` a view of an
    ``init_kv_cache`` pool, vals ``(*mesh, *b, ...)``."""
    _with_sink(dst)[(*w.at, w.layer[li], *w.idx)] = vals.to(dst.dtype)


def _quant_write(pages_q, scales, li, write_page, write_off, new_vals, w: _Writes) -> None:
    """One quantized token write per slot, in place: insert ``new_vals``
    ``(*mesh, B, H, D)`` at (``write_page``, ``write_off``) of layer
    ``li``'s pool, requantizing each touched page from its dequantized view
    with entries beyond the write offset zeroed (freed-page leftovers and
    rejected draft tokens must not inflate a page's scale). Sentinel write
    pages gather a clipped page but write nothing (``w`` plans the page
    writes)."""
    m = _nmesh()
    n_pages, page_size = pages_q.shape[m + 1], pages_q.shape[m + 2]
    idx = torch.clamp(write_page, 0, n_pages - 1)
    at = (*lead_index(pages_q.shape[:m], idx.ndim, idx.device), li, idx)
    pg = dequantize_pages(pages_q[at], scales[at])                # (*mesh, B, page, H, D)
    offs = torch.arange(page_size, device=pg.device)[:, None, None]
    wo = write_off[..., None, None, None]
    pg = torch.where(offs == wo, new_vals.unsqueeze(-3),
                     torch.where(offs < wo, pg, torch.zeros((), device=pg.device)))
    q, s = quantize_pages(pg, pages_q.dtype)
    _put(pages_q, li, w, q)
    _put(scales, li, w, s)


def _layer(t, li: int):
    return None if t is None else t.select(_nmesh(), li)


def _take(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows ``perm`` ``(*mesh, T)`` of ``x`` ``(*mesh, T, d)`` per rank."""
    return torch.take_along_dim(x, perm[..., None], dim=-2)


def decode_step_fn(cfg: TransformerConfig, sp: str = "sp", dp: str = "dp",
                   quantized: bool = False, fused: bool | None = None):
    """The decode body: (params, kv, x, page_tables, write_page, write_off,
    seq_lens) -> out, the cache updated in place.

    Local shapes: x ``(B, d)`` each slot's current-token vector;
    page_tables ``(B, max_pages)`` local page ids; write_page/write_off
    ``(B,)`` where this token's K/V lands (``write_page >= n_pages`` for
    idle slots: no write); seq_lens ``(B,)`` cached length including this
    token (0 idles the slot). ``fused`` selects the attention kernel as in
    ``ops.attention.decode_attention``."""

    def step(params, kv, x, page_tables, write_page, write_off, seq_lens):
        kv_k, kv_v = kv["k"], kv["v"]
        k_scale, v_scale = kv.get("k_scale"), kv.get("v_scale")
        H, Dh = cfg.n_heads, cfg.d_head
        # idle slots must not compete for MoE capacity: a stable idle-last
        # permutation makes their zero vectors lose every capacity tie
        perm = torch.argsort((seq_lens == 0).to(torch.int32), dim=-1, stable=True)
        inv = torch.argsort(perm, dim=-1)
        n_pages = kv_k.shape[_nmesh() + 1]
        valid = write_page < n_pages
        w = _Writes((write_page,) if quantized else (write_page, write_off), valid, n_pages,
                    len(params["layers"]))
        for li, p in enumerate(params["layers"]):
            h = _rms_norm(x, _lead(p["ln1"], x.ndim))
            q = _head_slice(_mm(h, p["wq"]).unflatten(-1, (H, Dh)), sp)
            k = _head_slice(_mm(h, p["wk"]).unflatten(-1, (H, Dh)), sp)
            v = _head_slice(_mm(h, p["wv"]).unflatten(-1, (H, Dh)), sp)
            if quantized:
                _quant_write(kv_k, k_scale, li, write_page, write_off, k, w)
                _quant_write(kv_v, v_scale, li, write_page, write_off, v, w)
            else:
                _put(kv_k, li, w, k)
                _put(kv_v, li, w, v)
            attn = decode_attention(q, _layer(kv_k, li), _layer(kv_v, li), page_tables, seq_lens,
                                    _layer(k_scale, li), _layer(v_scale, li), fused=fused)
            x = _attn_residual(p, attn, x, cfg, sp)
            x = _take(_moe_residual(p, _take(x, perm), cfg, dp), inv)
        return x

    return step


def _program(mesh, body, in_specs, out_spec, counter):
    """The program ``(params, kv, *args) -> (out, kv)`` of a body that
    updates the cache in place."""
    prog = run_spmd(mesh, body, in_specs, out_spec)

    def run(params, kv, *args):
        return prog(params, kv, *args), kv

    return counter.wrap(run) if counter is not None else run


def build_decode_step(mesh: StackedMesh, cfg: TransformerConfig, geom: CacheGeometry,
                      dp: str = "dp", sp: str = "sp", counter: ProgramCounter | None = None,
                      quantized: bool = False, fused: bool | None = None):
    """The decode step over ``mesh``: fn(params, kv, x, page_tables,
    write_page, write_off, seq_lens) -> (out ``(B, d)``, kv) with slots
    split over ``dp`` and the cache updated in place. ``quantized``
    selects the int8/fp8 cache contract, ``fused`` the attention kernel."""
    check_serve_mesh(mesh, cfg, dp, sp)
    _check_geometry(cfg, geom)
    body = decode_step_fn(cfg, sp=sp, dp=dp, quantized=quantized, fused=fused)
    specs = (param_spec(cfg, dp), kv_cache_spec(dp, sp, quantized)) + (P(dp),) * 5
    return _program(mesh, body, specs, P(dp), counter)


def verify_step_fn(cfg: TransformerConfig, n_draft: int, sp: str = "sp", dp: str = "dp",
                   quantized: bool = False, fused: bool | None = None):
    """The K-token body (``K = n_draft + 1``): (params, kv, x, page_tables,
    write_pages, write_offs, seq_lens) -> out ``(B, K, d)``, the cache
    updated in place. x ``(B, K, d)``; write_pages/write_offs ``(B, K)``
    with the sentinel for idle slots and padding positions; seq_lens
    ``(B,)`` the cached length including position 0. All K positions'
    K/V are written before attention, so position j attends positions
    ``< seq_len + j``."""
    K = n_draft + 1

    def step(params, kv, x, page_tables, write_pages, write_offs, seq_lens):
        kv_k, kv_v = kv["k"], kv["v"]
        k_scale, v_scale = kv.get("k_scale"), kv.get("v_scale")
        H, Dh = cfg.n_heads, cfg.d_head
        lead, B = x.shape[:-3], x.shape[-3]
        n_pages = kv_k.shape[_nmesh() + 1]
        # token-level idle-last permutation: padding loses every MoE tie
        idle = (write_pages >= n_pages).reshape(*lead, B * K)
        perm = torch.argsort(idle.to(torch.int32), dim=-1, stable=True)
        inv = torch.argsort(perm, dim=-1)
        valid = write_pages < n_pages
        if quantized:   # a page write a position (planned once for every layer)
            ws = [_Writes((write_pages[..., j],), valid[..., j], n_pages, len(params["layers"]))
                  for j in range(K)]
        else:
            w = _Writes((write_pages, write_offs), valid, n_pages, len(params["layers"]))
        for li, p in enumerate(params["layers"]):
            h = _rms_norm(x, _lead(p["ln1"], x.ndim))
            q = _head_slice(_mm(h, p["wq"]).unflatten(-1, (H, Dh)), sp)
            k = _head_slice(_mm(h, p["wk"]).unflatten(-1, (H, Dh)), sp)
            v = _head_slice(_mm(h, p["wv"]).unflatten(-1, (H, Dh)), sp)
            if quantized:
                # one position at a time: adjacent positions can share a
                # page, and each requantizing write must see the last one
                for j in range(K):
                    _quant_write(kv_k, k_scale, li, write_pages[..., j], write_offs[..., j],
                                 k[..., j, :, :], ws[j])
                    _quant_write(kv_v, v_scale, li, write_pages[..., j], write_offs[..., j],
                                 v[..., j, :, :], ws[j])
            else:
                _put(kv_k, li, w, k)
                _put(kv_v, li, w, v)
            attn = verify_attention(q, _layer(kv_k, li), _layer(kv_v, li), page_tables, seq_lens,
                                    _layer(k_scale, li), _layer(v_scale, li), fused=fused)
            x = _attn_residual(p, attn, x, cfg, sp)
            flat = x.reshape(*lead, B * K, cfg.d_model)
            x = _take(_moe_residual(p, _take(flat, perm), cfg, dp), inv).reshape(
                *lead, B, K, cfg.d_model)
        return x

    return step


def _build_k_step(mesh, cfg, geom, n_draft, dp, sp, counter, quantized, fused):
    check_serve_mesh(mesh, cfg, dp, sp)
    _check_geometry(cfg, geom)
    body = verify_step_fn(cfg, n_draft, sp=sp, dp=dp, quantized=quantized, fused=fused)
    specs = (param_spec(cfg, dp), kv_cache_spec(dp, sp, quantized)) + (P(dp),) * 5
    return _program(mesh, body, specs, P(dp), counter)


def build_verify_step(mesh: StackedMesh, cfg: TransformerConfig, geom: CacheGeometry,
                      n_draft: int, dp: str = "dp", sp: str = "sp",
                      counter: ProgramCounter | None = None, quantized: bool = False,
                      fused: bool | None = None):
    """The speculative-verify step over ``mesh``: fn(params, kv, x ``(B,
    K, d)``, page_tables, write_pages ``(B, K)``, write_offs ``(B, K)``,
    seq_lens) -> (out ``(B, K, d)``, kv), ``K = n_draft + 1``."""
    if n_draft < 1:
        raise ValueError(f"n_draft must be >= 1, got {n_draft}")
    return _build_k_step(mesh, cfg, geom, n_draft, dp, sp, counter, quantized, fused)


def build_context_prefill(mesh: StackedMesh, cfg: TransformerConfig, geom: CacheGeometry,
                          chunk: int, dp: str = "dp", sp: str = "sp",
                          counter: ProgramCounter | None = None, quantized: bool = False,
                          fused: bool | None = None):
    """Context prefill over ``mesh``: up to ``chunk`` new prompt tokens per
    slot scored against the slot's cached prefix -- the verify program
    pointed at prefill (the same K-query shape), fn(params, kv, x ``(B,
    chunk, d)``, page_tables, write_pages, write_offs, seq_lens) -> (out
    ``(B, chunk, d)``, kv)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _build_k_step(mesh, cfg, geom, chunk - 1, dp, sp, counter, quantized, fused)


def _embed_rows(embed: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Rows ``toks`` ``(*mesh, ...)`` of the stacked ``(*mesh, V, d)`` table."""
    m = _nmesh()
    flat = toks.reshape(*toks.shape[:m], -1).long()
    rows = torch.take_along_dim(embed, flat[..., None], dim=-2)
    return rows.reshape(*toks.shape, embed.shape[-1])


def decode_loop_fn(cfg: TransformerConfig, geom: CacheGeometry, macro_steps: int,
                   temperature: float = 0.0, top_k: int = 0, sp: str = "sp", dp: str = "dp",
                   quantized: bool = False, fused: bool | None = None):
    """The macro-step body: ``macro_steps`` whole engine ticks (decode
    step, unembed, sample, K/V write, frontier advance) in one call,
    (params, kv, embed, key_data, tables, n_cached, rids, positions,
    budgets, last_tok, stop_mask, stopped, emitted) -> ((T, B) tokens,
    (T, B) active mask, n_cached, positions, last_tok, emitted, stopped),
    the cache updated in place.

    Local shapes as the JAX body's: tables ``(B, max_pages)`` each slot's
    full page list; n_cached ``(B,)`` (0 idles the slot); rids/positions
    the sampling chain, positions advanced in the carry; budgets the
    tokens a slot may still emit; stop_mask ``(B, V)`` bool; stopped and
    emitted passed in so a dispatch can continue another's carry. Each
    round is one engine tick: a slot is active while it is cached, has
    budget and has not emitted a stop token (the stop token is emitted,
    then the slot idles); an idle slot gets the zero vector, ``seq_len
    == 0`` and the write sentinel; the write target comes from the
    slot's own table row; keys are ``fold_in(fold_in(seed, rid),
    position)``. Every round runs (no early exit: see the module
    docstring)."""
    if macro_steps < 1:
        raise ValueError(f"macro_steps must be >= 1, got {macro_steps}")
    step = decode_step_fn(cfg, sp=sp, dp=dp, quantized=quantized, fused=fused)
    page_size, n_pages = geom.page_size, geom.n_pages

    def loop(params, kv, embed, key_data, tables, n_cached, rids, positions, budgets,
             last_tok, stop_mask, stopped, emitted):
        key = key_data.unsqueeze(-2)                     # (*mesh, 1, 2) against (*mesh, B)
        max_pages = tables.shape[-1]
        toks_out, mask_out = [], []
        for _ in range(macro_steps):
            active = (n_cached > 0) & (emitted < budgets) & ~stopped
            act_i = active.to(n_cached.dtype)
            x = torch.where(active[..., None], _embed_rows(embed, last_tok), 0.0)
            seq = torch.where(active, n_cached + 1, 0)
            pidx = torch.clamp(torch.div(n_cached, page_size, rounding_mode="floor"), 0,
                               max_pages - 1)
            wp = torch.where(active, torch.take_along_dim(tables, pidx[..., None].long(),
                                                          dim=-1)[..., 0], n_pages)
            woff = torch.where(active, n_cached % page_size, 0)
            out = step(params, kv, x, tables, wp, woff, seq)
            logits = _mm(out, embed.transpose(-1, -2))
            keys = request_keys(key, rids, positions) if temperature > 0 else None
            toks = sample_batch(keys, logits, temperature, top_k)
            toks = torch.where(active, toks, 0)
            hit = torch.take_along_dim(stop_mask, toks[..., None].long(), dim=-1)[..., 0]
            stopped = stopped | (active & hit)
            n_cached = n_cached + act_i
            positions = positions + act_i
            last_tok = torch.where(active, toks, last_tok)
            emitted = emitted + act_i
            toks_out.append(toks)
            mask_out.append(active)
        m = _nmesh()
        return (torch.stack(toks_out, dim=m), torch.stack(mask_out, dim=m), n_cached,
                positions, last_tok, emitted, stopped)

    return loop


def _loop_program(mesh, body, in_specs, out_specs, n_rounds: int, counter):
    """The program ``(params, kv, *args) -> (*per-round outputs, kv, *carry)``
    of a loop body that updates the cache in place and returns its
    ``n_rounds`` per-round outputs first (the JAX programs' output order)."""
    prog = run_spmd(mesh, body, in_specs, out_specs)

    def run(params, kv, *args):
        outs = prog(params, kv, *args)
        return (*outs[:n_rounds], kv, *outs[n_rounds:])

    return counter.wrap(run) if counter is not None else run


def build_decode_loop(mesh: StackedMesh, cfg: TransformerConfig, geom: CacheGeometry,
                      macro_steps: int, temperature: float = 0.0, top_k: int = 0,
                      dp: str = "dp", sp: str = "sp", counter: ProgramCounter | None = None,
                      quantized: bool = False, fused: bool | None = None):
    """The macro-step decode over ``mesh``: fn(params, kv, embed, key_data,
    tables ``(B, max_pages)``, n_cached, rids, positions, budgets, last_tok
    (``(B,)`` int32), stop_mask ``(B, V)`` bool, stopped ``(B,)`` bool,
    emitted ``(B,)`` int32) -> (tokens ``(T, B)``, active mask ``(T, B)``,
    kv, n_cached, positions, last_tok, emitted, stopped), slots split over
    ``dp``, the carry left on the device. One call, and one pull of its
    outputs, per ``macro_steps`` tokens. See :func:`decode_loop_fn`."""
    check_serve_mesh(mesh, cfg, dp, sp)
    _check_geometry(cfg, geom)
    body = decode_loop_fn(cfg, geom, macro_steps, temperature=temperature, top_k=top_k, sp=sp,
                          dp=dp, quantized=quantized, fused=fused)
    specs = (param_spec(cfg, dp), kv_cache_spec(dp, sp, quantized), P(), P()) + (P(dp),) * 9
    return _loop_program(mesh, body, specs, (P(None, dp),) * 2 + (P(dp),) * 5, 2, counter)


def macro_occupancy(mask) -> tuple[int, np.ndarray]:
    """A macro dispatch's ``(T, B)`` activity mask (the plain loop's
    active mask, or ``n_emit > 0`` under speculation) -> (rounds any slot
    ran, rounds each slot ran): per-slot masks are prefixes, so the
    longest column is the bank's round count."""
    m = np.asarray(mask, dtype=bool)
    return int(m.any(axis=1).sum()), m.sum(axis=0).astype(np.int64)


def propose_draft_batch(hist: torch.Tensor, ctx_len: torch.Tensor, k: int,
                        ngram: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`propose_draft` for a whole slot bank on the device: ``hist``
    ``(..., B, S)`` int32 each slot's prompt + generated tokens, zero past
    ``ctx_len`` ``(..., B)`` -> (drafts ``(..., B, k)`` int32, zero past each
    draft's length, draft_len ``(..., B)``). The largest matching start
    whose continuation is a full ``k`` tokens wins, else the largest
    matching start with its truncated continuation -- the host rule's
    descent. Windows read a ``-1``-padded history, which never equals a
    token."""
    if k < 1 or ngram < 1:
        raise ValueError(f"need k >= 1 and ngram >= 1, got {k}, {ngram}")
    S = hist.shape[-1]
    pad = torch.full((*hist.shape[:-1], ngram + k), -1, dtype=hist.dtype, device=hist.device)
    hist_pad = torch.cat([hist, pad], dim=-1)
    idx = torch.arange(S, device=hist.device)
    n = ctx_len[..., None].long()
    match = torch.ones(hist.shape, dtype=torch.bool, device=hist.device)
    for j in range(ngram):
        suffix_j = torch.take_along_dim(hist, torch.clamp(n - ngram + j, 0, S - 1), dim=-1)
        match = match & (hist_pad[..., j:j + S] == suffix_j)
    cand = match & (idx <= n - ngram - 1)
    full = cand & (idx <= n - ngram - k)
    i_part = torch.where(cand, idx, -1).amax(dim=-1)
    i_full = torch.where(full, idx, -1).amax(dim=-1)
    i0 = torch.where(i_full >= 0, i_full, i_part)
    ctx = ctx_len.long()
    dlen = torch.where(i_full >= 0, k, torch.where(i_part >= 0, ctx - i_part - ngram, 0))
    dlen = torch.where((ctx >= ngram + 1) & (i0 >= 0), dlen, 0)
    jk = torch.arange(k, device=hist.device)
    gat = i0[..., None] + ngram + jk
    drafts = torch.take_along_dim(hist_pad, torch.clamp(gat, 0, S + ngram + k - 1), dim=-1)
    drafts = torch.where(jk < dlen[..., None], drafts, 0)
    return drafts.to(torch.int32), dlen.to(torch.int32)


def spec_decode_loop_fn(cfg: TransformerConfig, geom: CacheGeometry, macro_steps: int,
                        spec_k: int, temperature: float = 0.0, top_k: int = 0, ngram: int = 2,
                        sp: str = "sp", dp: str = "dp", quantized: bool = False,
                        fused: bool | None = None):
    """The speculative macro-step body: T whole speculation rounds (draft
    proposal from the device-resident history, the K-token verify step,
    the accept rule, frontier and history advance) in one call,
    (params, kv, embed, key_data, tables, n_cached, rids, positions,
    budgets, last_tok, hist, stop_mask, stopped) -> ((T, B, K) tokens,
    (T, B) n_emit, (T, B) draft_len), the cache updated in place, ``K =
    spec_k + 1``. Each round is one ``_spec_sweep`` tick of the engine:
    the draft clamped to the remaining budget less one; beyond-draft
    positions get zero vectors and the write sentinel; accept draws key
    off the host rule's chains at ``position0 = positions``; a stop token
    in the emitted run truncates it there and idles the slot. Every round
    runs (no early exit)."""
    if macro_steps < 1:
        raise ValueError(f"macro_steps must be >= 1, got {macro_steps}")
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    K = spec_k + 1
    step = verify_step_fn(cfg, spec_k, sp=sp, dp=dp, quantized=quantized, fused=fused)
    page_size, n_pages = geom.page_size, geom.n_pages

    def loop(params, kv, embed, key_data, tables, n_cached, rids, positions, budgets,
             last_tok, hist, stop_mask, stopped):
        key = key_data.unsqueeze(-2)
        S = hist.shape[-1]
        max_pages = tables.shape[-1]
        dev = tables.device
        jpos = torch.arange(K, device=dev)
        jk = torch.arange(spec_k, device=dev)
        emitted = torch.zeros_like(budgets)
        toks_out, emit_out, dlen_out = [], [], []
        for _ in range(macro_steps):
            active = (n_cached > 0) & (emitted < budgets) & ~stopped
            ctx_len = n_cached + 1
            drafts, dlen = propose_draft_batch(hist, ctx_len, spec_k, ngram)
            # the sweep emits n_acc + 1 <= dlen + 1 tokens: never past the budget
            dlen = torch.minimum(dlen, budgets - emitted - 1)
            dlen = torch.where(active, torch.clamp_min(dlen, 0), 0)
            drafts = torch.where(jk < dlen[..., None], drafts, 0)
            toks_in = torch.cat([last_tok[..., None], drafts], dim=-1)
            live = active[..., None] & (jpos <= dlen[..., None])
            x = torch.where(live[..., None], _embed_rows(embed, toks_in), 0.0)
            wpos = n_cached[..., None] + jpos
            pidx = torch.clamp(torch.div(wpos, page_size, rounding_mode="floor"), 0,
                               max_pages - 1)
            wp = torch.where(live, torch.take_along_dim(tables, pidx.long(), dim=-1), n_pages)
            woff = torch.where(live, wpos % page_size, 0)
            seq = torch.where(active, n_cached + 1, 0)
            out = step(params, kv, x, tables, wp, woff, seq)
            logits = _mm(out, embed.transpose(-1, -2))
            n_acc, term = accept_batch(key, rids, positions, logits, drafts, dlen,
                                       temperature=temperature, top_k=top_k)
            n_acc = torch.where(active, n_acc, 0)
            term = torch.where(active, term, 0)
            drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[..., :1])], dim=-1)
            na = n_acc[..., None]
            toks_k = torch.where(jpos < na, drafts_pad, torch.where(jpos == na, term[..., None], 0))
            toks_k = torch.where(active[..., None], toks_k, 0)
            n_emit = torch.where(active, n_acc + 1, 0)
            # a stop token truncates the emitted run (the stop token is kept)
            is_stop = (torch.take_along_dim(stop_mask, toks_k.long(), dim=-1)
                       & (jpos < n_emit[..., None]))
            has_stop = is_stop.any(dim=-1)
            j_stop = torch.argmax(is_stop.to(torch.int8), dim=-1)
            n_emit = torch.where(has_stop, j_stop.to(n_emit.dtype) + 1, n_emit)
            toks_k = torch.where(jpos < n_emit[..., None], toks_k, 0)
            stopped = stopped | (active & has_stop)
            # extend the proposer's history window (dropped writes land in a
            # spare column that is cut off again)
            wpos_h = torch.where(jpos < n_emit[..., None], ctx_len[..., None] + jpos, S)
            hist = torch.cat([hist, torch.zeros_like(hist[..., :1])], dim=-1).scatter(
                -1, torch.clamp(wpos_h, 0, S).long(), toks_k)[..., :S]
            last_idx = torch.clamp(n_emit - 1, 0, K - 1)
            new_last = torch.take_along_dim(toks_k, last_idx[..., None].long(), dim=-1)[..., 0]
            last_tok = torch.where(active, new_last, last_tok)
            n_cached = n_cached + n_emit
            positions = positions + n_emit
            emitted = emitted + n_emit
            toks_out.append(toks_k)
            emit_out.append(n_emit)
            dlen_out.append(dlen)
        m = _nmesh()
        return (torch.stack(toks_out, dim=m), torch.stack(emit_out, dim=m),
                torch.stack(dlen_out, dim=m))

    return loop


def build_spec_decode_loop(mesh: StackedMesh, cfg: TransformerConfig, geom: CacheGeometry,
                           macro_steps: int, spec_k: int, temperature: float = 0.0,
                           top_k: int = 0, ngram: int = 2, dp: str = "dp", sp: str = "sp",
                           counter: ProgramCounter | None = None, quantized: bool = False,
                           fused: bool | None = None):
    """The speculative macro-step decode over ``mesh``: fn(params, kv,
    embed, key_data, tables, n_cached, rids, positions, budgets, last_tok,
    hist ``(B, S)`` int32, stop_mask ``(B, V)`` bool, stopped ``(B,)``
    bool) -> (tokens ``(T, B, K)``, n_emit ``(T, B)``, draft_len ``(T,
    B)``, kv). One call, and one pull, per T speculation rounds (up to
    ``T * (spec_k + 1)`` tokens a slot). See :func:`spec_decode_loop_fn`."""
    check_serve_mesh(mesh, cfg, dp, sp)
    _check_geometry(cfg, geom)
    body = spec_decode_loop_fn(cfg, geom, macro_steps, spec_k, temperature=temperature,
                               top_k=top_k, ngram=ngram, sp=sp, dp=dp, quantized=quantized,
                               fused=fused)
    specs = (param_spec(cfg, dp), kv_cache_spec(dp, sp, quantized), P(), P()) + (P(dp),) * 9
    return _loop_program(mesh, body, specs, (P(None, dp),) * 3, 3, counter)


def prefill_fn(cfg: TransformerConfig, geom: CacheGeometry, sp: str = "sp", dp: str = "dp",
               quantized: bool = False):
    """The prefill body: (params, kv, x, pages, n_tok) -> out, the cache
    updated in place. One sequence per call: x ``(S_bucket, d)`` the prompt
    padded to its bucket, replicated over both axes; pages ``(1,
    max_pages)`` this dp group's row of the page table (the sentinel on
    every group but the owner, so only the owner writes); ``n_tok`` the
    true prompt length (a host int). Quantized pools get whole pages:
    positions at or past ``n_tok`` are zeroed before the per-page absmax,
    and only pages holding a prompt token are written."""

    def run(params, kv, x, pages, n_tok: int):
        kv_k, kv_v = kv["k"], kv["v"]
        k_scale, v_scale = kv.get("k_scale"), kv.get("v_scale")
        H, Dh = cfg.n_heads, cfg.d_head
        page, n_pages = geom.page_size, geom.n_pages
        S = x.shape[-2]
        dev = x.device
        pages = pages[..., 0, :]                                    # (*mesh, max_pages)
        lead, max_pages = pages.shape[:-1], pages.shape[-1]
        pos = torch.arange(S, device=dev)
        page_of = torch.take_along_dim(
            pages, torch.clamp(pos // page, 0, max_pages - 1).expand(*lead, S), dim=-1)
        pg = torch.where(pos < n_tok, page_of, n_pages)             # padding writes nowhere
        off = (pos % page).expand(*lead, S)
        if quantized:
            pad = -S % page
            n_pg = (S + pad) // page
            pg_idx = torch.arange(n_pg, device=dev)
            pg_ids = torch.take_along_dim(
                pages, torch.clamp(pg_idx, 0, max_pages - 1).expand(*lead, n_pg), dim=-1)
            pg_write = torch.where(pg_idx * page < n_tok, pg_ids, n_pages)
            tok_live = (pos < n_tok)[:, None, None]

            def quant_pages(vals):
                live = torch.where(tok_live, vals, torch.zeros((), device=dev))
                live = torch.nn.functional.pad(live, (0, 0, 0, 0, 0, pad))
                return quantize_pages(live.reshape(*lead, n_pg, page, *vals.shape[-2:]),
                                      kv_k.dtype)
        # causal x true-length mask: padded keys never attend
        mask = (pos[:, None] >= pos[None, :]) & (pos[None, :] < n_tok)
        w = (_Writes((pg_write,), pg_write < n_pages, n_pages, len(params["layers"]))
             if quantized else _Writes((pg, off), pg < n_pages, n_pages, len(params["layers"])))
        for li, p in enumerate(params["layers"]):
            h = _rms_norm(x, _lead(p["ln1"], x.ndim))
            q = _head_slice(_mm(h, p["wq"]).unflatten(-1, (H, Dh)), sp)
            k = _head_slice(_mm(h, p["wk"]).unflatten(-1, (H, Dh)), sp)
            v = _head_slice(_mm(h, p["wv"]).unflatten(-1, (H, Dh)), sp)
            if quantized:
                qk, sk = quant_pages(k)
                qv, sv = quant_pages(v)
                _put(kv_k, li, w, qk)
                _put(kv_v, li, w, qv)
                _put(k_scale, li, w, sk)
                _put(v_scale, li, w, sv)
            else:
                _put(kv_k, li, w, k)
                _put(kv_v, li, w, v)
            s = masked_scores(q, k, mask)                           # (*mesh, H_loc, S, S)
            pr = masked_softmax(s, mask)
            attn = torch.einsum("...hst,...thd->...shd", pr, v.float())
            x = _attn_residual(p, attn.to(x.dtype), x, cfg, sp)
            x = _moe_residual(p, x, cfg, dp)
        return x

    return run


def build_prefill(mesh: StackedMesh, cfg: TransformerConfig, geom: CacheGeometry,
                  dp: str = "dp", sp: str = "sp", counter: ProgramCounter | None = None,
                  quantized: bool = False):
    """Prefill over ``mesh``: fn(params, kv, x, pages, n_tok) -> (out ``(S,
    d)``, kv), the cache updated in place. The engine builds one per
    prompt bucket. Prompt compute stays f32 for every kv dtype (prefill
    attends the just-projected values, not the cache)."""
    check_serve_mesh(mesh, cfg, dp, sp)
    _check_geometry(cfg, geom)
    body = prefill_fn(cfg, geom, sp=sp, dp=dp, quantized=quantized)
    specs = (param_spec(cfg, dp), kv_cache_spec(dp, sp, quantized), P(), P(dp))

    def run(params, kv, x, pages, n_tok):
        n = int(n_tok)
        prog = run_spmd(mesh, lambda *a: body(*a, n), specs, P())
        return prog(params, kv, x, pages), kv

    return counter.wrap(run) if counter is not None else run
