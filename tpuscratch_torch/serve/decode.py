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
prefill bucket, one decode program). The macro-step and speculative loops
wait for the speculation slice of the port.
"""

from __future__ import annotations

from typing import Sequence

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


def _put(dst: torch.Tensor, li: int, idx: tuple, vals: torch.Tensor,
         valid: torch.Tensor) -> None:
    """``dst[rank, li, *idx] = vals`` where ``valid`` (in place): dst
    ``(*mesh, L, ...)``, idx tensors and valid ``(*mesh, *b)``, vals
    ``(*mesh, *b, ...)`` -- the JAX ``.at[li, *idx].set(vals,
    mode="drop")`` with invalid entries dropped."""
    c = valid.nonzero(as_tuple=True)
    m = _nmesh()
    dst[(*c[:m], li, *(i[c] for i in idx))] = vals[c].to(dst.dtype)


def _quant_write(pages_q, scales, li, write_page, write_off, new_vals) -> None:
    """One quantized token write per slot, in place: insert ``new_vals``
    ``(*mesh, B, H, D)`` at (``write_page``, ``write_off``) of layer
    ``li``'s pool, requantizing each touched page from its dequantized view
    with entries beyond the write offset zeroed (freed-page leftovers and
    rejected draft tokens must not inflate a page's scale). Sentinel write
    pages gather a clipped page but write nothing."""
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
    valid = write_page < n_pages
    _put(pages_q, li, (write_page,), q, valid)
    _put(scales, li, (write_page,), s, valid)


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
        for li, p in enumerate(params["layers"]):
            h = _rms_norm(x, _lead(p["ln1"], x.ndim))
            q = _head_slice(_mm(h, p["wq"]).unflatten(-1, (H, Dh)), sp)
            k = _head_slice(_mm(h, p["wk"]).unflatten(-1, (H, Dh)), sp)
            v = _head_slice(_mm(h, p["wv"]).unflatten(-1, (H, Dh)), sp)
            if quantized:
                _quant_write(kv_k, k_scale, li, write_page, write_off, k)
                _quant_write(kv_v, v_scale, li, write_page, write_off, v)
            else:
                valid = write_page < kv_k.shape[_nmesh() + 1]
                _put(kv_k, li, (write_page, write_off), k, valid)
                _put(kv_v, li, (write_page, write_off), v, valid)
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
                                 k[..., j, :, :])
                    _quant_write(kv_v, v_scale, li, write_pages[..., j], write_offs[..., j],
                                 v[..., j, :, :])
            else:
                valid = write_pages < n_pages
                _put(kv_k, li, (write_pages, write_offs), k, valid)
                _put(kv_v, li, (write_pages, write_offs), v, valid)
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
        for li, p in enumerate(params["layers"]):
            h = _rms_norm(x, _lead(p["ln1"], x.ndim))
            q = _head_slice(_mm(h, p["wq"]).unflatten(-1, (H, Dh)), sp)
            k = _head_slice(_mm(h, p["wk"]).unflatten(-1, (H, Dh)), sp)
            v = _head_slice(_mm(h, p["wv"]).unflatten(-1, (H, Dh)), sp)
            if quantized:
                qk, sk = quant_pages(k)
                qv, sv = quant_pages(v)
                valid = pg_write < n_pages
                _put(kv_k, li, (pg_write,), qk, valid)
                _put(kv_v, li, (pg_write,), qv, valid)
                _put(k_scale, li, (pg_write,), sk, valid)
                _put(v_scale, li, (pg_write,), sv, valid)
            else:
                valid = pg < n_pages
                _put(kv_k, li, (pg, off), k, valid)
                _put(kv_v, li, (pg, off), v, valid)
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
