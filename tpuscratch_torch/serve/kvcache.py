"""Block-paged KV cache: preallocated page pools + a free-list allocator.

The twin of ``tpuscratch.serve.kvcache`` (its default-path part). K and V
live in preallocated ``(n_layers, dp * n_pages, page_size, n_heads,
d_head)`` tensors, and a sequence's cache is a list of page ids, so
mixed-length sequences pack the pool densely and admission control is one
integer comparison against the free list. Pages split over the "dp" mesh
axis (each data-parallel group owns ``n_pages`` of them, ids local to the
group) and heads over "sp", as in the JAX package (``kv_cache_spec``).

Quantized pages (the fp32 / int8 / fp8 ladder) store one byte per element
with per-page per-head fp32 scales (``k_scale``/``v_scale``, shape
``(n_layers, dp * n_pages, n_heads)``), symmetric absmax scaling
``value = q * scale``: int8 targets 127 on a rounded grid, fp8 e4m3
targets 448 with a round-to-nearest cast. ``quantize_pages`` is bit-equal
to the JAX package's (the same f32 divide, clip-then-cast, and
ties-to-even rounding).

The allocator and the prefix index (``PrefixCache``) are host-side
Python: page grant/release and prefix matching happen between device
steps, and the device steps only ever see page tables.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch

from tpuscratch_torch.comm.spmd import P
from tpuscratch_torch.obs.ledger import kv_cache_bytes  # noqa: F401  (re-exported)
from tpuscratch_torch.runtime.mesh import resolve_device

#: symmetric int8 range: q in [-127, 127], value = q * scale
INT8_QMAX = 127.0
#: fp8 e4m3fn finite max (the "fn" variant has no inf)
FP8_QMAX = 448.0

#: the quantized rungs of the KV dtype ladder and their absmax targets
QUANT_KV_DTYPES = {torch.int8: INT8_QMAX, torch.float8_e4m3fn: FP8_QMAX}

#: absmax floor: an all-zero page quantizes with this scale
_SCALE_FLOOR = 1e-30


def is_quantized_kv_dtype(dtype) -> bool:
    """True for the 1-byte-per-element rungs that carry scale planes."""
    return dtype in QUANT_KV_DTYPES


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Static shape of one data-parallel group's page pool."""

    n_layers: int
    n_pages: int          # pages per dp group
    page_size: int        # tokens per page
    n_heads: int          # GLOBAL head count (split over sp)
    d_head: int

    def __post_init__(self):
        for name in ("n_layers", "n_pages", "page_size", "n_heads", "d_head"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")

    @property
    def max_tokens(self) -> int:
        """Token capacity of one group's pool."""
        return self.n_pages * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens``."""
        return -(-n_tokens // self.page_size)


def _pool(shape: tuple, dtype, device) -> torch.Tensor:
    """A zeroed ``(n_layers, pages, ...)`` pool whose storage runs one page
    past its end: the write sink that the serve programs send dropped
    writes to (``serve.decode._Writes``), outside the pool's view and
    never read."""
    n = math.prod(shape)
    return torch.zeros(n + math.prod(shape[2:]), dtype=dtype, device=device)[:n].view(shape)


def init_kv_cache(geom: CacheGeometry, dp_size: int = 1, dtype=torch.float32,
                  device=None) -> dict:
    """The global cache: ``{"k", "v"}`` of shape ``(n_layers, dp_size *
    n_pages, page_size, n_heads, d_head)``, zeroed on ``device`` (the card
    unless another device is named), plus
    ``{"k_scale", "v_scale"}`` ``(n_layers, dp_size * n_pages, n_heads)``
    f32 planes for a quantized ``dtype``. Each pool's storage holds one
    more page past its end, the serve programs' write sink."""
    if dtype != torch.float32 and not is_quantized_kv_dtype(dtype):
        raise ValueError(
            f"kv cache dtype {dtype} not in the ladder (float32, int8, float8_e4m3fn)")
    device = resolve_device(device)
    shape = (geom.n_layers, dp_size * geom.n_pages, geom.page_size, geom.n_heads, geom.d_head)
    cache = {"k": _pool(shape, dtype, device), "v": _pool(shape, dtype, device)}
    if is_quantized_kv_dtype(dtype):
        cache["k_scale"] = _pool(shape[:2] + (geom.n_heads,), torch.float32, device)
        cache["v_scale"] = _pool(shape[:2] + (geom.n_heads,), torch.float32, device)
    return cache


def kv_cache_spec(dp: str = "dp", sp: str = "sp", quantized: bool = False) -> dict:
    """PartitionSpec tree for :func:`init_kv_cache`'s output."""
    s = P(None, dp, None, sp, None)
    out = {"k": s, "v": s}
    if quantized:
        out["k_scale"] = P(None, dp, sp)
        out["v_scale"] = P(None, dp, sp)
    return out


def quantize_pages(x: torch.Tensor, dtype=torch.int8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization of page-shaped f32 values ``(...,
    page_size, n_heads, d_head)`` onto a quantized rung: ``(q in dtype,
    scale (..., n_heads) f32)``, one scale per page per head. The clip
    keeps division slop at the amax entry from rounding past the rung's
    range before the cast."""
    if dtype not in QUANT_KV_DTYPES:
        raise ValueError(f"quantize_pages dtype {dtype} not a quantized rung (int8, float8_e4m3fn)")
    qmax = QUANT_KV_DTYPES[dtype]
    amax = x.abs().amax(dim=(-3, -1))
    scale = torch.clamp_min(amax, _SCALE_FLOOR) / qmax
    y = x / scale[..., None, :, None]
    if dtype == torch.int8:
        y = torch.round(y)  # ties to even, as jnp.round
    return torch.clamp(y, -qmax, qmax).to(dtype), scale


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: int8/fp8 pages x ``(...,
    n_heads)`` scales -> f32 values."""
    return q.to(torch.float32) * scale[..., None, :, None]


class PageAllocator:
    """LIFO free list over one group's ``n_pages`` page ids, with
    per-page refcounts (a copy of the JAX package's class).

    - every id handed out is in ``[0, n_pages)`` and unique among live ids;
    - :meth:`alloc` is all-or-nothing (None, granting nothing, when short);
    - :meth:`share` adds a holder to a live page; :meth:`free` drops one,
      and a page returns to the free list when its last holder frees it;
    - freeing or sharing an id that is not live raises.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))  # pop() hands out 0 first
        self._refs: dict[int, int] = {}                # live page -> holders

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Unique live pages (a page shared k ways counts once)."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int = 1) -> Optional[list[int]]:
        """Grant ``n`` pages at refcount 1, or None if fewer are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: Iterable[int]) -> None:
        """Add one holder to each live page."""
        pages = list(pages)
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not live (cannot share a freed page; "
                                 f"{len(self._refs)} live of {self.n_pages})")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Iterable[int]) -> list[int]:
        """Drop one holder per page; returns the pages whose last holder
        left (now back on the free list)."""
        released = []
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not live (double free or foreign id; "
                                 f"{len(self._refs)} live of {self.n_pages})")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                released.append(p)
        return released


class PrefixCache:
    """Token-block trie over one group's LIVE pages (a copy of the JAX
    package's class): full-page-aligned prompt prefixes -> the page id
    holding that block's K/V.

    The cross-request sharing index (PagedAttention prefix caching):
    a key is the WHOLE token prefix up to a page boundary (tuple of
    ``i * page_size`` token ids), so two prompts match a page only when
    everything before it is identical too — the residual stream at a
    position depends on the entire prefix, so K/V values are reusable
    exactly when the full prefix matches (this model has no positional
    encoding beyond the causal mask, and cached projections depend only
    on the prefix).

    Entries index pages whose holders are tracked by
    :class:`PageAllocator` refcounts — the trie itself holds NO
    reference: a mapping dies with its page (``drop`` on the
    allocator's released list), so only pages some live request still
    holds are ever matched, and the watermark law keeps counting unique
    live pages.  A key tracks ALTERNATE physical copies: two identical
    prompts prefilled in the same tick each register their own pages
    (neither could share — sharing needs a COMPLETED prefill), matches
    land on the oldest live copy, and when that copy's owner dies the
    next alternate takes over instead of the whole chain vanishing
    while an equivalent live copy exists.

    **Sub-page (token-granular) continuations**: beside the full-block
    map, every registered block — full or partial-tail — is ALSO indexed
    as a continuation of the aligned prefix BEFORE it: key
    ``prompt[:b * page_size]`` -> list of
    ``(block_tokens, page)``.  :meth:`match_tail` then extends an
    aligned match past its last page boundary: the longest common
    prefix between a registered block's tokens and the request's
    remaining prompt names how many tokens of that donor page are
    valid K/V for the request (K/V at position ``j`` depends only on
    tokens ``[0, j]``, which agree by construction).  The engine
    copy-on-writes the donor page into the admission's own boundary
    page at the token frontier, so affinity/sharing wins are no longer
    quantized to ``page_size``.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._map: dict[tuple, list[int]] = {}  # prefix -> live copies
        self._rev: dict[int, set[tuple]] = {}   # page id -> its keys
        # sub-page continuation index: aligned key -> [(block, page)]
        self._tails: dict[tuple, list[tuple[tuple, int]]] = {}
        self._rev_tails: dict[int, set[tuple]] = {}  # page -> tail keys

    @property
    def n_blocks(self) -> int:
        return len(self._map)

    def match(self, prompt: Iterable[int],
              prefer: Optional[Callable[[int], bool]] = None) -> list[int]:
        """Page ids of the LONGEST cached full-page-aligned prefix of
        ``prompt`` (possibly empty).  The chain walks block by block, so
        a match is always a contiguous prefix.

        ``prefer`` biases alternate selection: when given, the first
        alternate satisfying it wins, falling back to the oldest copy —
        the tiered engine passes "is live" so a chain with both a live
        holder and a host-parked copy attaches to the live one (sharing
        a live page is free; restoring a parked one pays an H2D copy)."""
        prompt = tuple(prompt)
        pages = []
        for i in range(self.page_size, len(prompt) + 1, self.page_size):
            alts = self._map.get(prompt[:i])
            if not alts:
                break
            if prefer is None:
                pages.append(alts[0])
            else:
                pages.append(next((p for p in alts if prefer(p)), alts[0]))
        return pages

    def insert(self, prompt: Iterable[int], pages: Iterable[int]) -> None:
        """Register ``prompt``'s full-page blocks against the pages that
        hold them (``pages`` in sequence order, one per full block, plus
        the partial-tail page when the prompt ends mid-page; further
        entries ignored).  A key that already indexes other copies gains
        an alternate; matches keep landing on the oldest.  Every block —
        the partial tail included — is also registered as a sub-page
        CONTINUATION of the aligned prefix before it (see
        :meth:`match_tail`)."""
        prompt, pages = tuple(prompt), list(pages)
        ps = self.page_size
        for blk, page in zip(range(len(prompt) // ps), pages):
            key = prompt[: (blk + 1) * ps]
            alts = self._map.setdefault(key, [])
            if page not in alts:
                alts.append(page)
                self._rev.setdefault(page, set()).add(key)
            self._insert_tail(prompt[: blk * ps], key[blk * ps:], page)
        nb, rem = divmod(len(prompt), ps)
        if rem and nb < len(pages):
            # the partial last block: matchable only token-granularly
            self._insert_tail(prompt[: nb * ps], prompt[nb * ps:],
                              pages[nb])

    def _insert_tail(self, key: tuple, block: tuple, page: int) -> None:
        alts = self._tails.setdefault(key, [])
        if (block, page) not in alts:
            alts.append((block, page))
            self._rev_tails.setdefault(page, set()).add(key)

    def match_tail(self, prompt: Iterable[int], matched_pages: int,
                   prefer: Optional[Callable[[int], bool]] = None,
                   ) -> tuple[Optional[int], int]:
        """``(page, n_tokens)`` of the best sub-page continuation past
        an aligned match of ``matched_pages`` full pages: the donor
        page whose registered block shares the longest (>= 1) token
        prefix with the prompt's remainder.  ``prefer`` filters donors
        (the engine passes "is live" — a sub-page donor is COPIED, not
        refcounted, so it must be readable right now); ``(None, 0)``
        when nothing continues the match."""
        prompt = tuple(prompt)
        key = prompt[: matched_pages * self.page_size]
        rest = prompt[matched_pages * self.page_size:]
        best_page, best_n = None, 0
        for block, page in self._tails.get(key, ()):
            if prefer is not None and not prefer(page):
                continue
            n = 0
            for a, b in zip(block, rest):
                if a != b:
                    break
                n += 1
            if n > best_n:
                best_page, best_n = page, n
        return best_page, best_n

    def registered(self, page: int) -> bool:
        """True when ``page`` indexes at least one prefix block — the
        tiered engine's park predicate: only trie-registered pages are
        worth retaining in the host tier after their last holder."""
        return page in self._rev

    def drop(self, pages: Iterable[int]) -> None:
        """Forget every mapping onto ``pages`` — called with the
        allocator's released list, so dead pages cannot be matched;
        keys with surviving alternate copies stay matchable.  Sub-page
        continuation entries die with their page the same way."""
        for p in pages:
            for key in self._rev.pop(p, ()):
                alts = self._map.get(key)
                if alts is None:
                    continue
                if p in alts:
                    alts.remove(p)
                if not alts:
                    del self._map[key]
            for key in self._rev_tails.pop(p, ()):
                alts = self._tails.get(key)
                if alts is None:
                    continue
                alts[:] = [bp for bp in alts if bp[1] != p]
                if not alts:
                    del self._tails[key]

    def clear(self) -> None:
        """Forget everything — the engine's cache-recovery path (a reset
        pool holds no valid K/V, so no prefix may be matched)."""
        self._map.clear()
        self._rev.clear()
        self._tails.clear()
        self._rev_tails.clear()
