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

The allocator is host-side Python: page grant/release happens between
device steps, and the device steps only ever see page tables.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

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


def init_kv_cache(geom: CacheGeometry, dp_size: int = 1, dtype=torch.float32,
                  device=None) -> dict:
    """The global cache: ``{"k", "v"}`` of shape ``(n_layers, dp_size *
    n_pages, page_size, n_heads, d_head)``, zeroed on ``device`` (the card
    unless another device is named), plus
    ``{"k_scale", "v_scale"}`` ``(n_layers, dp_size * n_pages, n_heads)``
    f32 planes for a quantized ``dtype``."""
    if dtype != torch.float32 and not is_quantized_kv_dtype(dtype):
        raise ValueError(
            f"kv cache dtype {dtype} not in the ladder (float32, int8, float8_e4m3fn)")
    device = resolve_device(device)
    shape = (geom.n_layers, dp_size * geom.n_pages, geom.page_size, geom.n_heads, geom.d_head)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if is_quantized_kv_dtype(dtype):
        cache["k_scale"] = torch.zeros(shape[:2] + (geom.n_heads,), device=device)
        cache["v_scale"] = torch.zeros(shape[:2] + (geom.n_heads,), device=device)
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
