"""Cached decode attention over the paged KV pool (``csrc/paged_attention.cu``).

The twin of the cached-attention part of ``tpuscratch.ops.attention``
(:1129-1640): decode (one query per sequence), speculative verify and
chunked context prefill (K queries per sequence) against a block-paged
pool, with ragged ``seq_lens``, sentinel table entries, idle slots and
int8/fp8 pages dequantized through per-page per-head scale planes.

- ``paged_attention``: the wrapper of the hand-written CUDA kernel (the
  port of the Pallas ``paged_attention``); on a CPU tensor it runs the
  plain version.
- ``_verify_attention_dense``: the plain version (the JAX package's dense
  oracle): gather, scale-folded contractions, masked softmax.
- ``decode_attention`` / ``verify_attention``: the entry points. ``fused``
  None routes by device (a CUDA tensor launches the kernel, a CPU tensor
  takes the plain version), True demands the kernel (and raises on the
  CPU, where there is none), False forces the plain version on either
  device (the JAX ``"off"`` mode, the oracle on the card).

Every operand may carry leading dims (the stacked mesh's ranks): rank r's
queries attend rank r's pool. The kernel takes any ``d_head <= 256`` and
``K <= 64`` and raises beyond them; the TPU's layout rules (``D % 128``,
``H % 8``, ``page_size % 8``, the VMEM head-block budget) do not apply.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from tpuscratch_torch.comm.spmd import lead_index
from tpuscratch_torch.ops.common import check_status, counters, library, route, stream_of
from tpuscratch_torch.parallel.scores import NEG_INF, masked_softmax

#: the kernel's limits: q's K x D rows and the f32 accumulator live in one
#: block's shared memory
MAX_D = 256
MAX_K = 64
#: pool dtype -> the kernel's dtype code (``csrc/paged_attention.cu``)
POOL_DTYPES = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def _gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each sequence's contiguous cache view in the pool dtype: pages
    ``(*lead, P, page, H, D)`` gathered by a clipped ``(*lead, B,
    max_pages)`` table into ``(*lead, B, T, H, D)``."""
    lead = tuple(table.shape[:-2])
    B, max_pages = table.shape[-2:]
    page_size, H, D = pages.shape[-3:]
    g = pages[(*lead_index(lead, table.ndim, table.device), table)]
    return g.reshape(*lead, B, max_pages * page_size, H, D)


def _position_scale(page_scale: torch.Tensor, table: torch.Tensor, page_size: int) -> torch.Tensor:
    """Per-position dequantization plane ``(*lead, B, T, H)`` from the
    per-page ``(*lead, P, H)`` scale plane."""
    lead = tuple(table.shape[:-2])
    s = page_scale[(*lead_index(lead, table.ndim, table.device), table)]  # (*lead, B, max_pages, H)
    return torch.repeat_interleave(s, page_size, dim=-2)


def _check_decode_operands(q, k_pages, v_pages, page_table, seq_lens) -> None:
    lead = tuple(page_table.shape[:-2])
    n = len(lead)
    if k_pages.ndim != n + 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad decode shapes q={tuple(q.shape)} k={tuple(k_pages.shape)} "
                         f"v={tuple(v_pages.shape)}")
    B, H, D = q.shape[n], q.shape[-2], q.shape[-1]
    Hp, Dp = k_pages.shape[-2:]
    if ((Hp, Dp) != (H, D) or page_table.shape[n] != B or tuple(seq_lens.shape) != lead + (B,)
            or tuple(q.shape[:n]) != lead or tuple(k_pages.shape[:n]) != lead):
        raise ValueError(f"mismatched decode operands: q={tuple(q.shape)} "
                         f"pages={tuple(k_pages.shape)} table={tuple(page_table.shape)} "
                         f"lens={tuple(seq_lens.shape)}")


def paged_attention_supported(H: int, D: int, page_size: int, kv_dtype) -> str | None:
    """None when the CUDA kernel takes this geometry, else why not."""
    del H, page_size  # any head count and page size
    if D > MAX_D:
        return f"d_head {D} above the kernel's limit of {MAX_D}"
    if kv_dtype not in POOL_DTYPES:
        return f"pool dtype {kv_dtype} not in the ladder (float32, int8, float8_e4m3fn)"
    return None


def _verify_attention_dense(q, k_pages, v_pages, page_table, seq_lens, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """The plain version of the paged kernel: q ``(*lead, B, K, H, D)``
    against the pool, one gather for the K queries; quantization scales
    fold into the score and output contractions, and the clip before the
    gather lands sentinel table entries on page 0, whose scores the length
    mask removes. Query ``kq`` attends cache positions ``< seq_len + kq``;
    an idle slot (``seq_len == 0``) returns zeros."""
    K, D = q.shape[-3], q.shape[-1]
    n_pages, page_size = k_pages.shape[-4:-2]
    table = torch.clamp(page_table.long(), 0, n_pages - 1)
    T = page_table.shape[-1] * page_size
    k = _gather_pages(k_pages, table)
    v = _gather_pages(v_pages, table)
    s = torch.einsum("...bkhd,...bthd->...bkht", q.float(), k.float()) * (1.0 / float(D) ** 0.5)
    if k_scale is not None:
        ks = _position_scale(k_scale, table, page_size)            # (*lead, B, T, H)
        s = s * ks.transpose(-1, -2).unsqueeze(-3)                 # (*lead, B, 1, H, T)
    lens = seq_lens[..., None, None, None] + torch.arange(K, device=q.device)[:, None, None]
    valid = torch.arange(T, device=q.device) < lens                # (*lead, B, K, 1, T)
    valid = valid & (seq_lens[..., None, None, None] > 0)          # idle slots -> 0
    p = masked_softmax(torch.where(valid, s, torch.tensor(NEG_INF, device=s.device)), valid)
    if v_scale is not None:
        vs = _position_scale(v_scale, table, page_size)
        p = p * vs.transpose(-1, -2).unsqueeze(-3)
    out = torch.einsum("...bkht,...bthd->...bkhd", p, v.float())
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("paged_attention")
    lib.ts_paged_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10
        + [ctypes.c_void_p])
    lib.ts_paged_attention.restype = ctypes.c_int
    return lib


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """The paged-attention sweep: q ``(*lead, B, K, H, D)`` f32 against
    ``(*lead, P, page, H, D)`` pools (f32, int8 or fp8-e4m3; ``(*lead, P,
    H)`` f32 scales when quantized) through a ``(*lead, B, max_pages)``
    table and ``(*lead, B)`` lengths -> ``(*lead, B, K, H, D)`` f32. On a
    CUDA tensor one kernel launch per rank reads each needed page once,
    dequantizes it in shared memory and keeps an online softmax; on a CPU
    tensor, the plain version. The pools may be strided views (a layer of
    the stacked cache) as long as ``d_head`` is contiguous."""
    _check_decode_operands(q, k_pages, v_pages, page_table, seq_lens)
    if not route(q, "paged_attention"):
        return _verify_attention_dense(q, k_pages, v_pages, page_table, seq_lens,
                                       k_scale, v_scale)
    n = page_table.ndim - 2
    B, K, H, D = q.shape[n:]
    n_pages, page_size = k_pages.shape[n:n + 2]
    why = paged_attention_supported(H, D, page_size, k_pages.dtype)
    if why is None and K > MAX_K:
        why = f"{K} queries per sequence above the kernel's limit of {MAX_K}"
    if why is not None:
        raise ValueError(f"paged_attention: {why}")
    if q.dtype != torch.float32:
        raise TypeError(f"paged_attention: q must be float32, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (k_pages.dtype != torch.float32) or (v_scale is None) == quantized:
        raise ValueError("paged_attention: scales go with (and only with) quantized pools")
    for t, what in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"paged_attention: {what} must be on {q.device} "
                             "with d_head contiguous")
    q = q.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if quantized:
        k_scale = k_scale.to(torch.float32)
        v_scale = v_scale.to(torch.float32)
    lib = _lib()
    for r in itertools.product(*(range(s) for s in table.shape[:n])):
        kp, vp = k_pages[r], v_pages[r]
        ks, vs = (k_scale[r], v_scale[r]) if quantized else (None, None)
        strides = [*kp.stride()[:3], *vp.stride()[:3],
                   *(ks.stride() if quantized else (0, 0)), *(vs.stride() if quantized else (0, 0))]
        with torch.cuda.device(q.device):
            err = lib.ts_paged_attention(
                q[r].data_ptr(), kp.data_ptr(), vp.data_ptr(),
                ks.data_ptr() if quantized else None, vs.data_ptr() if quantized else None,
                table[r].data_ptr(), lens[r].data_ptr(), out[r].data_ptr(),
                B, K, H, D, page_size, n_pages, table.shape[-1], POOL_DTYPES[k_pages.dtype],
                *strides, stream_of(q))
        check_status(lib, err, "paged_attention")
        paged_attention.launches += 1
    return out


def _use_paged_kernel(fused: bool | None, q: torch.Tensor) -> bool:
    """Resolve the ``fused`` argument of the cached entry points."""
    if fused is False:
        return False
    if fused is True and q.device.type != "cuda":
        raise ValueError("fused=True but the paged kernel has no CPU mode "
                         f"(q is on {q.device}); pass fused=False or None")
    return route(q, "paged_attention")


def decode_attention(q, k_pages, v_pages, page_table, seq_lens, k_scale=None, v_scale=None,
                     fused: bool | None = None) -> torch.Tensor:
    """Single-token attention over the paged cache: q ``(*lead, B, H, D)``
    (each sequence's current-token query; its K/V already written),
    ``seq_lens`` the cached length including it -> ``(*lead, B, H, D)``.
    Idle slots (``seq_len == 0``) return zeros."""
    n = page_table.ndim - 2
    if q.ndim != n + 3:
        raise ValueError(f"bad decode shapes q={tuple(q.shape)}")
    _check_decode_operands(q, k_pages, v_pages, page_table, seq_lens)
    kernel = paged_attention if _use_paged_kernel(fused, q) else _verify_attention_dense
    out = kernel(q.unsqueeze(-3), k_pages, v_pages, page_table, seq_lens, k_scale, v_scale)
    return out.squeeze(-3)


def verify_attention(q, k_pages, v_pages, page_table, seq_lens, k_scale=None, v_scale=None,
                     fused: bool | None = None) -> torch.Tensor:
    """K queued tokens per sequence against the paged cache through one
    sweep (speculative verify and chunked context prefill): q ``(*lead,
    B, K, H, D)``, ``seq_lens`` the cached length including position 0;
    position ``j`` attends the first ``seq_len + j`` entries."""
    n = page_table.ndim - 2
    if q.ndim != n + 4:
        raise ValueError(f"bad verify shapes q={tuple(q.shape)}")
    _check_decode_operands(q, k_pages, v_pages, page_table, seq_lens)
    kernel = paged_attention if _use_paged_kernel(fused, q) else _verify_attention_dense
    return kernel(q, k_pages, v_pages, page_table, seq_lens, k_scale, v_scale)


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (paged_attention,)
reset_launches, launch_counts = counters(WRAPPERS)
