"""Attention kernels: flash attention (``csrc/flash_attention.cu``) and
cached decode attention over the paged KV pool (``csrc/paged_attention.cu``).

The twin of ``tpuscratch.ops.attention``. Its first half is exact
blockwise attention with an online softmax and a recomputing backward
(:62-1127 there); its second half serves decode, speculative verify and
chunked context prefill against a block-paged pool (:1129-1640).

Flash attention, q ``(..., S, H, D)`` and k/v ``(..., T, H, D)`` with any
leading dims (the stacked mesh's ranks, the batch) written out in place
of ``vmap``:

- ``flash_attention``: the public entry point, differentiable through the
  two ``torch.autograd.Function``s below (their backward launches the
  backward kernels), or ``return_state=True`` for a ring merge.
- the kernel wrappers, each with its own launch count: ``_flash_fwd_call``
  (any offsets: ints or per-entry int tensors), ``_flash_fwd_compact``
  (causal, int offsets: self-attention), ``_flash_bwd_call`` (with
  ``out_dtype``) and ``_flash_bwd_compact``. On a CUDA tensor each launches
  its kernel(s) or raises; on a CPU tensor it runs the plain version
  (``_flash_fwd_plain`` / ``_flash_bwd_plain``). The dense and compact
  TPU grids are one CUDA loop with another bound, so a compact wrapper
  launches the same kernel as its dense twin with static offsets. The
  kernels are chosen by dtype and head width alone (``csrc/
  flash_attention.cu``): f32 heads up to 128 columns run split TF32 on the
  tensor cores, bf16 heads up to 448 the bf16 tensor-core kernels, wider
  heads the FMA kernels; f16 operands are widened to f32 and take the f32
  kernels (the JAX kernel computes them in f32), their outputs rounded back
  to f16; after each launch a wrapper's ``route`` attribute names the
  kernels it took (``FLASH_ROUTES``).
- ``_pick_block``: a tile hint (the TPU's power-of-two divisor rule no
  longer refuses anything): the kernels take any S, T >= 1 and mask their
  ragged edges. ``block_q``/``block_k`` are accepted everywhere and do not
  steer the CUDA tile, which depends on D and the card's shared memory.

Paged attention:

- ``paged_attention``: the wrapper of the hand-written CUDA kernels (the
  port of the Pallas ``paged_attention``); on a CPU tensor it runs the
  plain version. ``paged_plan`` and ``paged_load_width`` are its host
  rules (ring, load width, split over the positions); after each launch
  its ``route`` attribute names the load width taken and ``splits`` the
  split count.
- ``_verify_attention_dense``: the plain version (the JAX package's dense
  oracle): gather, scale-folded contractions, masked softmax.
- ``paged_split_plain`` / ``combine_splits_plain``: the kernel's
  split-and-combine arithmetic in torch ops (each split's partial
  ``(m, l, acc)``, then their merge in split order), for the tests.
- ``decode_attention`` / ``verify_attention``: the entry points. ``fused``
  None routes by device (a CUDA tensor launches the kernel, a CPU tensor
  takes the plain version), True demands the kernel (and raises on the
  CPU, where there is none), False forces the plain version on either
  device (the JAX ``"off"`` mode, the oracle on the card).

Every paged operand may carry leading dims (the stacked mesh's ranks):
rank r's queries attend rank r's pool. The kernel takes any query count K,
any ``d_head`` and an f32, bf16 or f16 q, and returns q's dtype; the TPU's
layout rules (``D % 128``, ``H % 8``, ``page_size % 8``, the VMEM
head-block budget) do not apply.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math

import numpy as np
import torch

from tpuscratch_torch.comm.spmd import lead_index
from tpuscratch_torch.ops.common import check_status, counters, library, route, stream_of
from tpuscratch_torch.parallel.scores import NEG_INF, masked_softmax

#: pool dtype -> the kernel's dtype code (``csrc/paged_attention.cu``)
POOL_DTYPES = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
#: q dtypes the paged kernel takes as they are (its output has q's dtype)
PAGED_Q_DTYPES = (torch.float32, torch.bfloat16)
#: q dtypes the paged wrapper widens to float32 first (the JAX kernel
#: computes in f32 too); the output is rounded back to q's dtype
PAGED_Q_WIDENED = (torch.float16,)
#: q/k/v dtypes the flash kernels take as they are
FLASH_DTYPES = (torch.float32, torch.bfloat16)
#: q/k/v dtypes the flash wrappers widen to float32 first: the JAX kernel
#: computes them in f32 (``_mm_dtype``), so they take the f32 kernels and
#: their outputs are rounded back to the operands' dtype
FLASH_WIDENED = (torch.float16,)
#: ``ts_flash_last_route()`` -> the kernels a flash launch took: the FMA
#: kernels (wide heads), split TF32 (f32) or the bf16 tensor-core kernels
FLASH_ROUTES = ("fma", "tf32", "bf16")


# ---- flash attention -------------------------------------------------------------


def _mm_dtype(x: torch.Tensor) -> torch.dtype:
    """The product operand dtype: bf16 inputs stay bf16 (f32 accumulation),
    everything else computes in f32 (the JAX package's ``_mm_dtype``)."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in the operand dtype (rounded there), as f32 values."""
    mm = _mm_dtype(x)
    return (x.to(mm) * torch.tensor(scale, dtype=mm)).float()


def _pick_block(n: int, want: int) -> int:
    """Largest power-of-two block <= ``want`` that divides ``n``, at least 1.
    A hint only: the CUDA kernels mask ragged edges, so no length is
    refused (the TPU's 8-row rule is gone)."""
    b = max(1, int(want))
    while b > 1 and n % b:
        b //= 2
    return b


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.ndim < 3 or k.shape != v.shape or q.ndim != k.ndim
            or q.shape[:-3] != k.shape[:-3] or q.shape[-2:] != k.shape[-2:]):
        raise ValueError(f"bad attention shapes {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")


def _is_static(off) -> bool:
    return isinstance(off, (int, np.integer))


def _offsets(off, lead: tuple, device) -> torch.Tensor:
    """An offset (an int or a tensor broadcasting to the leading dims) as an
    int64 tensor of the leading dims' shape."""
    t = torch.as_tensor(off, device=device).to(torch.int64)
    return torch.broadcast_to(t, lead)


def _keep(q_offset, kv_offset, S: int, T: int, lead: tuple, causal: bool, device):
    """The boolean ``(*lead, 1, S, T)`` mask (True = attend) on global
    positions; None when nothing is masked."""
    if not causal:
        return None
    rows = _offsets(q_offset, lead, device)[..., None, None, None] + torch.arange(
        S, device=device)[:, None]
    cols = _offsets(kv_offset, lead, device)[..., None, None, None] + torch.arange(
        T, device=device)
    return rows >= cols


def _plain_scores(q, k, q_offset, kv_offset, causal):
    """Scaled scores ``(..., H, S, T)`` f32 with q * scale rounded to the
    operand dtype, and the mask."""
    S, T, D = q.shape[-3], k.shape[-3], q.shape[-1]
    s = torch.einsum("...shd,...thd->...hst", _scaled(q, 1.0 / math.sqrt(D)), k.float())
    keep = _keep(q_offset, kv_offset, S, T, tuple(q.shape[:-3]), causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.tensor(NEG_INF, device=s.device))
    return s, keep


def _flash_fwd_plain(q, k, v, q_offset, kv_offset, causal: bool, return_state: bool):
    """The forward kernel's function in torch ops: the full softmax at once
    (the kernel's online one is the same up to rounding order); p is rounded
    to the operand dtype before P.V. State: (acc (..., S, H, D) f32, m, l
    (..., H, S)); else acc / l (l == 0 -> 0) in q's dtype."""
    s, keep = _plain_scores(q, k, q_offset, kv_offset, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    l = p.sum(dim=-1)
    acc = torch.einsum("...hst,...thd->...shd", p.to(_mm_dtype(v)).float(), v.float())
    if return_state:
        return acc, m, l
    safe = torch.where(l > 0, l, torch.ones((), device=l.device))
    return (acc / safe.transpose(-1, -2)[..., None]).to(q.dtype)


def _flash_bwd_plain(q, k, v, do, lse, delta, q_offset, kv_offset, causal: bool,
                     out_dtype=None):
    """The backward kernels' function in torch ops: p recomputed from lse,
    ds = p * (do v^T - delta), dq = ds (k * scale), dk = ds^T (q * scale),
    dv = p^T do; do, p and ds rounded to the operand dtype before their
    products."""
    mm = _mm_dtype(q)
    D = q.shape[-1]
    s, keep = _plain_scores(q, k, q_offset, kv_offset, causal)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    dof = do.to(mm).float()
    dp = torch.einsum("...shd,...thd->...hst", dof, v.float())
    ds = (p * (dp - delta[..., None])).to(mm).float()
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("...hst,...thd->...shd", ds, _scaled(k, scale))
    dk = torch.einsum("...hst,...shd->...thd", ds, _scaled(q, scale))
    dv = torch.einsum("...hst,...shd->...thd", p.to(mm).float(), dof)
    od = out_dtype or q.dtype
    return dq.to(od), dk.to(od), dv.to(od)


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    lib.ts_flash_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.ts_flash_fwd.restype = ctypes.c_int
    lib.ts_flash_bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.ts_flash_bwd.restype = ctypes.c_int
    lib.ts_flash_last_route.argtypes = []
    lib.ts_flash_last_route.restype = ctypes.c_int
    return lib


def _kernel_scale(D: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) rounded to the operand dtype, as the kernels multiply by it."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=dtype).float())


def _offset_args(off, lead: tuple, device):
    """(per-entry int32 tensor or None, scalar) for a kernel launch: an int
    offset rides as the scalar, a tensor as one int32 an entry."""
    if _is_static(off):
        return None, int(off)
    t = torch.broadcast_to(torch.as_tensor(off, device=device).to(torch.int32), lead)
    return t.contiguous().reshape(-1), 0


def _flash_operands(name, tensors):
    """The kernels' operands: contiguous, of one dtype the kernels take,
    float16 widened to float32 (``FLASH_WIDENED``)."""
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on {t.device} and {tensors[0].device}")
        if t.dtype not in FLASH_DTYPES + FLASH_WIDENED or t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: the CUDA kernels take float32, bfloat16 or float16 "
                            f"operands of one dtype, got {[str(x.dtype) for x in tensors]}")
    if tensors[0].dtype in FLASH_WIDENED:
        return [t.float().contiguous() for t in tensors]
    return [t.contiguous() for t in tensors]


def _launch_fwd(wrapper, q, k, v, q_offset, kv_offset, causal, return_state):
    _check_flash(q, k, v)
    io = q.dtype
    q, k, v = _flash_operands(wrapper.__name__, [q, k, v])
    lead = tuple(q.shape[:-3])
    S, H, D = q.shape[-3:]
    T = k.shape[-3]
    B = math.prod(lead)
    qo_t, qo = _offset_args(q_offset, lead, q.device)
    ko_t, ko = _offset_args(kv_offset, lead, q.device)
    if return_state:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty(lead + (H, S), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        out, m, l = torch.empty_like(q), None, None
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        err = lib.ts_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if qo_t is None else qo_t.data_ptr(), None if ko_t is None else ko_t.data_ptr(),
            out.data_ptr(), None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(),
            B, S, T, H, D, int(causal), int(q.dtype == torch.bfloat16), int(return_state),
            qo, ko, _kernel_scale(D, q.dtype), stream_of(q))
    check_status(lib, err, wrapper.__name__)
    wrapper.launches += 1
    wrapper.route = FLASH_ROUTES[lib.ts_flash_last_route()]
    return (out, m, l) if return_state else out.to(io)


def _launch_bwd(wrapper, q, k, v, do, lse, delta, q_offset, kv_offset, causal, out_dtype):
    _check_flash(q, k, v)
    io = q.dtype
    q, k, v = _flash_operands(wrapper.__name__, [q, k, v])
    do = do.to(q.dtype).contiguous()
    lead = tuple(q.shape[:-3])
    S, H, D = q.shape[-3:]
    T = k.shape[-3]
    if do.shape != q.shape or tuple(lse.shape) != lead + (H, S) or lse.shape != delta.shape:
        raise ValueError(f"{wrapper.__name__}: do {tuple(do.shape)}, lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)} for q {tuple(q.shape)}")
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    od = out_dtype or io
    if od not in (torch.float32, io):
        raise TypeError(f"{wrapper.__name__}: out_dtype {od} is neither float32 nor q's dtype")
    kod = od if od == q.dtype else torch.float32  # widened operands: f32 out, rounded after
    qo_t, qo = _offset_args(q_offset, lead, q.device)
    ko_t, ko = _offset_args(kv_offset, lead, q.device)
    dq = torch.empty(q.shape, dtype=kod, device=q.device)
    dk = torch.empty(k.shape, dtype=kod, device=q.device)
    dv = torch.empty(k.shape, dtype=kod, device=q.device)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        err = lib.ts_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if qo_t is None else qo_t.data_ptr(),
            None if ko_t is None else ko_t.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), math.prod(lead), S, T, H, D, int(causal),
            int(q.dtype == torch.bfloat16), int(kod == torch.float32), qo, ko,
            _kernel_scale(D, q.dtype), stream_of(q))
    check_status(lib, err, wrapper.__name__)
    wrapper.launches += 1
    wrapper.route = FLASH_ROUTES[lib.ts_flash_last_route()]
    return dq.to(od), dk.to(od), dv.to(od)


def _flash_fwd_call(q, k, v, q_offset, kv_offset, causal: bool, block_q=None, block_k=None,
                    return_state: bool = False):
    """The forward at any offsets (ints, or int tensors broadcasting to the
    leading dims: one per ring rank and batch row): q ``(..., S, H, D)``,
    k/v ``(..., T, H, D)`` -> out ``(..., S, H, D)`` in q's dtype, or with
    ``return_state`` (acc f32 ``(..., S, H, D)``, m, l ``(..., H, S)``).
    One launch of the forward kernel (``route`` names which);
    ``block_q``/``block_k`` are ignored."""
    del block_q, block_k
    if not route(q, "_flash_fwd_call"):
        return _flash_fwd_plain(q, k, v, q_offset, kv_offset, causal, return_state)
    return _launch_fwd(_flash_fwd_call, q, k, v, q_offset, kv_offset, causal, return_state)


def _flash_fwd_compact(q, k, v, q_offset: int, kv_offset: int, block_q=None, block_k=None,
                       return_state: bool = False):
    """The causal forward at int offsets (self-attention): the TPU's compact
    grid, here the forward kernel with its causal loop bound. Never None:
    fully masked rows come out zero."""
    del block_q, block_k
    if not (_is_static(q_offset) and _is_static(kv_offset)):
        raise TypeError("_flash_fwd_compact takes int offsets")
    if not route(q, "_flash_fwd_compact"):
        return _flash_fwd_plain(q, k, v, q_offset, kv_offset, True, return_state)
    return _launch_fwd(_flash_fwd_compact, q, k, v, q_offset, kv_offset, True, return_state)


def _flash_bwd_call(q, k, v, do, lse, delta, q_offset, kv_offset, causal: bool, block_q=None,
                    block_k=None, out_dtype=None):
    """dq, dk, dv from the saved lse and delta (``(..., H, S)`` f32), at any
    offsets; ``out_dtype`` float32 gives f32 partials (the ring backward
    sums several calls), else q's dtype. One call launches the dq and the
    dk/dv kernel (counted once; ``route`` names which pair)."""
    del block_q, block_k
    if not route(q, "_flash_bwd_call"):
        return _flash_bwd_plain(q, k, v, do, lse, delta, q_offset, kv_offset, causal, out_dtype)
    return _launch_bwd(_flash_bwd_call, q, k, v, do, lse, delta, q_offset, kv_offset, causal,
                       out_dtype)


def _flash_bwd_compact(q, k, v, do, lse, delta, q_offset: int, kv_offset: int, block_q=None,
                       block_k=None, out_dtype=None):
    """The causal backward at int offsets (the TPU's compact backward
    grids), the same two kernels as :func:`_flash_bwd_call`."""
    del block_q, block_k
    if not (_is_static(q_offset) and _is_static(kv_offset)):
        raise TypeError("_flash_bwd_compact takes int offsets")
    if not route(q, "_flash_bwd_compact"):
        return _flash_bwd_plain(q, k, v, do, lse, delta, q_offset, kv_offset, True, out_dtype)
    return _launch_bwd(_flash_bwd_compact, q, k, v, do, lse, delta, q_offset, kv_offset, True,
                       out_dtype)


def _normalize(acc, m, l, dtype):
    """(o in ``dtype``, lse) from a forward state, as the custom VJPs make
    them: l clamped at 1e-30, lse = m + log(l)."""
    l_safe = torch.clamp_min(l, 1e-30)
    o = (acc / l_safe.transpose(-1, -2)[..., None]).to(dtype)
    return o, m + torch.log(l_safe)


def _delta(do, o):
    """sum(do * o) over D in f32, ``(..., H, S)``."""
    return (do.float() * o.float()).sum(dim=-1).transpose(-1, -2)


class _FlashDiff(torch.autograd.Function):
    """Differentiable flash attention at any offsets (the JAX ``_flash_diff``):
    the forward runs the state kernel and saves o in q's dtype and lse; the
    backward launches the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_offset, causal):
        acc, m, l = _flash_fwd_call(q, k, v, q_offset, kv_offset, causal, return_state=True)
        o, lse = _normalize(acc, m, l, q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.offsets, ctx.causal = (q_offset, kv_offset), causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_call(q, k, v, do, lse, _delta(do, o), *ctx.offsets, ctx.causal)
        return dq, dk, dv, None, None, None


class _FlashDiffCompact(torch.autograd.Function):
    """Differentiable causal flash attention at int offsets (the JAX
    ``_flash_diff_compact``): the compact wrappers both ways."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_offset):
        acc, m, l = _flash_fwd_compact(q, k, v, q_offset, kv_offset, return_state=True)
        o, lse = _normalize(acc, m, l, q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.offsets = (q_offset, kv_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_compact(q, k, v, do, lse, _delta(do, o), *ctx.offsets)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, q_offset=0, kv_offset=0, block_q: int = 1024,
                    block_k: int | None = None, return_state: bool = False):
    """Exact attention with O(S·D) memory a head: q ``(..., S, H, D)``, k/v
    ``(..., T, H, D)`` -> ``(..., S, H, D)`` in q's dtype. Offsets place the
    rows and columns in global coordinates for causal masking: ints, or
    int tensors broadcasting to the leading dims (each ring rank and batch
    row its own). A row that attends nothing comes out zero, its gradients
    zero.

    Differentiable: the backward recomputes the scores from the saved
    log-sum-exp in the two backward kernels (with no gradient to take, one
    forward launch writes the normalized output). Causal calls with int offsets
    take the compact wrappers, every other call the dense ones (on the card
    the same kernels with another loop bound).

    ``return_state=True`` returns ``(acc, m, l)`` instead: the unnormalized
    f32 weighted sum ``(..., S, H, D)`` and the running max / normalizer
    ``(..., H, S)`` f32, for an exact merge across blocks (forward only).

    ``block_q``/``block_k`` are accepted for the JAX signature and do not
    steer the CUDA tile."""
    _check_flash(q, k, v)
    del block_q, block_k
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if causal and _is_static(q_offset) and _is_static(kv_offset):
        qo, ko = int(q_offset), int(kv_offset)
        if return_state or not grad:
            return _flash_fwd_compact(q, k, v, qo, ko, return_state=return_state)
        return _FlashDiffCompact.apply(q, k, v, qo, ko)
    if return_state or not grad:
        return _flash_fwd_call(q, k, v, q_offset, kv_offset, causal, return_state=return_state)
    return _FlashDiff.apply(q, k, v, q_offset, kv_offset, causal)


# ---- cached decode attention -------------------------------------------------------


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


def paged_split_plain(q, k_pages, v_pages, page_table, seq_lens, k_scale=None, v_scale=None,
                      *, split_len: int, n_split: int):
    """The kernel's splits in torch ops: split ``s`` attends the positions
    ``[s * split_len, (s + 1) * split_len)`` of what the plain version
    attends and leaves its partial state, ``m`` (the running max, NEG_INF
    where it attends nothing), ``l`` (the sum of ``exp(score - m)``) and
    ``acc`` (the unnormalized, V-scale-folded P.V): ``(n_split, *lead, B,
    K, H)``, ``(n_split, *lead, B, K, H)`` and ``(n_split, *lead, B, K, H,
    D)`` f32. A split that attends nothing gives m = NEG_INF, l = 0 and
    acc = 0."""
    K, D = q.shape[-3], q.shape[-1]
    n_pages, page_size = k_pages.shape[-4:-2]
    table = torch.clamp(page_table.long(), 0, n_pages - 1)
    T = page_table.shape[-1] * page_size
    k = _gather_pages(k_pages, table)
    v = _gather_pages(v_pages, table).float()
    s = torch.einsum("...bkhd,...bthd->...bkht", q.float(), k.float()) * (1.0 / float(D) ** 0.5)
    if k_scale is not None:
        s = s * _position_scale(k_scale, table, page_size).transpose(-1, -2).unsqueeze(-3)
    t = torch.arange(T, device=q.device)
    lens = seq_lens[..., None, None, None] + torch.arange(K, device=q.device)[:, None, None]
    valid = (t < lens) & (seq_lens[..., None, None, None] > 0)     # (*lead, B, K, 1, T)
    vs = (None if v_scale is None else
          _position_scale(v_scale, table, page_size).transpose(-1, -2).unsqueeze(-3))
    neg = torch.tensor(NEG_INF, device=q.device)
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        ok = valid & (t >= sp * split_len) & (t < (sp + 1) * split_len)
        sm = torch.where(ok, s, neg)
        m = sm.amax(dim=-1)
        p = torch.where(ok, torch.exp(sm - m[..., None]), torch.zeros((), device=q.device))
        ls.append(p.sum(dim=-1))
        ms.append(m)
        if vs is not None:
            p = p * vs
        accs.append(torch.einsum("...bkht,...bthd->...bkhd", p, v))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_splits_plain(m, l, acc, dtype=torch.float32, drop_rescale: int | None = None):
    """The combine kernel's merge of split partials (``paged_split_plain``'s
    layout) in split order: ``M = max_s m_s``, ``f_s = exp(m_s - M)``,
    out = ``sum_s f_s acc_s / sum_s f_s l_s`` (0 where the sum is 0), in
    ``dtype``. ``drop_rescale=s`` plants a fault: split ``s``'s factor
    is taken as 1."""
    M = m.amax(dim=0)
    f = torch.exp(m - M)
    if drop_rescale is not None:
        f = f.clone()
        f[drop_rescale] = 1.0
    L = (l * f).sum(dim=0)
    O = (acc * f[..., None]).sum(dim=0)
    safe = torch.where(L > 0, L, torch.ones((), device=L.device))
    return torch.where(L[..., None] > 0, O / safe[..., None],
                       torch.zeros((), device=L.device)).to(dtype)


# The paged kernel's host rules (csrc/paged_attention.cu). A block of 8
# warps owns (head, sequence, group of <= 8 queries, output tile, split)
# and streams its positions through a ring of `stages` chunks of `tt`
# tokens.
PAGED_THREADS = 256
PAGED_STAGES = 4
PAGED_STAGE_BYTES = 32 << 10   # K and V rows a ring stage holds, at most
PAGED_MAX_TT = 64              # tokens a chunk, at most
PAGED_TILE = 512               # output columns a block owns (4 a lane, NJ = 4)
PAGED_MIN_SPLIT = 256          # positions a split covers, at least
PAGED_MAX_SPLITS = 64
PAGED_WAVES = 2                # blocks an SM the split aims for
PAGED_SM_SMEM = 233472         # shared memory an SM has for blocks (228 KB)
PAGED_BLOCK_RESERVED = 1024    # of which the runtime keeps a block
PAGED_SM_BLOCKS = 2            # blocks an SM holds at most (<= 128 registers a thread)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """One launch's shape: the load width ``vb`` (bytes a cp.async), ``nj``
    4-column groups a lane owns of the output tile (``wide``: D > 512, in
    ``n_dt`` tiles), ``wq`` queries a block, ``tt`` tokens a chunk,
    ``stages`` ring stages, ``n_split`` splits of ``split_len`` positions
    and the dynamic shared memory ``smem``."""

    vb: int
    nj: int
    wide: bool
    n_dt: int
    wq: int
    tt: int
    stages: int
    n_split: int
    split_len: int
    smem: int

    @property
    def route(self) -> str:
        return f"{self.vb}B"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def paged_load_width(esize: int, D: int, strides, data_ptrs) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides a pool row
    (``D * esize`` bytes), every pool stride (elements) and both pools'
    base addresses; 1-byte elements that allow none take plain byte loads
    (1)."""
    sizes = [D * esize] + [s * esize for s in strides] + list(data_ptrs)
    for w in (16, 8, 4):
        if w >= esize and all(x % w == 0 for x in sizes):
            return w
    return esize


def _paged_row_bytes(esize: int, D: int, wide: bool) -> int:
    """A ring row: a whole K or V row padded to 16 bytes, or a wide head's
    512-column slice of one."""
    return PAGED_TILE * esize if wide else _ceil(4 * _ceil(D, 4) * esize, 16) * 16


def paged_smem(esize: int, D: int, nj: int, wide: bool, wq: int, tt: int, stages: int) -> int:
    """Dynamic shared memory of a launch (the launcher's ``smem_bytes``):
    a wide head's scores of a chunk (``wq`` x ``tt`` f32), then the ring,
    which the warps' final merge reuses. A narrow stage holds a chunk's K
    rows, V rows and their scales; a wide one a unit: one 512-column slice
    of the chunk's K rows or its V tile, and both scales."""
    rs = _paged_row_bytes(esize, D, wide)
    stage = _ceil((1 if wide else 2) * tt * rs + 8 * tt, 16) * 16
    merge = PAGED_THREADS // 32 * (4 + 128 * nj) * 4
    return (_ceil(4 * wq * tt, 16) * 16 if wide else 0) + max(stages * stage, merge)


@functools.lru_cache(maxsize=4096)
def paged_plan(B: int, K: int, H: int, D: int, page: int, max_pages: int, esize: int, vb: int,
               n_sm: int, smem_optin: int) -> PagedPlan:
    """The paged kernel's shape rule. Heads up to 512 columns keep a
    lane's columns in registers (``nj`` 1, 2 or 4 groups of 4 a 32-lane
    slice), wider ones take output tiles of 512 and stream a chunk through
    the ring as 512-column units (``paged_wide_kernel``), so no width is
    refused. One
    query a block at K = 1, 2 at K = 2, 4 up to K = 4, else 8 (the 8 warps
    split a chunk's tokens 8, 4, 2 or 1 ways and its queries the other way). A
    chunk holds at most PAGED_STAGE_BYTES of K and V rows (a wide unit,
    of K or V slices) and
    PAGED_MAX_TT tokens (a power of two, at most the positions the table
    covers). The positions (``max_pages * page``, the lengths' upper
    bound) are split when the other block dims leave fewer blocks than
    the SMs: as many splits as PAGED_WAVES blocks an SM hold (never a
    second, partial wave), each of at least PAGED_MIN_SPLIT positions (a
    multiple of the chunk). The ring then
    takes as many stages (2 to PAGED_STAGES) as keep every block of the
    launch resident at once, shrunk further until it fits
    ``smem_optin``."""
    d4 = _ceil(D, 4)
    wide = d4 > 128
    nj = 4 if wide else (1 if d4 <= 32 else 2 if d4 <= 64 else 4)
    n_dt = _ceil(d4, 128) if wide else 1
    wq = 1 if K == 1 else 2 if K == 2 else 4 if K <= 4 else 8
    unit = (1 if wide else 2) * _paged_row_bytes(esize, D, wide)  # bytes a token a stage
    tcap = max_pages * page
    tt = PAGED_MAX_TT
    while tt > 1 and (tt * unit > PAGED_STAGE_BYTES or tt >= 2 * tcap):
        tt //= 2
    base = B * H * _ceil(K, wq) * n_dt
    n_split = 1
    if base < n_sm:
        n_split = max(1, min(PAGED_WAVES * n_sm // base, tcap // PAGED_MIN_SPLIT,
                             PAGED_MAX_SPLITS))
    split_len = _ceil(_ceil(tcap, n_split), tt) * tt
    n_split = _ceil(tcap, split_len)
    per_sm = _ceil(base * n_split, n_sm)                      # blocks an SM must hold
    room = PAGED_SM_SMEM // min(per_sm, PAGED_SM_BLOCKS) - PAGED_BLOCK_RESERVED
    stages = PAGED_STAGES
    while stages > 2 and paged_smem(esize, D, nj, wide, wq, tt, stages) > room:
        stages -= 1
    while paged_smem(esize, D, nj, wide, wq, tt, stages) > smem_optin:
        if stages > 2:
            stages -= 1
        elif tt > 1:
            tt //= 2
        else:
            raise ValueError(f"paged_attention: {smem_optin} B of shared memory a block "
                             "hold no ring")
    return PagedPlan(vb, nj, wide, n_dt, wq, tt, stages, n_split, split_len,
                     paged_smem(esize, D, nj, wide, wq, tt, stages))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("paged_attention")
    lib.ts_paged_attention.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 18 + [ctypes.c_longlong] * 10
        + [ctypes.c_void_p])
    lib.ts_paged_attention.restype = ctypes.c_int
    lib.ts_paged_device.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.ts_paged_device.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _paged_device(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory a block) of card ``index``."""
    lib = _lib()
    sms, optin = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        check_status(lib, lib.ts_paged_device(ctypes.byref(sms), ctypes.byref(optin)),
                     "paged_attention")
    return sms.value, optin.value


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """The paged-attention sweep: q ``(*lead, B, K, H, D)`` f32, bf16 or
    f16 against ``(*lead, P, page, H, D)`` pools (f32, int8 or fp8-e4m3;
    ``(*lead, P, H)`` f32 scales when quantized) through a ``(*lead, B,
    max_pages)`` table and ``(*lead, B)`` lengths -> ``(*lead, B, K, H, D)``
    in q's dtype (softmax and accumulator in f32; an f16 q is widened to
    f32 for the kernel and its output rounded back). On a CUDA tensor one
    call per rank, counted as one launch, streams each needed page through
    a shared-memory ring (``paged_plan``), split over the positions when
    the batch leaves the SMs idle, the splits merged by a second kernel in
    split order; on a CPU tensor, the plain version. The pools may be
    strided views (a layer of the stacked cache) as long as ``d_head`` is
    contiguous."""
    _check_decode_operands(q, k_pages, v_pages, page_table, seq_lens)
    if not route(q, "paged_attention"):
        return _verify_attention_dense(q, k_pages, v_pages, page_table, seq_lens,
                                       k_scale, v_scale)
    n = page_table.ndim - 2
    B, K, H, D = q.shape[n:]
    page_size = k_pages.shape[n + 1]
    if k_pages.dtype not in POOL_DTYPES:
        raise ValueError(f"paged_attention: pool dtype {k_pages.dtype} not in the ladder "
                         "(float32, int8, float8_e4m3fn)")
    if q.dtype not in PAGED_Q_DTYPES + PAGED_Q_WIDENED:
        raise TypeError(f"paged_attention: q must be float32, bfloat16 or float16, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (k_pages.dtype != torch.float32) or (v_scale is None) == quantized:
        raise ValueError("paged_attention: scales go with (and only with) quantized pools")
    for t, what in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.device != q.device or t.stride(-1) != 1 or t.dtype != k_pages.dtype:
            raise ValueError(f"paged_attention: {what} must be on {q.device}, of one pool "
                             "dtype, with d_head contiguous")
    esize = k_pages.element_size()
    vb = paged_load_width(esize, D, k_pages.stride()[:-1] + v_pages.stride()[:-1],
                          (k_pages.data_ptr(), v_pages.data_ptr()))
    plan = paged_plan(B, K, H, D, page_size, page_table.shape[-1], esize, vb,
                      *_paged_device(q.device.index))
    wide = q.float() if q.dtype in PAGED_Q_WIDENED else q
    out = _paged_launch(plan, wide, k_pages, v_pages, page_table, seq_lens, k_scale, v_scale)
    paged_attention.route = plan.route
    paged_attention.splits = plan.n_split
    return out.to(q.dtype)


def _paged_launch(plan: PagedPlan, q, k_pages, v_pages, page_table, seq_lens, k_scale,
                  v_scale) -> torch.Tensor:
    """The kernels of one ``paged_attention`` call on checked CUDA operands
    under ``plan`` (a rank at a time, each counted as one launch; with
    ``n_split > 1`` the combine kernel follows the split kernel)."""
    n = page_table.ndim - 2
    B, K, H, D = q.shape[n:]
    n_pages, page_size = k_pages.shape[n:n + 2]
    quantized = k_scale is not None
    q = q.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if quantized:
        k_scale = k_scale.to(torch.float32)
        v_scale = v_scale.to(torch.float32)
    parts = [None, None, None]
    if plan.n_split > 1:
        rows = (plan.n_split, B, K, H)
        parts = [torch.empty(rows, dtype=torch.float32, device=q.device),
                 torch.empty(rows, dtype=torch.float32, device=q.device),
                 torch.empty(rows + (D,), dtype=torch.float32, device=q.device)]
    ptrs = [None if t is None else t.data_ptr() for t in parts]
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
                table[r].data_ptr(), lens[r].data_ptr(), out[r].data_ptr(), *ptrs,
                B, K, H, D, page_size, n_pages, table.shape[-1], POOL_DTYPES[k_pages.dtype],
                int(q.dtype == torch.bfloat16), plan.vb, plan.tt, plan.stages, plan.n_split,
                plan.split_len, plan.wq, plan.nj, int(plan.wide), plan.n_dt, *strides,
                stream_of(q))
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
WRAPPERS = (_flash_fwd_call, _flash_fwd_compact, _flash_bwd_call, _flash_bwd_compact,
            paged_attention)
reset_launches, launch_counts = counters(WRAPPERS)
for _w in WRAPPERS:
    _w.route = None
paged_attention.splits = None
