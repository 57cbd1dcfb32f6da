"""The streamed 2D stencil: ``depth`` substeps in one pass (``csrc/stencil_stream2d.cu``).

The 2D part of ``tpuscratch.ops.stencil_stream``, with the same names and
contracts (its 3D kernel is still to port). ``nine_point_streamed_2d``
takes every rank's core at once: leading dims of ``core`` and of the
slabs and flags are a batch, the stacked ``(rows, cols)`` of the mesh.

Column modes, as in the JAX package: with ``gl``/``gr`` None, x self-wraps
(wrap mode, a periodic column axis); with ``gl``/``gr`` given as
``(H + 2*depth, depth)`` ghost-column slabs spanning global rows
``[-depth, H + depth)`` (the x neighbours' edge columns with the diagonal
neighbours' corner blocks at the ends), the columns may be distributed or
open (ghost mode). ``open_flags`` marks the physical open ends [top,
bottom, left, right] of each rank; the rings still acting as ghosts on an
open side stay zero after every substep.

On a CUDA tensor the wrapper launches ``stream2d_kernel`` (or raises); on
a CPU tensor it runs ``nine_point_streamed_2d_plain``, the same pyramid in
torch ops in the kernel's order of operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuscratch_torch.ops.common import (
    check_cuda,
    check_status,
    counters,
    library,
    route,
    smem_optin,
    stream_of,
    taps_args,
    trapezoid_tile,
)

#: The JAX package's default VMEM budget, accepted for its signature.
_VMEM_CEILING = 100 << 20

_P = ctypes.c_void_p
_I = ctypes.c_int


def weight_grid(coeffs9) -> tuple:
    """nine_point coeff order (n, s, w, e, nw, ne, sw, se, center) ->
    (3, 3) grid W[dy+1][dx+1]; 5-point coeffs get zero diagonals."""
    c = tuple(float(x) for x in coeffs9)
    if len(c) == 5:
        c = c[:4] + (0.0,) * 4 + c[4:]
    if len(c) != 9:
        raise ValueError(f"need 5 or 9 coefficients, got {len(c)}")
    n, s, w, e, nw, ne, sw, se, cc = c
    return ((nw, n, ne), (w, cc, e), (sw, s, se))


def stream2d_band(H: int, W: int, depth: int, itemsize: int,
                  budget_bytes: int, ghost_x: bool = False) -> int:
    """The TPU kernel's row band: the largest 8-multiple divisor of ``H``
    whose VMEM footprint fits the budget, with >= 2 bands of >= ``depth``
    rows. The CUDA kernel tiles the core in 2D blocks whatever its size
    and takes no band; this is the JAX package's pure sizing rule, kept
    for callers that size a band."""
    k = depth

    def cost(b):
        c = (4 * b + 2 * (b + 2 * k - 2)) * W
        if ghost_x:
            c += 2 * (H + 2 * k) * 128 + 2 * (b + 2 * k) * 128
        return c * itemsize

    for d in range(H // 2, 7, -1):
        if H % d == 0 and d % 8 == 0 and d >= k and cost(d) <= budget_bytes:
            return d
    raise ValueError(
        f"no 8-aligned band of H={H} gives >= 2 bands of >= depth={k} "
        f"rows within {budget_bytes >> 20} MB VMEM (need 8 | H and "
        "H >= 16); lower the depth or raise the budget"
    )


def stream_taps(coeffs) -> list[tuple[int, int, float]]:
    """(dy, dx, weight) in the TPU kernel's order: the weight grid row by
    row, zero weights skipped."""
    w9 = weight_grid(coeffs)
    return [(dy, dx, w9[dy + 1][dx + 1]) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if w9[dy + 1][dx + 1] != 0.0]


def _flags(open_flags, lead, device) -> torch.Tensor:
    """Per-rank int32 [top, bottom, left, right] flags shaped ``lead +
    (4,)``; None means no open end."""
    if open_flags is None:
        return torch.zeros(lead + (4,), dtype=torch.int32, device=device)
    f = torch.as_tensor(open_flags, device=device).to(torch.int32)
    if f.shape[-1:] != (4,):
        raise ValueError(f"open_flags must end in 4 entries, got {tuple(f.shape)}")
    return f.expand(lead + (4,)).contiguous()


def nine_point_streamed_2d_plain(core, a_top, a_bot, coeffs, depth, open_flags,
                                 gl=None, gr=None) -> torch.Tensor:
    """``depth`` substeps as the kernel runs them, in torch ops: the
    shrinking pyramid over the extended grid (slabs above and below; gl/gr
    or the wrapped columns beside), the rings still acting as ghosts on
    open sides set to zero after every substep but the last.
    ``open_flags`` is the ``(…, 4)`` int32 tensor of ``_flags``."""
    k = depth
    H, W = core.shape[-2:]
    taps = stream_taps(coeffs)
    a = torch.cat([a_top, core, a_bot], dim=-2)
    ghost = gl is not None
    if ghost:
        a = torch.cat([gl, a, gr], dim=-1)
    else:
        a = a[..., (torch.arange(-k, W + k, device=core.device) % W)]
    f = open_flags.bool()[..., None, None]
    for s in range(1, k + 1):
        P, Q = a.shape[-2:]
        acc = None
        for dy, dx, wgt in taps:
            term = wgt * a[..., 1 + dy : P - 1 + dy, 1 + dx : Q - 1 + dx]
            acc = term if acc is None else acc + term
        a = acc
        g = k - s  # ghost rings still in play
        if g:
            zero = torch.zeros((), dtype=a.dtype, device=a.device)
            a[..., :g, :] = torch.where(f[..., 0, :, :], zero, a[..., :g, :])
            a[..., -g:, :] = torch.where(f[..., 1, :, :], zero, a[..., -g:, :])
            if ghost:
                a[..., :, :g] = torch.where(f[..., 2, :, :], zero, a[..., :, :g])
                a[..., :, -g:] = torch.where(f[..., 3, :, :], zero, a[..., :, -g:])
    return a


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("stencil_stream2d")
    lib.ts_stream2d.argtypes = [_P] * 7 + [_I] * 7 + [_P, _P, _P, _P]
    lib.ts_stream2d.restype = _I
    return lib


def _launch(core, a_top, a_bot, gl, gr, flags, coeffs, k) -> torch.Tensor:
    name = "nine_point_streamed_2d"
    for t in (core, a_top, a_bot) + ((gl, gr) if gl is not None else ()):
        check_cuda(t, name, 2)
    H, W = core.shape[-2:]
    out = torch.empty_like(core)
    nb = core.numel() // (H * W)
    tile = trapezoid_tile(smem_optin(_lib(), name), k, name)
    ghost = gl is not None
    with torch.cuda.device(core.device):
        check_status(_lib(), _lib().ts_stream2d(
            core.data_ptr(), a_top.data_ptr(), a_bot.data_ptr(),
            gl.data_ptr() if ghost else None, gr.data_ptr() if ghost else None,
            flags.data_ptr(), out.data_ptr(), nb, H, W, k, int(ghost), tile,
            *taps_args(stream_taps(coeffs)), stream_of(core),
        ), name)
    return out


def nine_point_streamed_2d(
    core: torch.Tensor,
    a_top: torch.Tensor,
    a_bot: torch.Tensor,
    core_shape: tuple[int, int],
    coeffs,
    depth: int,
    band: int | None = None,
    budget_bytes: int = _VMEM_CEILING,
    open_flags=None,
    gl: torch.Tensor | None = None,
    gr: torch.Tensor | None = None,
) -> torch.Tensor:
    """``depth`` 5/9-point Jacobi substeps of ``(…, H, W)`` cores in ONE
    launch (see the module docstring for the modes).

    ``a_top``/``a_bot``: ``(…, depth, W)`` ghost-row slabs. ``band`` and
    ``budget_bytes`` size the TPU kernel's VMEM row bands and are accepted
    for its signature: the CUDA kernel tiles the core in 2D blocks, so the
    TPU's refusals of ``H % 8``, of bands that are not 8-multiple divisors
    and of VMEM budgets are gone. Kept: ``depth >= 1``, ``depth <= H``
    (the slabs are the neighbours' last ``depth`` rows), ``W >= 3`` and,
    in ghost mode, ``depth <= W``.
    """
    H, W = core_shape
    k = depth
    lead = tuple(core.shape[:-2])
    if tuple(core.shape[-2:]) != tuple(core_shape):
        raise ValueError(f"core {tuple(core.shape)} != {core_shape}")
    if tuple(a_top.shape) != lead + (k, W) or tuple(a_bot.shape) != lead + (k, W):
        raise ValueError(
            f"ghost slabs must be {lead + (k, W)}, got "
            f"{tuple(a_top.shape)}/{tuple(a_bot.shape)}"
        )
    if (gl is None) != (gr is None):
        raise ValueError("gl and gr must be given together")
    ghost_x = gl is not None
    want = lead + (H + 2 * k, k)
    if ghost_x and (tuple(gl.shape) != want or tuple(gr.shape) != want):
        raise ValueError(
            f"ghost-column slabs must be {want}, got {tuple(gl.shape)}/{tuple(gr.shape)}"
        )
    if k < 1:
        raise ValueError(f"depth must be >= 1, got {k}")
    weight_grid(coeffs)
    if band is not None and band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if k > H:
        raise ValueError(f"depth {k} > core height {H}")
    if W < 3:
        raise ValueError(f"W must be >= 3, got {W}")
    if ghost_x and k > W:
        raise ValueError(f"depth {k} > core width {W} in ghost mode")
    flags = _flags(open_flags, lead, core.device)
    if route(core, "nine_point_streamed_2d"):
        contig = [t.contiguous() if t is not None else None for t in (core, a_top, a_bot, gl, gr)]
        out = _launch(*contig, flags, coeffs, k)
        nine_point_streamed_2d.launches += 1
        return out
    return nine_point_streamed_2d_plain(core, a_top, a_bot, coeffs, k, flags, gl, gr)


#: The kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (nine_point_streamed_2d,)
reset_launches, launch_counts = counters(WRAPPERS)
