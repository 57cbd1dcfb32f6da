"""Distributed 2D and 3D FFT: local transforms + all_to_all transpose.

The twin of ``tpuscratch.parallel.fft``, with its names and layout
contracts: the pencil decomposition (FFTW-MPI / heFFTe shape) transforms
the locally-contiguous axes, globally transposes with ONE tiled
``all_to_all`` so the remaining axis becomes local, and transforms it.
Call inside ``run_spmd``: values are stacked ``(*mesh, *local)``, so every
local axis here counts from the END (a 2D block's axis 0 is dim -2, axis 1
dim -1), and the ``all_to_all`` split / concat axes are local dims.

Two transform backends, as in the JAX package:

- the complex path (``fft2_sharded``, ``fft3_sharded`` and their
  inverses) on ``torch.fft`` in complex64, where the JAX package calls
  ``jnp.fft``;
- the ``(re, im)`` pair path on float32 planes: each axis a dense DFT as
  real matrix products (``method='direct'``, N MACs an element) or the
  four-step Cooley-Tukey split N = N1*N2 into sub-DFT contractions and a
  twiddle plane (``'four-step'``, N1 + N2 MACs an element). The JAX
  package computes these products outside any Pallas kernel with
  ``precision=HIGHEST``; here they are ``torch.matmul`` / ``torch.einsum``
  in float32, and a pair transform of a CUDA tensor raises while the
  process lets cuBLAS take TF32 for float32 products (``allow_tf32``,
  ``set_float32_matmul_precision('high')`` or ``fp32_precision =
  'tf32'``): a TF32 product keeps 10 mantissa bits, ~1e-4 and more of
  relative error in a transform where float32 reads ~1e-6
  (:data:`PAIR_FFT_TOL`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import all_to_all
from tpuscratch_torch.comm.spmd import AxisName, current_mesh


def _transpose(x: torch.Tensor, axis_name: AxisName, *, to_pencil: bool) -> torch.Tensor:
    """Tiled all_to_all global transpose: row block <-> column pencil.

    ``to_pencil`` scatters the local W axis and gathers everyone's row
    blocks (source order == row-block order, so rows arrive sorted); the
    reverse move restores the row-sharded layout.
    """
    split, concat = (1, 0) if to_pencil else (0, 1)
    return all_to_all(x, axis_name, split_axis=split, concat_axis=concat, tiled=True)


def _transpose_pair(re, im, axis_name: AxisName, *, to_pencil: bool):
    """:func:`_transpose` for an (re, im) pair as ONE collective.

    The planes stack at the first LOCAL dim (after the mesh's), so the
    pair is local dim 0; ``to_pencil`` then splits the last local axis and
    gathers the leading grid axis (local dim 1), whatever the rank — the
    same helper serves the 2D (H/n, W) and 3D (Z/n, X, Y) layouts.
    """
    lead = len(current_mesh().shape)
    z = torch.stack([re, im], dim=lead)
    split, concat = (-1, 1) if to_pencil else (1, -1)
    z = all_to_all(z, axis_name, split_axis=split, concat_axis=concat, tiled=True)
    return z.select(lead, 0), z.select(lead, 1)


def fft2_sharded(
    local: torch.Tensor,
    axis_name: AxisName,
    *,
    inverse: bool = False,
    restore_layout: bool = True,
) -> torch.Tensor:
    """2D (i)FFT of a row-sharded grid over ``axis_name``.

    ``local`` is each rank's (H/n, W) row block of the global (H, W) grid,
    real or complex. Returns the same row-block layout when
    ``restore_layout`` (one extra all_to_all); otherwise the transposed
    pencil layout — an (H, W/n) column block — saving the transpose when
    the caller's next op is happy with it (e.g. a spectral multiply that
    knows its coordinates, ``solvers.spectral``).
    """
    f = torch.fft.ifft if inverse else torch.fft.fft
    y = f(local.to(torch.complex64), dim=-1)
    y = _transpose(y, axis_name, to_pencil=True)
    y = f(y, dim=-2)
    if restore_layout:
        y = _transpose(y, axis_name, to_pencil=False)
    return y


def ifft2_sharded(
    local: torch.Tensor, axis_name: AxisName, *, restore_layout: bool = True
) -> torch.Tensor:
    """Inverse of :func:`fft2_sharded` (separable, so axis order is free)."""
    return fft2_sharded(local, axis_name, inverse=True, restore_layout=restore_layout)


# ---------------------------------------------------------------------------
# Matrix-form DFT on (real, imag) float32 pairs. Forward matrix
# F[k,j] = exp(-2*pi*i*k*j/N) = C - i*S; inverse (C + i*S)/N.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of the n-point DFT angle matrix, float32 (a copy of the
    JAX package's, built in float64 numpy)."""
    k = np.arange(n, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle_tables(n1: int, n2: int, n: int):
    """(cos, sin) of W_n^(k1*j2), the four-step twiddle plane."""
    ang = 2.0 * np.pi * np.outer(
        np.arange(n1, dtype=np.float64), np.arange(n2, dtype=np.float64)
    ) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on(device: torch.device, n: int, n1: int = 0, n2: int = 0) -> tuple[torch.Tensor, ...]:
    """The DFT tables of length ``n`` (or, given ``n1`` and ``n2``, the
    twiddle plane) as tensors on ``device``, kept, so a transform repeated
    on one card moves its tables there once."""
    tables = _twiddle_tables(n1, n2, n) if n1 else _dft_tables(n)
    return tuple(torch.from_numpy(t).to(device) for t in tables)


def _dft_axis(re, im, axis: int, inverse: bool):
    """Transform local axis ``axis`` (0 or 1 of a 2D block) of the (re,
    im) pair by dense DFT products, in float32."""
    dim = axis - 2
    n = re.shape[dim]
    c, s = _on(re.device, n)
    mm = (lambda x, m: torch.matmul(x, m)) if axis == 1 else (lambda x, m: torch.matmul(m, x))
    if inverse:  # (xr + i xi)(C + iS)/n
        yr = (mm(re, c) - mm(im, s)) / n
        yi = (mm(im, c) + mm(re, s)) / n
    else:  # (xr + i xi)(C - iS)
        yr = mm(re, c) + mm(im, s)
        yi = mm(im, c) - mm(re, s)
    return yr, yi


# ---------------------------------------------------------------------------
# Four-step (Cooley-Tukey N = N1*N2) FFT on pair planes:
# x[j1*N2 + j2] -> B[k1,j2] = F_N1 @ x  (contract j1)
#              -> C = B * W_N^(k1*j2)   (twiddle)
#              -> X[k1 + N1*k2] = C @ F_N2 (contract j2), read out k2-major.
# Every multiply-add is a product of a sub-DFT matrix with the data, batched
# over the other factor (and the stacked mesh dims, the einsums' "...").
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _split(n: int):
    """(n1, n2) with n1*n2 == n, or None when n is prime/too small: n2 =
    128 from 1024 up where 128 divides n, else the balanced split (the JAX
    package's rule, so both packages run the same decomposition)."""
    if n >= 1024 and n % 128 == 0:
        return (n // 128, 128)
    return _balanced_factor(n)


def _cplx_einsum(spec: str, c, s, xr, xi, inverse: bool):
    """Complex einsum (C -+ iS) . (xr + i xi), the constant operand first
    in ``spec``. Forward uses C - iS, inverse C + iS; scaling is the
    caller's job."""
    sgn = -1.0 if inverse else 1.0
    yr = torch.einsum(spec, c, xr) + sgn * torch.einsum(spec, s, xi)
    yi = torch.einsum(spec, c, xi) - sgn * torch.einsum(spec, s, xr)
    return yr, yi


#: n1-side sub-DFT lengths at or above this are themselves four-step
#: decomposed (the "eight-step" recursion). 0 = disabled, as in the JAX
#: package; tests force it on.
EIGHT_STEP_MIN = 0


def _balanced_factor(n: int):
    """(d, n // d) with d the largest divisor <= sqrt(n), or None for a
    prime/too-small n."""
    best = None
    for d in range(2, int(n**0.5) + 1):
        if n % d == 0:
            best = d
    return (best, n // best) if best else None


def _sub_split(n1: int, min_n: int | None = None):
    """Balanced (m1, m2) factoring of the n1 side for the eight-step
    recursion, or None when n1 is below the threshold (default
    :data:`EIGHT_STEP_MIN`; 0 means never), or prime."""
    m = EIGHT_STEP_MIN if min_n is None else min_n
    if not m or n1 < m:
        return None
    return _balanced_factor(n1)


def _sub_dft_n1(xr, xi, n1: int, inverse: bool, axis: int):
    """DFT of length n1 over the n1 axis of the reshaped four-step
    tensor — (..., n1, n2) for axis 1, (..., n1, n2, w) for axis 0. Dense
    F_n1 contraction, or its own four-step split when :func:`_sub_split`
    allows (unscaled — the outer caller owns the 1/n)."""
    sub = _sub_split(n1)
    if sub is None:
        c1, s1 = _on(xr.device, n1)
        spec = "ab,...bw->...aw" if axis == 1 else "ab,...bcw->...acw"
        return _cplx_einsum(spec, c1, s1, xr, xi, inverse)
    m1, m2 = sub
    cm1, sm1 = _on(xr.device, m1)
    cm2, sm2 = _on(xr.device, m2)
    tc, ts = _on(xr.device, n1, m1, m2)
    sgn = -1.0 if inverse else 1.0
    if axis == 1:
        lead, n2 = xr.shape[:-2], xr.shape[-1]
        ur = xr.reshape(*lead, m1, m2, n2)
        ui = xi.reshape(*lead, m1, m2, n2)
        tr, ti = _cplx_einsum("pu,...uvw->...pvw", cm1, sm1, ur, ui, inverse)
        tw_r = tr * tc[:, :, None] + sgn * ti * ts[:, :, None]
        tw_i = ti * tc[:, :, None] - sgn * tr * ts[:, :, None]
        # k1 = p + m1*q: emitting (q, p) C-order seats the digits
        br, bi = _cplx_einsum("qv,...pvw->...qpw", cm2, sm2, tw_r, tw_i, inverse)
        return br.reshape(*lead, n1, n2), bi.reshape(*lead, n1, n2)
    lead, (n2, w) = xr.shape[:-3], xr.shape[-2:]
    ur = xr.reshape(*lead, m1, m2, n2, w)
    ui = xi.reshape(*lead, m1, m2, n2, w)
    tr, ti = _cplx_einsum("pu,...uvcw->...pvcw", cm1, sm1, ur, ui, inverse)
    tw_r = tr * tc[:, :, None, None] + sgn * ti * ts[:, :, None, None]
    tw_i = ti * tc[:, :, None, None] - sgn * tr * ts[:, :, None, None]
    br, bi = _cplx_einsum("qv,...pvcw->...qpcw", cm2, sm2, tw_r, tw_i, inverse)
    return br.reshape(*lead, n1, n2, w), bi.reshape(*lead, n1, n2, w)


def _four_step_axis(re, im, axis: int, inverse: bool):
    """Transform local axis ``axis`` (0 or 1 of a 2D block) of the pair by
    the four-step FFT. Requires a composite axis length (see
    :func:`_split`)."""
    dim = axis - 2
    n = re.shape[dim]
    n1, n2 = _split(n)
    c2, s2 = _on(re.device, n2)
    tc, ts = _on(re.device, n, n1, n2)
    sgn = -1.0 if inverse else 1.0

    if axis == 1:
        lead = re.shape[:-1]
        xr = re.reshape(*lead, n1, n2)
        xi = im.reshape(*lead, n1, n2)
        br, bi = _sub_dft_n1(xr, xi, n1, inverse, axis)
        # twiddle: (br + i bi) * (tc -+ i ts), broadcast over rows
        cr = br * tc + sgn * bi * ts
        ci = bi * tc - sgn * br * ts
        yr, yi = _cplx_einsum("jm,...aj->...ma", c2, s2, cr, ci, inverse)
        yr = yr.reshape(*lead, n)
        yi = yi.reshape(*lead, n)
    else:
        lead, w = re.shape[:-2], re.shape[-1]
        xr = re.reshape(*lead, n1, n2, w)
        xi = im.reshape(*lead, n1, n2, w)
        br, bi = _sub_dft_n1(xr, xi, n1, inverse, axis)
        cr = br * tc[:, :, None] + sgn * bi * ts[:, :, None]
        ci = bi * tc[:, :, None] - sgn * br * ts[:, :, None]
        yr, yi = _cplx_einsum("jm,...ajw->...maw", c2, s2, cr, ci, inverse)
        yr = yr.reshape(*lead, n, w)
        yi = yi.reshape(*lead, n, w)
    if inverse:
        yr = yr / n
        yi = yi / n
    return yr, yi


#: Axis lengths at or above this use the four-step path under
#: method="auto" (the JAX package's threshold).
FOUR_STEP_MIN = 1024


def resolve_method(n: int, method: str) -> str:
    """The single source of the method-dispatch rule: 'auto' becomes
    'four-step' for composite lengths at/above :data:`FOUR_STEP_MIN`,
    else 'direct'; an explicit 'four-step' on a prime/too-small length is
    a ValueError. ``bench.fft_bench.pair_fft_flops`` resolves through here
    too, so its FLOP count follows what runs."""
    if method == "auto":
        return "four-step" if n >= FOUR_STEP_MIN and _split(n) is not None else "direct"
    if method == "four-step" and _split(n) is None:
        raise ValueError(f"four-step needs a composite axis length >= 4, got {n}")
    if method not in ("four-step", "direct"):
        raise ValueError(f"unknown pair-FFT method {method!r}")
    return method


#: The forward pair transform against complex128, of max|want|: float32
#: products read ~1e-6 (direct: n-term sums of table products); a TF32
#: product keeps 10 mantissa bits and reads ~1e-4 and more.
PAIR_FFT_TOL = 2e-5


def tf32_products() -> bool:
    """Whether cuBLAS may run float32 products through TF32, however the
    process asked for it (the per-backend ``fp32_precision`` of torch 2.9
    on, which the legacy ``allow_tf32`` and ``set_float32_matmul_precision``
    also set; the one legacy flag before it)."""
    m = torch.backends.cuda.matmul
    p = getattr(m, "fp32_precision", None)
    if p is None:
        return bool(m.allow_tf32)
    if p == "none":  # unset for cuda matmuls: the process-wide default
        p = torch.backends.fp32_precision
    return p == "tf32"


def _require_f32_products(x: torch.Tensor) -> None:
    if x.device.type == "cuda" and tf32_products():
        raise RuntimeError(
            "the pair FFT needs full float32 products, and cuBLAS may take TF32 "
            "(10 mantissa bits) for them: set torch.backends.cuda.matmul.allow_tf32 = False "
            "(or fp32_precision = 'ieee') around the call, or use the complex path")


def _pair_axis(re, im, axis: int, inverse: bool, method: str):
    _require_f32_products(re)
    method = resolve_method(re.shape[axis - 2], method)
    if method == "four-step":
        return _four_step_axis(re, im, axis, inverse)
    return _dft_axis(re, im, axis, inverse)


def fft2_sharded_pair(
    re: torch.Tensor,
    im: torch.Tensor,
    axis_name: AxisName,
    *,
    inverse: bool = False,
    restore_layout: bool = True,
    method: str = "auto",
):
    """:func:`fft2_sharded` on (real, imag) float32 planes — no complex
    dtype. Same pencil decomposition and all_to_all transposes, each local
    transform as float32 products: ``method='direct'`` the dense DFT,
    ``'four-step'`` the N1*N2 split (needs a composite axis length),
    ``'auto'`` (default) four-step from :data:`FOUR_STEP_MIN` up. Returns
    the (re, im) pair in :func:`fft2_sharded`'s layout contract.
    """
    re, im = _pair_axis(re, im, 1, inverse, method)
    re, im = _transpose_pair(re, im, axis_name, to_pencil=True)
    re, im = _pair_axis(re, im, 0, inverse, method)
    if restore_layout:
        re, im = _transpose_pair(re, im, axis_name, to_pencil=False)
    return re, im


def ifft2_from_pencil(pencil: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """Inverse 2D FFT starting from the transposed pencil layout: the
    (H, W/n) column block :func:`fft2_sharded` returns with
    ``restore_layout=False`` back to the (H/n, W) row block — the forward
    path run backwards, saving one transpose per round trip."""
    y = torch.fft.ifft(pencil, dim=-2)
    y = _transpose(y, axis_name, to_pencil=False)
    return torch.fft.ifft(y, dim=-1)


def ifft2_from_pencil_pair(re, im, axis_name: AxisName, method: str = "auto"):
    """Pair-plane version of :func:`ifft2_from_pencil`."""
    re, im = _pair_axis(re, im, 0, True, method)
    re, im = _transpose_pair(re, im, axis_name, to_pencil=False)
    return _pair_axis(re, im, 1, True, method)


# ---------------------------------------------------------------------------
# 3D: the same pencil decomposition one dimension up. Local block is the
# z-shard (Z/n, Y, X); X and Y transform locally (last-axis reshape), ONE
# all_to_all repartitions z, and Z transforms locally in the pencil layout
# (X, Y/n, Z).
# ---------------------------------------------------------------------------


def _pair_last(re, im, inverse: bool, method: str):
    """Transform the LAST axis of an arbitrary-rank pair by flattening
    the leading dims (the mesh's too) — the whole 2D machinery, four-step
    included."""
    shape = re.shape
    yr, yi = _pair_axis(re.reshape(-1, shape[-1]), im.reshape(-1, shape[-1]),
                        1, inverse, method)
    return yr.reshape(shape), yi.reshape(shape)


def fft3_sharded_pair(
    re: torch.Tensor,
    im: torch.Tensor,
    axis_name: AxisName,
    *,
    inverse: bool = False,
    restore_layout: bool = True,
    method: str = "auto",
):
    """3D (i)FFT of a z-sharded (Z/n, Y, X) pair over ``axis_name`` (the
    complex-free path, see :func:`fft2_sharded_pair`). Returns the same
    (Z/n, Y, X) layout when ``restore_layout``; otherwise the transposed
    pencil — an (X, Y/n, Z) block whose local coordinates are (kx = all,
    ky = shard, kz = all), which is what a spectral multiply wants
    (``solvers.spectral.periodic_poisson3d_fft``)."""
    re, im = _pair_last(re, im, inverse, method)                    # X
    re, im = re.transpose(-2, -1), im.transpose(-2, -1)             # (Z/n, X, Y)
    re, im = _pair_last(re, im, inverse, method)                    # Y
    re, im = _transpose_pair(re, im, axis_name, to_pencil=True)     # (Z, X, Y/n)
    re, im = re.movedim(-3, -1), im.movedim(-3, -1)                 # (X, Y/n, Z)
    re, im = _pair_last(re, im, inverse, method)                    # Z
    if restore_layout:
        re, im = ifft3_restore_pair(re, im, axis_name)
    return re, im


def ifft3_restore_pair(re, im, axis_name: AxisName):
    """Bring an (X, Y/n, Z) pencil pair back to the (Z/n, Y, X) row layout
    (no transform — layout moves only, shared by forward-restore and the
    inverse path)."""
    re, im = re.movedim(-1, -3), im.movedim(-1, -3)                 # (Z, X, Y/n)
    re, im = _transpose_pair(re, im, axis_name, to_pencil=False)    # (Z/n, X, Y)
    return re.transpose(-2, -1), im.transpose(-2, -1)


def ifft3_from_pencil_pair(re, im, axis_name: AxisName, method: str = "auto"):
    """Inverse 3D FFT starting from the (X, Y/n, Z) pencil — the forward
    path run backwards, saving one all_to_all per round trip."""
    re, im = _pair_last(re, im, True, method)                       # Z
    re, im = re.movedim(-1, -3), im.movedim(-1, -3)                 # (Z, X, Y/n)
    re, im = _transpose_pair(re, im, axis_name, to_pencil=False)    # (Z/n, X, Y)
    re, im = _pair_last(re, im, True, method)                       # Y
    re, im = re.transpose(-2, -1), im.transpose(-2, -1)             # (Z/n, Y, X)
    return _pair_last(re, im, True, method)                         # X


def ifft3_from_pencil(pencil: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """Complex-dtype inverse 3D FFT from the (X, Y/n, Z) pencil — the
    ``torch.fft`` sibling of :func:`ifft3_from_pencil_pair`."""
    z = torch.fft.ifft(pencil, dim=-1)                              # Z
    z = z.movedim(-1, -3)                                           # (Z, X, Y/n)
    z = all_to_all(z, axis_name, split_axis=0, concat_axis=2, tiled=True)
    z = torch.fft.ifft(z, dim=-1)                                   # Y
    z = z.transpose(-2, -1)                                         # (Z/n, Y, X)
    return torch.fft.ifft(z, dim=-1)                                # X


def fft3_sharded(
    local: torch.Tensor,
    axis_name: AxisName,
    *,
    inverse: bool = False,
    restore_layout: bool = True,
) -> torch.Tensor:
    """Complex-dtype 3D (i)FFT of a z-sharded (Z/n, Y, X) block — the
    ``torch.fft`` sibling of :func:`fft3_sharded_pair`, same layout
    contract."""
    f = torch.fft.ifft if inverse else torch.fft.fft
    y = f(local.to(torch.complex64), dim=-1)                        # X
    y = y.transpose(-2, -1)                                         # (Z/n, X, Y)
    y = f(y, dim=-1)                                                # Y
    z = all_to_all(y, axis_name, split_axis=2, concat_axis=0, tiled=True)
    z = z.movedim(-3, -1)                                           # (X, Y/n, Z)
    z = f(z, dim=-1)                                                # Z
    if restore_layout:
        z = z.movedim(-1, -3)                                       # (Z, X, Y/n)
        z = all_to_all(z, axis_name, split_axis=0, concat_axis=2, tiled=True)
        z = z.transpose(-2, -1)                                     # (Z/n, Y, X)
    return z


def complex_supported() -> bool:
    """Whether the complex path may run: always, on torch (``torch.fft``
    runs complex64 on the CPU and the card), so ``impl='auto'`` takes it;
    the pair path is reached by name (``impl='dft'``)."""
    return True
