"""Wrappers of the hand-written 2D stencil kernels (``csrc/stencil2d.cu``).

Each public wrapper keeps the name and contract of its Pallas twin in
``tpuscratch.ops.stencil_kernel`` and works on a padded tile or on the
stacked ``(rows, cols, ph, pw)`` tensor (any leading dims are a batch):

- ``five_point_pallas`` / ``five_point_blocked``: one 5-point step; the
  kernel writes a fresh core and ``rebuild`` re-wraps the halo.
- ``deep_trapezoid_pallas``: ``substeps`` shrinking steps in one launch
  (temporal blocking in shared memory).
- ``resident_periodic_pallas``: ``steps`` periodic steps in one
  cooperative launch.

On a CUDA tensor a wrapper launches its kernel on the current stream (or
raises); on a CPU tensor it runs the kernel's plain torch version, which
is also what the card-side checks compare the kernel with. Each wrapper
counts its launches in its ``launches`` attribute, a plain integer that
grows by one per kernel launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import JACOBI, _new_values, rebuild, shrink_step
from tpuscratch_torch.ops.common import check_cuda, library, smem_optin, stream_of

Coeffs = tuple[float, float, float, float, float]

#: The H100's L2 as the card reports it (50 MiB). ``resident`` keeps both
#: ping-pong buffers of the grid within it.
L2_BYTES = 50 << 20

#: Output tile edge of one ``deep_trapezoid`` block.
TRAPEZOID_TILE = 64

_I = ctypes.c_int
_F = ctypes.c_float
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("stencil2d")
    lib.ts_five_point.argtypes = [_P, _P] + [_I] * 7 + [_F] * 5 + [_P]
    lib.ts_deep_trapezoid.argtypes = [_P, _P] + [_I] * 8 + [_F] * 5 + [_P]
    lib.ts_resident_periodic.argtypes = [_P, _P, _P] + [_I] * 4 + [_F] * 5 + [_P]
    for fn in (lib.ts_five_point, lib.ts_deep_trapezoid, lib.ts_resident_periodic):
        fn.restype = _I
    lib.ts_error_string.argtypes = [_I]
    lib.ts_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().ts_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _route(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _coeff_args(coeffs) -> list[float]:
    if len(coeffs) != 5:
        raise ValueError(f"5-point coeffs expected, got {len(coeffs)}")
    return [float(c) for c in coeffs]


# ---------------------------------------------------------------------------
# five_point


def five_point_plain(tile: torch.Tensor, layout: TileLayout, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    """The new core of one 5-point step (plain torch; ``five_point``'s
    arithmetic in its order)."""
    return _new_values(tile, 0, layout.core_h, 0, layout.core_w, layout, coeffs)


def _check_five(tile: torch.Tensor, layout: TileLayout) -> None:
    if layout.halo_y < 1 or layout.halo_x < 1:
        raise ValueError("five_point needs halo >= 1 on both axes")
    if tuple(tile.shape[-2:]) != layout.padded_shape:
        raise ValueError(f"tile {tuple(tile.shape)} != padded {layout.padded_shape}")


def _five_point_core(tile: torch.Tensor, layout: TileLayout, coeffs: Coeffs, name: str) -> torch.Tensor:
    """Launch ``five_point_kernel`` over every tile of the batch."""
    check_cuda(tile, name, 2)
    ph, pw = layout.padded_shape
    h, w = layout.core_h, layout.core_w
    out = torch.empty(tile.shape[:-2] + (h, w), dtype=tile.dtype, device=tile.device)
    nb = tile.numel() // (ph * pw)
    with torch.cuda.device(tile.device):
        _check(_lib().ts_five_point(
            tile.data_ptr(), out.data_ptr(), nb, ph, pw, h, w,
            layout.halo_y, layout.halo_x, *_coeff_args(coeffs), stream_of(tile),
        ), name)
    return out


def five_point_pallas(tile: torch.Tensor, layout: TileLayout, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    """One Jacobi step of the padded tile(s). The kernel emits ONLY the new
    core (a fresh buffer); ``rebuild`` re-wraps the halo border."""
    _check_five(tile, layout)
    if _route(tile, "five_point_pallas"):
        core = _five_point_core(tile, layout, coeffs, "five_point_pallas")
        five_point_pallas.launches += 1
    else:
        core = five_point_plain(tile, layout, coeffs)
    return rebuild(tile, core, layout)


def five_point_blocked(
    tile: torch.Tensor,
    layout: TileLayout,
    coeffs: Coeffs = JACOBI,
    band: int = 256,
) -> torch.Tensor:
    """The same step as ``five_point_pallas``, for cores of any size.

    ``band`` is the row-band height of the TPU kernel, which needed
    ``core_h % band == 0`` for its overlapping VMEM blocks. The CUDA kernel
    tiles the core into 2D thread blocks whatever its size, so ``band`` is
    only validated and that refusal is gone."""
    _check_five(tile, layout)
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if _route(tile, "five_point_blocked"):
        core = _five_point_core(tile, layout, coeffs, "five_point_blocked")
        five_point_blocked.launches += 1
    else:
        core = five_point_plain(tile, layout, coeffs)
    return rebuild(tile, core, layout)


# ---------------------------------------------------------------------------
# deep_trapezoid


def deep_trapezoid_plain(tile: torch.Tensor, layout: TileLayout, substeps: int, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    """``substeps`` shrink steps of the padded tile(s), cropped to the core
    (plain torch; the shrink_step pyramid in its order)."""
    a = tile
    for _ in range(substeps):
        a = shrink_step(a, coeffs)
    crop = layout.halo_y - substeps
    return a[..., crop:-crop, crop:-crop] if crop else a


@functools.lru_cache(maxsize=None)
def _max_substeps(tile_edge: int) -> int:
    """Most substeps one ``deep_trapezoid`` launch can hold in the card's
    opt-in shared memory: 2 * (tile_edge + 2s)^2 floats."""
    optin = smem_optin(_lib(), "deep_trapezoid_pallas")
    s = 0
    while 2 * (tile_edge + 2 * (s + 1)) ** 2 * 4 <= optin:
        s += 1
    if s < 1:
        raise RuntimeError(f"shared memory {optin} B holds no trapezoid")
    return s


def _trapezoid_launch(x, oh, ow, off, steps, coeffs, name) -> torch.Tensor:
    ih, iw = x.shape[-2:]
    out = torch.empty(x.shape[:-2] + (oh, ow), dtype=x.dtype, device=x.device)
    nb = x.numel() // (ih * iw)
    with torch.cuda.device(x.device):
        _check(_lib().ts_deep_trapezoid(
            x.data_ptr(), out.data_ptr(), nb, ih, iw, oh, ow, off, steps,
            TRAPEZOID_TILE, *_coeff_args(coeffs), stream_of(x),
        ), name)
    return out


def deep_trapezoid_pallas(
    tile: torch.Tensor,
    layout: TileLayout,
    substeps: int,
    coeffs: Coeffs = JACOBI,
    budget_bytes: int = 2 << 20,
) -> torch.Tensor:
    """``substeps`` Jacobi steps of the padded tile(s) in one launch: each
    block reads its window once, runs the shrinking valid-region pyramid
    in shared memory and writes its core tile once.

    Requires halo_y == halo_x >= substeps (the caller's exchange must have
    filled a halo at least ``substeps`` deep). ``budget_bytes`` is the TPU
    kernel's VMEM band budget, accepted for its signature; the CUDA kernel
    sizes its blocks from the card's shared memory. Pyramids deeper than
    one block's shared memory holds (more than ~50 substeps) run as
    several launches, each a shallower trapezoid of the previous output.
    """
    k = layout.halo_y
    if layout.halo_y != layout.halo_x:
        raise ValueError("square halo required")
    if not (1 <= substeps <= k):
        raise ValueError(f"substeps {substeps} must be in [1, halo {k}]")
    if tuple(tile.shape[-2:]) != layout.padded_shape:
        raise ValueError(f"tile {tuple(tile.shape)} != padded {layout.padded_shape}")
    if not _route(tile, "deep_trapezoid_pallas"):
        return deep_trapezoid_plain(tile, layout, substeps, coeffs)
    check_cuda(tile, "deep_trapezoid_pallas", 2)
    most = _max_substeps(TRAPEZOID_TILE)
    x, left, g = tile, substeps, k  # the core sits at offset g of x
    while left > most:
        ih, iw = x.shape[-2:]
        x = _trapezoid_launch(x, ih - 2 * most, iw - 2 * most, most, most,
                              coeffs, "deep_trapezoid_pallas")
        deep_trapezoid_pallas.launches += 1
        left, g = left - most, g - most
    out = _trapezoid_launch(x, layout.core_h, layout.core_w, g, left, coeffs,
                            "deep_trapezoid_pallas")
    deep_trapezoid_pallas.launches += 1
    return out


# ---------------------------------------------------------------------------
# resident_periodic


def _resident_step(a: torch.Tensor, coeffs: Coeffs) -> torch.Tensor:
    """One periodic 5-point update of a whole (unpadded) grid via rolls."""
    cn, cs, cw, ce, cc = coeffs
    if cn == cs == cw == ce and cc == 0.0:
        return cn * (
            (torch.roll(a, 1, 0) + torch.roll(a, -1, 0))
            + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1))
        )
    out = (
        cn * torch.roll(a, 1, 0)
        + cs * torch.roll(a, -1, 0)
        + cw * torch.roll(a, 1, 1)
        + ce * torch.roll(a, -1, 1)
    )
    return out + cc * a if cc else out


def resident_periodic_plain(core: torch.Tensor, steps: int, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    """``steps`` periodic steps of the grid (plain torch, rolls)."""
    a = core
    for _ in range(steps):
        a = _resident_step(a, coeffs)
    return a.clone() if a is core else a


def resident_periodic_pallas(
    core: torch.Tensor,
    steps: int,
    coeffs: Coeffs = JACOBI,
    unroll: int = 8,
    l2_limit_bytes: int = L2_BYTES,
) -> torch.Tensor:
    """``steps`` periodic Jacobi steps in ONE cooperative kernel launch.

    The grid is read once and the final state written once; the steps in
    between ping-pong two grid-sized buffers that stay in the card's L2,
    with a grid-wide barrier per step. Capacity rule, the refusal sized for
    this design: both buffers must fit the L2, ``2 * grid bytes <=
    l2_limit_bytes`` (50 MiB: a 2560^2 f32 grid at most); larger grids
    raise ``ValueError`` and belong on the deep trapezoid path. ``unroll``
    is the TPU kernel's loop unroll, accepted for its signature.
    Single-device only: the torus wrap is internal, so there is no halo to
    exchange.
    """
    if core.ndim != 2:
        raise ValueError(f"resident stencil wants a 2D grid, got {tuple(core.shape)}")
    if steps < 0:
        raise ValueError(f"negative steps {steps}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    need = 2 * core.numel() * core.element_size()
    if need > l2_limit_bytes:
        raise ValueError(
            f"grid {tuple(core.shape)} needs {need} B for its two buffers "
            f"(> L2 limit {l2_limit_bytes} B); use the deep_trapezoid_pallas "
            "path for grids that don't fit"
        )
    if not _route(core, "resident_periodic_pallas"):
        return resident_periodic_plain(core, steps, coeffs)
    check_cuda(core, "resident_periodic_pallas", 2)
    if steps == 0:
        return core.clone()
    cn, cs, cw, ce, cc = _coeff_args(coeffs)
    sym = int(cn == cs == cw == ce and cc == 0.0)
    bufs = (torch.empty_like(core), torch.empty_like(core))
    H, W = core.shape
    with torch.cuda.device(core.device):
        _check(_lib().ts_resident_periodic(
            core.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), H, W,
            steps, sym, cn, cs, cw, ce, cc, stream_of(core),
        ), "resident_periodic_pallas")
    resident_periodic_pallas.launches += 1
    return bufs[(steps - 1) % 2]


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (
    five_point_pallas,
    five_point_blocked,
    deep_trapezoid_pallas,
    resident_periodic_pallas,
)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
