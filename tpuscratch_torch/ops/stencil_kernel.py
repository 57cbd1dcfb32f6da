"""Wrappers of the hand-written one-step stencil kernels (``csrc/stencil2d.cu``,
``csrc/stencil3d.cu``).

Each public wrapper keeps the name and contract of its Pallas twin in
``tpuscratch.ops.stencil_kernel`` and works on a padded tile or on the
stacked ``(rows, cols, ph, pw)`` tensor (any leading dims are a batch):

- ``five_point_pallas`` / ``five_point_blocked``: one 5-point step in one
  launch that writes the fresh padded tile (the new core inside the
  input's halo ring), on the plan ``five_plan`` picks; on the CPU the
  plain core and ``rebuild``.
- ``deep_trapezoid_pallas``: ``substeps`` shrinking steps in one launch
  of the row march (``csrc/stencil_taps.cuh``; a chain of launches past
  32 substeps).
- ``resident_periodic_pallas``: ``steps`` periodic steps in one
  cooperative launch, folded into rounds of up to 4 steps between grid
  barriers (the ring of ``csrc/stencil_taps.cuh``).
- ``seven_point_banded_pallas`` / ``seven_point_strips_pallas`` /
  ``seven_point_assembled_pallas``: one 3D 7-point step of every rank's
  core from a padded tile, from a z-padded core and four y/x strips, or
  from the core and its six arrivals; one kernel, three input forms.

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
from tpuscratch_torch.ops.common import (
    RING_PER_SM,
    MarchPlan,
    RingPlan,
    check_cuda,
    check_status,
    library,
    march_chain,
    ring_plan,
    ring_vec,
    sm_count,
    stream_of,
)

Coeffs = tuple[float, float, float, float, float]

#: The H100's L2 as the card reports it (50 MiB). ``resident`` keeps both
#: ping-pong buffers of the grid within it.
L2_BYTES = 50 << 20

_I = ctypes.c_int
_F = ctypes.c_float
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("stencil2d")
    lib.ts_five_point.argtypes = [_P, _P] + [_I] * 7 + [_F] * 5 + [_I, _P]
    lib.ts_deep_trapezoid.argtypes = [_P, _P] + [_I] * 12 + [_F] * 5 + [_P]
    lib.ts_deep_trapezoid_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.ts_resident_periodic.argtypes = [_P, _P, _P] + [_I] * 4 + [_F] * 5 + [_I] * 3 + [_P]
    lib.ts_resident_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    for fn in (lib.ts_five_point, lib.ts_deep_trapezoid, lib.ts_deep_trapezoid_occupancy,
               lib.ts_resident_periodic, lib.ts_resident_occupancy):
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


def five_plan(pw: int, *data_ptrs: int) -> int:
    """The one-step kernel's host rule for padded rows of ``pw`` columns:
    the columns a lane loads and stores as one group a row. 4 (16 bytes)
    where every row of the tiles starts 16-byte aligned (``pw % 4 == 0``
    and every buffer 16-byte aligned), else 2 (8 bytes) where rows start
    8-byte aligned (any even pitch, such as the headline's 1026), else 1."""
    for vec in (4, 2):
        if pw % vec == 0 and all(ptr % (4 * vec) == 0 for ptr in data_ptrs):
            return vec
    return 1


def _five_point_launch(tile: torch.Tensor, layout: TileLayout, coeffs: Coeffs, name: str,
                       vec: int | None = None) -> torch.Tensor:
    """One launch of ``five_point_kernel`` over every tile of the batch:
    a fresh padded tile, ``vec`` columns a group (``five_plan``'s unless
    given)."""
    check_cuda(tile, name, 2)
    ph, pw = layout.padded_shape
    out = torch.empty_like(tile)
    vec = vec or five_plan(pw, tile.data_ptr(), out.data_ptr())
    with torch.cuda.device(tile.device):
        _check(_lib().ts_five_point(
            tile.data_ptr(), out.data_ptr(), tile.numel() // (ph * pw), ph, pw,
            layout.core_h, layout.core_w, layout.halo_y, layout.halo_x, *_coeff_args(coeffs),
            vec, stream_of(tile),
        ), name)
    return out


def five_point_pallas(tile: torch.Tensor, layout: TileLayout, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    """One Jacobi step of the padded tile(s). On the card one launch writes
    the whole fresh tile, the new core inside the input's halo ring (never
    the input); on the CPU the plain core is re-wrapped by ``rebuild``."""
    _check_five(tile, layout)
    if not _route(tile, "five_point_pallas"):
        return rebuild(tile, five_point_plain(tile, layout, coeffs), layout)
    out = _five_point_launch(tile, layout, coeffs, "five_point_pallas")
    five_point_pallas.launches += 1
    return out


def five_point_blocked(
    tile: torch.Tensor,
    layout: TileLayout,
    coeffs: Coeffs = JACOBI,
    band: int = 256,
) -> torch.Tensor:
    """The same step as ``five_point_pallas``, for cores of any size.

    ``band`` is the row-band height of the TPU kernel, which needed
    ``core_h % band == 0`` for its overlapping VMEM blocks. The CUDA kernel
    (the same launch as ``five_point_pallas``'s) cuts the padded tile into
    register tiles whatever its size, so ``band`` is only validated and
    that refusal is gone."""
    _check_five(tile, layout)
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if not _route(tile, "five_point_blocked"):
        return rebuild(tile, five_point_plain(tile, layout, coeffs), layout)
    out = _five_point_launch(tile, layout, coeffs, "five_point_blocked")
    five_point_blocked.launches += 1
    return out


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


def trapezoid_c9(coeffs) -> tuple[float, ...]:
    """The 5-point coefficients (n, s, w, e, c) by tap position p = 3 (dy +
    1) + (dx + 1), as the row march takes them."""
    cn, cs, cw, ce, cc = _coeff_args(coeffs)
    return (0.0, cn, 0.0, cw, cc, ce, 0.0, cs, 0.0)


#: The taps the deep trapezoid sums whatever the coefficients (``TRAP_TAPS``
#: of ``csrc/stencil2d.cu``, by tap position): all five, n, w, c, e, s,
#: because the reference's ``shrink_step`` adds every term (0.0 * a
#: included, which makes the sign of a zero sum and turns an infinite input
#: into NaN). Not ``march_mask``, which drops zero coefficients, as the
#: streamed and DMA kernels' references do.
TRAPEZOID_TAPS = 0x0BA


@functools.lru_cache(maxsize=None)
def _trapezoid_per_sm(device: int, levels: int, warps: int) -> int:
    lib = _lib()
    per_sm = _I(0)
    with torch.cuda.device(device):
        _check(lib.ts_deep_trapezoid_occupancy(levels, warps, ctypes.byref(per_sm)),
               "deep_trapezoid_pallas")
    return per_sm.value


def _trapezoid_call(x: torch.Tensor, out: torch.Tensor, off: int, coeffs,
                    plan: MarchPlan) -> None:
    """One launch of ``plan.depth`` substeps of the batch ``x`` (``(..., ih,
    iw)``) into ``out`` (``(..., oh, ow)``): output (i, c) is the pyramid's
    value at input (i + off, c + off)."""
    ih, iw = x.shape[-2:]
    oh, ow = out.shape[-2:]
    c5 = _coeff_args(coeffs)
    vin = iw % 4 == 0 and off % 4 == 0 and x.data_ptr() % 16 == 0
    vout = ow % 4 == 0 and out.data_ptr() % 16 == 0
    _check(_lib().ts_deep_trapezoid(
        x.data_ptr(), out.data_ptr(), x.numel() // (ih * iw), ih, iw, oh, ow, off, plan.depth,
        plan.levels, plan.rows, plan.width, int(vin), int(vout), *c5, stream_of(x),
    ), "deep_trapezoid_pallas")
    deep_trapezoid_pallas.launches += 1


def deep_trapezoid_pallas(
    tile: torch.Tensor,
    layout: TileLayout,
    substeps: int,
    coeffs: Coeffs = JACOBI,
    budget_bytes: int = 2 << 20,
) -> torch.Tensor:
    """``substeps`` Jacobi steps of the padded tile(s) in one launch of the
    row march (``csrc/stencil2d.cu``): each block reads its window's rows
    once, runs the shrinking valid-region pyramid with its levels in
    registers and writes its strip of the core once.

    Requires halo_y == halo_x >= substeps (the caller's exchange must have
    filled a halo at least ``substeps`` deep). ``budget_bytes`` is the TPU
    kernel's VMEM band budget, accepted for its signature; the plan comes
    from ``march_plan``. Pyramids deeper than one launch runs (32
    substeps) are chained (:func:`march_chain`): each launch writes the
    dense grid of the core and the rings still to go, which the next reads.
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
    dev = tile.device.index if tile.device.index is not None else torch.cuda.current_device()
    nb = tile.numel() // (tile.shape[-2] * tile.shape[-1])
    h, w = layout.core_h, layout.core_w
    x, g, left = tile, k, substeps  # the core sits at offset g of x; left substeps to go
    with torch.cuda.device(tile.device):
        for plan in march_chain(nb, h, w, substeps, sm_count(dev),
                                lambda lv, wp: _trapezoid_per_sm(dev, lv, wp)):
            left -= plan.depth  # the rings the launch's output keeps around the core
            out = torch.empty(tile.shape[:-2] + (h + 2 * left, w + 2 * left), dtype=tile.dtype,
                              device=tile.device)
            _trapezoid_call(x, out, g - left, coeffs, plan)
            x, g = out, left
    return x


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


#: The resident kernel's sums (``ring::NSWEC``, ``NSWE``, ``SYM`` of
#: ``csrc/stencil_taps.cuh``): n, s, w, e, c; n, s, w, e; cn*((n+s)+(w+e))
NSWEC, NSWE, SYM = 0, 1, 2


def resident_comb(coeffs) -> int:
    """The sum the resident kernel takes for ``coeffs``: the reference's
    symmetric form for symmetric Jacobi, else n, s, w, e with the centre
    term only where it is not 0 (``_resident_step``)."""
    cn, cs, cw, ce, cc = _coeff_args(coeffs)
    if cn == cs == cw == ce and cc == 0.0:
        return SYM
    return NSWEC if cc else NSWE


def resident_plan(H: int, W: int, steps: int, n_sm: int, per_sm: int = RING_PER_SM,
                  fold: int | None = None) -> RingPlan:
    """The resident kernel's host rule: the ring kernels' (``ring_plan``)
    over the one-rank torus of the (H, W) grid."""
    return ring_plan(1, 1, H, W, steps, n_sm, per_sm, fold)


@functools.lru_cache(maxsize=None)
def _resident_per_sm(device: int, vec: int, comb: int) -> int:
    lib = _lib()
    per_sm = _I(0)
    with torch.cuda.device(device):
        _check(lib.ts_resident_occupancy(vec, comb, ctypes.byref(per_sm)),
               "resident_periodic_pallas")
    return per_sm.value


def _resident_launch(core: torch.Tensor, steps: int, coeffs, plan_of) -> torch.Tensor:
    """``steps`` steps of ``core`` on the card under the plan
    ``plan_of(per_sm)`` gives; returns the buffer the last round wrote."""
    bufs = (torch.empty_like(core), torch.empty_like(core))
    H, W = core.shape
    vec = ring_vec(W, core.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr())
    comb = resident_comb(coeffs)
    dev = core.device.index if core.device.index is not None else torch.cuda.current_device()
    plan = plan_of(_resident_per_sm(dev, vec, comb))
    with torch.cuda.device(core.device):
        _check(_lib().ts_resident_periodic(
            core.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), H, W, steps, comb,
            *_coeff_args(coeffs), vec, plan.fold, plan.blocks, stream_of(core),
        ), "resident_periodic_pallas")
    resident_periodic_pallas.launches += 1
    return bufs[(plan.rounds - 1) % 2]


def resident_periodic_pallas(
    core: torch.Tensor,
    steps: int,
    coeffs: Coeffs = JACOBI,
    unroll: int = 8,
    l2_limit_bytes: int = L2_BYTES,
) -> torch.Tensor:
    """``steps`` periodic Jacobi steps in ONE cooperative kernel launch.

    The grid is read once and the final state written once; the steps in
    between run in rounds of up to 4 steps (:func:`resident_plan`), a grid
    barrier between rounds, the rounds ping-ponging two grid-sized buffers
    that stay in the card's L2. Capacity rule, the refusal sized for this
    design: both buffers must fit the L2, ``2 * grid bytes <=
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
    dev = core.device.index if core.device.index is not None else torch.cuda.current_device()
    return _resident_launch(core, steps, coeffs,
                            lambda per_sm: resident_plan(*core.shape, steps, sm_count(dev), per_sm))


# ---------------------------------------------------------------------------
# the one-step 3D 7-point kernels (csrc/stencil3d.cu)

#: The JAX package's default VMEM budget, accepted for its signatures.
_VMEM_CEILING = 100 << 20

_PADDED, _STRIPS, _ASM = 0, 1, 2                  # where the ghosts live
_NO_CENTRE, _CENTRE_FIRST, _CENTRE_LAST = 0, 1, 2  # where the centre term stands


@functools.lru_cache(maxsize=None)
def _lib3d() -> ctypes.CDLL:
    lib = library("stencil3d")
    lib.ts_seven_point3d.argtypes = [_I] + [_P] * 8 + [_F, _P] + [_I] * 5 + [_P, _P]
    lib.ts_seven_point3d.restype = _I
    return lib


def _coeffs7(coeffs7) -> tuple:
    if len(coeffs7) != 7:
        raise ValueError(f"7-point coeffs (6 faces + centre) expected, got {len(coeffs7)}")
    return tuple(float(c) for c in coeffs7)


def _launch3d(mode, a, arrivals, fterm, fc, core_shape, centre, w, name) -> torch.Tensor:
    """Launch ``seven_point3d_kernel`` over every rank of the batch.
    ``arrivals`` = (mz, pz, my, py, mx, px), None where the mode has none;
    the six faces are summed in -z, +z, -y, +y, -x, +x order with the
    centre term where ``centre`` says."""
    cz, cy, cx = core_shape
    tensors = [a, *arrivals, fterm]
    for t in tensors:
        if t is not None:
            check_cuda(t, name, 3)
    lead = a.shape[:-3]
    out = torch.empty(lead + (cz, cy, cx), dtype=a.dtype, device=a.device)
    nb = out.numel() // (cz * cy * cx)
    with torch.cuda.device(a.device):
        check_status(_lib3d(), _lib3d().ts_seven_point3d(
            mode, *(None if t is None else t.data_ptr() for t in tensors), float(fc),
            out.data_ptr(), nb, cz, cy, cx, centre, (ctypes.c_float * 7)(*w), stream_of(a),
        ), name)
    return out


def _contig(*ts):
    return [None if t is None else t.contiguous() for t in ts]


def seven_point_banded_plain(padded: torch.Tensor, coeffs7) -> torch.Tensor:
    """The new core of one 7-point step of padded tile(s) (plain torch, in
    the kernel's order: the centre term first, left out when it is 0)."""
    w = _coeffs7(coeffs7)
    cz, cy, cx = (n - 2 for n in padded.shape[-3:])
    sl = lambda dz, dy, dx: padded[  # noqa: E731
        ..., 1 + dz : 1 + dz + cz, 1 + dy : 1 + dy + cy, 1 + dx : 1 + dx + cx]
    faces = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    new = w[6] * sl(0, 0, 0) if w[6] else None
    for d, c in zip(faces, w[:6]):
        term = c * sl(*d)
        new = term if new is None else new + term
    return new


def seven_point_banded_pallas(
    padded: torch.Tensor,
    core_shape: tuple[int, int, int],
    coeffs7,
    budget_bytes: int = _VMEM_CEILING,
) -> torch.Tensor:
    """7-point update of ``(…, cz+2, cy+2, cx+2)`` padded tile(s); emits
    only the new core(s). ``budget_bytes`` sized the TPU kernel's z bands
    and is accepted for its signature: the CUDA kernel tiles any core."""
    cz, cy, cx = core_shape
    if tuple(padded.shape[-3:]) != (cz + 2, cy + 2, cx + 2):
        raise ValueError(
            f"padded {tuple(padded.shape)} != core {core_shape} + 1-ghost ring")
    w = _coeffs7(coeffs7)
    if not _route(padded, "seven_point_banded_pallas"):
        return seven_point_banded_plain(padded, w)
    out = _launch3d(_PADDED, padded.contiguous(), (None,) * 6, None, 0.0, core_shape,
                    _CENTRE_FIRST if w[6] else _NO_CENTRE, w, "seven_point_banded_pallas")
    seven_point_banded_pallas.launches += 1
    return out


def seven_point_strips_plain(zpad, a_my, a_py, a_mx, a_px, coeffs7) -> torch.Tensor:
    """One 7-point step from the z-padded core(s) and the four y/x strips
    (plain torch, in the kernel's order: the six faces, then the centre
    when it is not 0)."""
    w = _coeffs7(coeffs7)
    c = zpad[..., 1:-1, :, :]
    up_z, dn_z = zpad[..., :-2, :, :], zpad[..., 2:, :, :]
    ym = torch.cat([a_my, c[..., :, :-1, :]], dim=-2)
    yp = torch.cat([c[..., :, 1:, :], a_py], dim=-2)
    xm = torch.cat([a_mx, c[..., :, :, :-1]], dim=-1)
    xp = torch.cat([c[..., :, :, 1:], a_px], dim=-1)
    out = (w[0] * up_z + w[1] * dn_z + w[2] * ym + w[3] * yp
           + w[4] * xm + w[5] * xp)
    return out + w[6] * c if w[6] else out


def _check_strips(lead, core_shape, a_my, a_py, a_mx, a_px) -> None:
    cz, cy, cx = core_shape
    for name, t, want in (("a_my", a_my, (cz, 1, cx)), ("a_py", a_py, (cz, 1, cx)),
                          ("a_mx", a_mx, (cz, cy, 1)), ("a_px", a_px, (cz, cy, 1))):
        if t is not None and tuple(t.shape) != tuple(lead) + want:
            raise ValueError(f"{name} {tuple(t.shape)} != {tuple(lead) + want}")


def seven_point_strips_pallas(
    zpad: torch.Tensor,
    a_my: torch.Tensor,
    a_py: torch.Tensor,
    a_mx: torch.Tensor,
    a_px: torch.Tensor,
    core_shape: tuple[int, int, int],
    coeffs7,
    budget_bytes: int = _VMEM_CEILING,
) -> torch.Tensor:
    """7-point update from the ``(…, cz+2, cy, cx)`` z-padded core(s), the
    ``(…, cz, 1, cx)`` y strips and the ``(…, cz, cy, 1)`` x strips: the
    kernel reads a ghost row or column straight from its strip.
    ``budget_bytes`` is accepted for the TPU kernel's signature."""
    cz, cy, cx = core_shape
    if tuple(zpad.shape[-3:]) != (cz + 2, cy, cx):
        raise ValueError(f"zpad {tuple(zpad.shape)} != core {core_shape} + 2 z planes")
    _check_strips(zpad.shape[:-3], core_shape, a_my, a_py, a_mx, a_px)
    w = _coeffs7(coeffs7)
    if not _route(zpad, "seven_point_strips_pallas"):
        return seven_point_strips_plain(zpad, a_my, a_py, a_mx, a_px, w)
    zpad, *strips = _contig(zpad, a_my, a_py, a_mx, a_px)
    out = _launch3d(_STRIPS, zpad, (None, None, *strips), None, 0.0, core_shape,
                    _CENTRE_LAST if w[6] else _NO_CENTRE, w, "seven_point_strips_pallas")
    seven_point_strips_pallas.launches += 1
    return out


def seven_point_assembled_plain(core, a_mz, a_pz, a_my, a_py, a_mx, a_px, coeffs7,
                                fterm=None, fc: float = 0.0) -> torch.Tensor:
    """One 7-point step from the core(s) and the six arrivals (plain torch,
    in the kernel's order: all seven terms w0..w6, then ``fc * fterm``). A
    ``None`` strip pair means that axis self-wraps: the ghost line is the
    core's own far line."""
    w = _coeffs7(coeffs7)
    c = core
    if a_my is None:
        a_my, a_py = c[..., :, -1:, :], c[..., :, :1, :]
    if a_mx is None:
        a_mx, a_px = c[..., :, :, -1:], c[..., :, :, :1]
    up = torch.cat([a_mz, c[..., :-1, :, :]], dim=-3)
    dn = torch.cat([c[..., 1:, :, :], a_pz], dim=-3)
    ym = torch.cat([a_my, c[..., :, :-1, :]], dim=-2)
    yp = torch.cat([c[..., :, 1:, :], a_py], dim=-2)
    xm = torch.cat([a_mx, c[..., :, :, :-1]], dim=-1)
    xp = torch.cat([c[..., :, :, 1:], a_px], dim=-1)
    out = (w[0] * up + w[1] * dn + w[2] * ym + w[3] * yp
           + w[4] * xm + w[5] * xp + w[6] * c)
    return out if fterm is None else out + fc * fterm


def seven_point_assembled_pallas(
    core: torch.Tensor,
    a_mz: torch.Tensor,
    a_pz: torch.Tensor,
    a_my: torch.Tensor | None,
    a_py: torch.Tensor | None,
    a_mx: torch.Tensor | None,
    a_px: torch.Tensor | None,
    core_shape: tuple[int, int, int],
    coeffs7,
    budget_bytes: int = _VMEM_CEILING,
    fterm: torch.Tensor | None = None,
    fc: float = 0.0,
) -> torch.Tensor:
    """7-point update assembled inside the kernel: nothing is built
    outside. ``a_mz``/``a_pz`` are ``(…, 1, cy, cx)`` planes; the y and x
    strips are as in ``seven_point_strips_pallas``, or ``None`` per axis
    when that axis self-wraps. ``fterm``/``fc``: the optional pointwise
    term of the TPU kernel's band update, ``fc * fterm`` added to each
    cell last. ``budget_bytes`` is accepted for the TPU kernel's signature;
    its refusal of cores under 3 cells an axis went with the band
    pipeline that needed it."""
    cz, cy, cx = core_shape
    lead = tuple(core.shape[:-3])
    if tuple(core.shape[-3:]) != tuple(core_shape):
        raise ValueError(f"core {tuple(core.shape)} != {core_shape}")
    if (a_py is None) != (a_my is None) or (a_px is None) != (a_mx is None):
        raise ValueError("strip inputs must be present or absent per axis")
    for name, t in (("a_mz", a_mz), ("a_pz", a_pz)):
        if tuple(t.shape) != lead + (1, cy, cx):
            raise ValueError(f"{name} {tuple(t.shape)} != {lead + (1, cy, cx)}")
    _check_strips(lead, core_shape, a_my, a_py, a_mx, a_px)
    if fterm is not None and tuple(fterm.shape) != tuple(core.shape):
        raise ValueError(f"fterm {tuple(fterm.shape)} != core {tuple(core.shape)}")
    w = _coeffs7(coeffs7)
    if not _route(core, "seven_point_assembled_pallas"):
        return seven_point_assembled_plain(core, a_mz, a_pz, a_my, a_py, a_mx, a_px, w,
                                           fterm, fc)
    core, *rest = _contig(core, a_mz, a_pz, a_my, a_py, a_mx, a_px, fterm)
    out = _launch3d(_ASM, core, rest[:6], rest[6], fc, core_shape, _CENTRE_LAST, w,
                    "seven_point_assembled_pallas")
    seven_point_assembled_pallas.launches += 1
    return out


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (
    five_point_pallas,
    five_point_blocked,
    deep_trapezoid_pallas,
    resident_periodic_pallas,
    seven_point_banded_pallas,
    seven_point_strips_pallas,
    seven_point_assembled_pallas,
)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
