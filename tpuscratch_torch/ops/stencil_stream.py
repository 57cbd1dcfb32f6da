"""The streamed stencils: ``depth`` substeps in one pass
(``csrc/stencil_stream2d.cu``, ``csrc/stencil_stream3d.cu``).

The twin of ``tpuscratch.ops.stencil_stream``, with the same names and
contracts. ``nine_point_streamed_2d`` and ``seven_point_streamed_pallas``
take every rank's core at once: leading dims of the core and of the
slabs, strips and flags are a batch, the stacked dims of the mesh.

2D column modes, as in the JAX package: with ``gl``/``gr`` None, x
self-wraps (wrap mode, a periodic column axis); with ``gl``/``gr`` given
as ``(H + 2*depth, depth)`` ghost-column slabs spanning global rows
``[-depth, H + depth)`` (the x neighbours' edge columns with the diagonal
neighbours' corner blocks at the ends), the columns may be distributed or
open (ghost mode). ``open_flags`` marks the physical open ends [top,
bottom, left, right] of each rank; the rings still acting as ghosts on an
open side stay zero after every substep.

3D: the z ghosts are ``(depth, cy, cx)`` slabs; y and x self-wrap (z-slab
mode) or ride the ``gy``/``gx``/``gc`` ghost strips in the JAX package's
[plus | minus] layout; flags are [z-, z+, y-, y+, x-, x+]; 27 coefficients
and the ``rhs`` smoother term run in z-slab mode.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs its ``*_plain`` version, the same pyramid in torch ops in
the kernel's order of operations.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpuscratch_torch.ops.common import (
    check_cuda,
    check_status,
    counters,
    library,
    march_chain,
    march_mask,
    route,
    sm_count,
    smem_optin,
    stream_of,
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
    rows. The CUDA kernel marches strips and chunks of rows of any size
    (``ops.common.march_plan``) and takes no band; this is the JAX
    package's pure sizing rule, kept for callers that size a band."""
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
    lib.ts_stream2d.argtypes = [_P] * 7 + [_I, _P, _P, _P]
    lib.ts_stream2d.restype = _I
    lib.ts_stream2d_occupancy.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.ts_stream2d_occupancy.restype = _I
    return lib


def stream_c9(coeffs) -> tuple[float, ...]:
    """The weight grid by tap position p = 3 (dy + 1) + (dx + 1), as the
    kernel takes it."""
    return tuple(w for row in weight_grid(coeffs) for w in row)


@functools.lru_cache(maxsize=None)
def _stream_taps(coeffs: tuple) -> tuple:
    """``(c9 as a ctypes float array, template mask)`` of a coefficient set."""
    c9 = stream_c9(coeffs)
    return (ctypes.c_float * 9)(*c9), march_mask(c9)


@functools.lru_cache(maxsize=None)
def _stream2d_per_sm(device: int, levels: int, mask: int, warps: int, open_: bool) -> int:
    lib = _lib()
    per_sm = _I(0)
    with torch.cuda.device(device):
        check_status(lib, lib.ts_stream2d_occupancy(levels, mask, warps, int(open_),
                                                     ctypes.byref(per_sm)),
                     "nine_point_streamed_2d")
    return per_sm.value


def may_open(open_flags) -> bool:
    """Whether a pass's ranks may have an open end, as far as the host can
    tell without reading the card: None has none, flags held on the host
    are read, flags on the card may have one. The kernel that zeroes open
    ends runs only then (``csrc/stencil_stream2d.cu``)."""
    if open_flags is None:
        return False
    if isinstance(open_flags, torch.Tensor) and open_flags.device.type != "cpu":
        return True
    return bool(torch.as_tensor(open_flags).any())


def _launch(core, a_top, a_bot, gl, gr, flags, coeffs, k, plans=None,
            open_: bool = True) -> torch.Tensor:
    """The pass on the card: the launches of ``plans`` (the host rule's,
    :func:`march_chain`, unless given), each counted; ``open_``: the
    ranks may have open ends (:func:`may_open`)."""
    name = "nine_point_streamed_2d"
    for t in (core, a_top, a_bot) + ((gl, gr) if gl is not None else ()):
        check_cuda(t, name, 2)
    H, W = core.shape[-2:]
    lead = tuple(core.shape[:-2])
    nb = core.numel() // (H * W)
    c9_arg, mask = _stream_taps(tuple(float(c) for c in coeffs))
    dev = core.device.index if core.device.index is not None else torch.cuda.current_device()
    if plans is None:
        plans = march_chain(nb, H, W, k, sm_count(dev),
                            lambda lv, w: _stream2d_per_sm(dev, lv, mask, w, open_))
    ghost = gl is not None
    src, gi, done = core, -1, 0
    for plan in plans:
        j = plan.depth
        go = k - done - j
        out = torch.empty_like(core) if go == 0 else core.new_empty(
            lead + (H + 2 * go, W + 2 * go))
        # 16-byte groups: rows of whole groups from 16-byte aligned bases
        ins = (src, a_top, a_bot) if gi < 0 else (src,)
        vin = (W if gi < 0 else W + 2 * gi) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ins)
        vout = (W + 2 * go) % 4 == 0 and out.data_ptr() % 16 == 0
        ints = (ctypes.c_int * 14)(H, W, k, done, j, int(ghost), gi, plan.levels, mask,
                                   plan.rows, plan.width, int(vin), int(vout), int(open_))
        with torch.cuda.device(core.device):
            check_status(_lib(), _lib().ts_stream2d(
                src.data_ptr(), a_top.data_ptr(), a_bot.data_ptr(),
                gl.data_ptr() if ghost else None, gr.data_ptr() if ghost else None,
                flags.data_ptr(), out.data_ptr(), nb, ints, c9_arg, stream_of(core),
            ), name)
        nine_point_streamed_2d.launches += 1
        src, gi, done = out, go, done + j
    return src


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
    launch (see the module docstring for the modes); a pass deeper than
    ``march_depth()`` (32) substeps is chained through dense grids, a
    launch each 32.

    ``a_top``/``a_bot``: ``(…, depth, W)`` ghost-row slabs. ``band`` and
    ``budget_bytes`` size the TPU kernel's VMEM row bands and are accepted
    for its signature: the CUDA kernel marches strips and chunks of rows
    of any size, so the TPU's refusals of ``H % 8``, of bands that are not
    8-multiple divisors and of VMEM budgets are gone. Kept: ``depth >=
    1``, ``depth <= H`` (the slabs are the neighbours' last ``depth``
    rows), ``W >= 3`` and, in ghost mode, ``depth <= W``.
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
        return _launch(*contig, flags, coeffs, k, open_=may_open(open_flags))
    return nine_point_streamed_2d_plain(core, a_top, a_bot, coeffs, k, flags, gl, gr)


# ---------------------------------------------------------------------------
# the 3D kernel (csrc/stencil_stream3d.cu)

#: Substeps one ``stream3d_kernel`` launch runs at most; a deeper pass is
#: chained through dense scratch volumes (``csrc/stencil_stream3d.cu``:
#: S3_MAX_J), as are the kernel's warps a block (S3_WARPS) and input planes
#: in flight (S3_AHEAD).
STREAM3D_MAX_J, STREAM3D_WARPS, STREAM3D_AHEAD = 8, 8, 2


@dataclasses.dataclass(frozen=True)
class Stream3dPlan:
    """One ``stream3d_kernel`` launch: ``j`` substeps over (ty, tx)
    column tiles of ``zc`` output planes, ``blocks`` blocks of ``smem``
    bytes of shared memory."""

    j: int
    ty: int
    tx: int
    zc: int
    blocks: int
    smem: int


def stream3d_window(j: int) -> tuple[int, int]:
    """The (rows, columns) window of a launch of ``j`` substeps: 3 rows a
    warp of 8, and 2 columns a lane up to 4 substeps, 1 beyond."""
    return 3 * STREAM3D_WARPS, 64 if j <= 4 else 32


def stream3d_smem(nt: int, j: int) -> int:
    """Shared memory of a launch of ``j`` substeps of ``nt`` (7 or 27)
    points: the input ring and a ring of planes for each level below j
    (3 planes at 7 points, where the z taps ride in registers; 4 at 27),
    padded by a row and two cells at each end."""
    ring = 3 if nt == 7 else 4
    rows, cols = stream3d_window(j)
    pad = cols + 2  # a row and two cells before and after the planes
    return (((STREAM3D_AHEAD + ring - 1) + ring * (j - 1)) * rows * cols + 2 * pad) * 4


def stream3d_depth(optin: int, nt: int) -> int:
    """The most substeps one launch runs within ``optin`` bytes of shared
    memory a block (0: none fits)."""
    return max((j for j in range(1, STREAM3D_MAX_J + 1) if stream3d_smem(nt, j) <= optin),
               default=0)


def stream3d_plan(out_shape, nb: int, j: int, nt: int, n_sm: int, per_sm: int) -> Stream3dPlan:
    """The launch of ``j`` substeps writing ``nb`` volumes of ``out_shape``
    (OZ, OY, OX): the tile is the window less its apron, and the z chunk
    the one whose blocks, ``per_sm`` an SM on ``n_sm`` SMs, take the
    fewest waves times march steps a block (a chunk's zc planes plus its
    2j-plane apron)."""
    OZ, OY, OX = out_shape
    rows, cols = stream3d_window(j)
    ty, tx = rows - 2 * j, cols - 2 * j
    tiles = nb * -(-OY // ty) * -(-OX // tx)
    slots = n_sm * per_sm
    best = None
    for chunks in range(1, OZ + 1):
        zc = -(-OZ // chunks)
        blocks = tiles * -(-OZ // zc)
        cost = -(-blocks // slots) * (zc + 2 * j)
        if best is None or cost < best[0]:
            best = (cost, zc, blocks)
    _, zc, blocks = best
    return Stream3dPlan(j, ty, tx, zc, blocks, stream3d_smem(nt, j))


def weight_cube(coeffs27, offsets26) -> tuple:
    """OFFSETS26-ordered coefficients (+ centre last) as a nested
    (3, 3, 3) tuple W[dz+1][dy+1][dx+1]."""
    W = [[[0.0] * 3 for _ in range(3)] for _ in range(3)]
    for (dz, dy, dx), cw in zip(offsets26, coeffs27[:-1]):
        W[dz + 1][dy + 1][dx + 1] = float(cw)
    W[1][1][1] = float(coeffs27[-1])
    return tuple(tuple(tuple(r) for r in p) for p in W)


def stream_band(cz: int, cy: int, cx: int, depth: int, itemsize: int,
                nbuf: int = 2, budget_bytes: int = _VMEM_CEILING,
                has_rhs: bool = False, ghost_y: bool = False,
                ghost_x: bool = False) -> int:
    """The TPU kernel's z band: the largest divisor of ``cz`` whose VMEM
    footprint fits the budget, with >= 2 bands of >= ``depth`` planes. The
    CUDA kernel marches (y, x) column tiles down z chunks and takes no
    band; this is the JAX package's pure sizing rule, kept for callers that size a band."""
    plane = cy * cx * itemsize
    k = depth

    def cost(b):
        P0 = b + 2 * depth
        c = (nbuf * P0 + 2 * (P0 - 2) + nbuf * b) * plane + 2 * depth * plane
        if has_rhs:
            c += nbuf * P0 * plane
        if ghost_y:
            c += ((cz + 2 * k) + 2 * (P0 - 2)) * 2 * k * cx * itemsize
        if ghost_x:
            c += ((cz + 2 * k) + 2 * (P0 - 2)) * cy * 128 * itemsize
        if ghost_y and ghost_x:
            c += ((cz + 2 * k) + 2 * (P0 - 2)) * 2 * k * 128 * itemsize
        return c

    band = cz
    while band > 1 and cost(band) > budget_bytes:
        band = next((d for d in range(band - 1, 0, -1) if cz % d == 0), 1)
    if cost(band) > budget_bytes:
        raise ValueError(
            f"no band fits: even band=1 needs {cost(1)} B "
            f"(> budget {budget_bytes} B); shrink the plane extents or "
            "raise the budget"
        )
    while band > 1 and cz // band < 2:
        band = next((d for d in range(band - 1, 0, -1) if cz % d == 0), 1)
    if cost(band) > budget_bytes or band < depth or cz // band < 2:
        raise ValueError(
            f"no band of cz={cz} gives >= 2 bands of >= depth={depth} "
            f"planes within {budget_bytes >> 20} MB VMEM (the window "
            "needs band >= depth); lower the depth"
        )
    return band


def _weights3d(coeffs) -> tuple[float, ...]:
    """The kernel's weights: the 7 coefficients as given, or the 27 of the
    weight cube in (dz, dy, dx) order."""
    if len(coeffs) == 27:
        from tpuscratch_torch.halo.halo3d import OFFSETS26

        cube = weight_cube(tuple(coeffs), OFFSETS26)
        return tuple(cube[z][y][x] for z in range(3) for y in range(3) for x in range(3))
    if len(coeffs) != 7:
        raise ValueError(f"need 7 or 27 coefficients, got {len(coeffs)}")
    return tuple(float(c) for c in coeffs)


def _flags3d(open_flags, lead, device) -> torch.Tensor:
    """Per-rank int32 [z-, z+, y-, y+, x-, x+] flags shaped ``lead + (6,)``;
    None means no open end, a trailing 2 means [z-, z+]."""
    if open_flags is None:
        return torch.zeros(lead + (6,), dtype=torch.int32, device=device)
    f = torch.as_tensor(open_flags, device=device).to(torch.int32)
    if f.shape[-1:] == (2,):
        f = torch.cat([f, torch.zeros(f.shape[:-1] + (4,), dtype=torch.int32, device=device)], -1)
    if f.shape[-1:] != (6,):
        raise ValueError(f"open_flags must end in 6 (or 2) entries, got {tuple(f.shape)}")
    return f.expand(lead + (6,)).contiguous()


def _wrap_index(n: int, k: int, device) -> torch.Tensor:
    return torch.arange(-k, n + k, device=device) % n


def extended_volume(core, a_mz, a_pz, depth, gy=None, gx=None, gc=None) -> torch.Tensor:
    """The ``(…, cz+2k, cy+2k, cx+2k)`` volume a pass reads: the slabs
    below and above the core, and beside it the strips' [plus | minus]
    halves or, on a self-wrapping axis, the core's own far rows/columns."""
    k = depth
    cy, cx = core.shape[-2:]
    a = torch.cat([a_mz, core, a_pz], dim=-3)
    if gy is not None:
        a = torch.cat([gy[..., k:, :], a, gy[..., :k, :]], dim=-2)
    else:
        a = a[..., _wrap_index(cy, k, core.device), :]
    if gx is None:
        return a[..., _wrap_index(cx, k, core.device)]
    if gy is not None:
        gx = torch.cat([gc[..., k:, :], gx, gc[..., :k, :]], dim=-2)
    else:
        gx = gx[..., _wrap_index(cy, k, core.device), :]
    return torch.cat([gx[..., k:], a, gx[..., :k]], dim=-1)


def seven_point_streamed_plain(core, a_mz, a_pz, coeffs, depth, open_flags,
                               gy=None, gx=None, gc=None, rhs=None,
                               rhs_coeff: float = 0.0) -> torch.Tensor:
    """``depth`` substeps as the kernel runs them, in torch ops: the
    shrinking pyramid over the extended volume, the cells outside the core
    on a flagged side set to zero after every substep but the last.
    ``open_flags`` is the ``(…, 6)`` int32 tensor of ``_flags3d``."""
    k = depth
    cz, cy, cx = core.shape[-3:]
    w = _weights3d(coeffs)
    a = extended_volume(core, a_mz, a_pz, k, gy, gx, gc)
    if rhs is not None:
        rhs = rhs[..., _wrap_index(cy, k, core.device), :][..., _wrap_index(cx, k, core.device)]
    if len(w) == 7:
        from tpuscratch_torch.halo.halo3d import FACES

        taps = list(zip(FACES, w[:6])) + [((0, 0, 0), w[6])]
    else:
        taps = [((t // 9 - 1, t // 3 % 3 - 1, t % 3 - 1), w[t]) for t in range(27)]
    f = open_flags.bool()[..., None, None, None]
    for s in range(1, k + 1):
        P, Q, R = a.shape[-3:]
        acc = None
        for (dz, dy, dx), wgt in taps:
            term = wgt * a[..., 1 + dz : P - 1 + dz, 1 + dy : Q - 1 + dy, 1 + dx : R - 1 + dx]
            acc = term if acc is None else acc + term
        if rhs is not None:
            acc = acc + rhs_coeff * rhs[..., s:-s, s:-s, s:-s]
        a = acc
        g = k - s  # ghost rings still in play
        if g:
            zero = torch.zeros((), dtype=a.dtype, device=a.device)
            sides = [(0, (slice(None, g),)), (1, (slice(-g, None),))]
            if gy is not None:
                sides += [(2, (slice(None), slice(None, g))), (3, (slice(None), slice(-g, None)))]
            if gx is not None:
                sides += [(4, (slice(None),) * 2 + (slice(None, g),)),
                          (5, (slice(None),) * 2 + (slice(-g, None),))]
            for i, tail in sides:
                idx = (Ellipsis,) + tail + (slice(None),) * (3 - len(tail))
                a[idx] = torch.where(f[..., i, :, :, :], zero, a[idx])
    return a


@functools.lru_cache(maxsize=None)
def _lib3d() -> ctypes.CDLL:
    lib = library("stencil_stream3d")
    lib.ts_stream3d.argtypes = [_P] * 9 + [_I, _P, ctypes.c_float, _I, _P, _P]
    lib.ts_stream3d.restype = _I
    lib.ts_stream3d_occupancy.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 4
    lib.ts_stream3d_occupancy.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _stream3d_device(device: int, nt: int, j: int) -> tuple[int, int]:
    """(SMs, blocks an SM) of a launch of ``j`` substeps on the card, after
    checking the kernel's window and shared memory against
    :func:`stream3d_window` and :func:`stream3d_smem`."""
    lib = _lib3d()
    vals = [_I(0) for _ in range(4)]
    with torch.cuda.device(device):
        check_status(lib, lib.ts_stream3d_occupancy(nt, j, *(ctypes.byref(v) for v in vals)),
                     "seven_point_streamed_pallas")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm, smem, rows, cols = (v.value for v in vals)
    if (rows, cols) != stream3d_window(j) or smem != stream3d_smem(nt, j) or per_sm < 1:
        raise RuntimeError(f"stream3d_kernel<{nt}, {j}>: window {rows}x{cols}, {smem} B, "
                           f"{per_sm} an SM, against the host rule's {stream3d_window(j)}, "
                           f"{stream3d_smem(nt, j)} B")
    return sms, per_sm


def _card_plan3d(device: int):
    """The host rule on ``device``'s SMs and occupancy."""
    return lambda shape, nb, j, nt: stream3d_plan(shape, nb, j, nt,
                                                  *_stream3d_device(device, nt, j))


def _launch3d(core, a_mz, a_pz, gy, gx, gc, rhs, flags, w, k,
              rhs_coeff, plan_of=None) -> tuple[torch.Tensor, int]:
    """The pass on the card, as one launch or, past what a launch seats, a
    chain of launches over dense scratch volumes. Returns the new cores
    and the number of launches. ``plan_of(out_shape, nb, j, nt)`` replaces
    the host rule on the card's SMs and occupancy (for sweeps)."""
    name = "seven_point_streamed_pallas"
    for t in (core, a_mz, a_pz, gy, gx, gc, rhs):
        if t is not None:
            check_cuda(t, name, 3)
    lib = _lib3d()
    nt = len(w)
    most = stream3d_depth(smem_optin(lib, name), nt)
    if most < 1:
        raise ValueError(f"{name}: shared memory seats no launch of one substep")
    cz, cy, cx = core.shape[-3:]
    lead = tuple(core.shape[:-3])
    nb = core.numel() // (cz * cy * cx)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    src, gi, done, launches = core, -1, 0, 0
    while done < k:
        j = min(most, k - done)
        go = k - done - j
        shape = (cz + 2 * go, cy + 2 * go, cx + 2 * go)
        plan = (plan_of or _card_plan3d(core.device.index or 0))(shape, nb, j, nt)
        out = torch.empty(lead + shape, dtype=core.dtype, device=core.device)
        ints = (cz, cy, cx, k, done, j, gi, int(gy is not None), int(gx is not None),
                plan.ty, plan.tx, plan.zc)
        with torch.cuda.device(core.device):
            check_status(lib, lib.ts_stream3d(
                src.data_ptr(), ptr(a_mz), ptr(a_pz), ptr(gy), ptr(gx), ptr(gc), ptr(rhs),
                flags.data_ptr(), out.data_ptr(), nb, (ctypes.c_int * len(ints))(*ints),
                float(rhs_coeff), nt, (ctypes.c_float * nt)(*w), stream_of(core),
            ), name)
        src, gi, done, launches = out, go, done + j, launches + 1
    return src, launches


def seven_point_streamed_pallas(
    core: torch.Tensor,
    a_mz: torch.Tensor,
    a_pz: torch.Tensor,
    core_shape: tuple[int, int, int],
    coeffs7,
    depth: int,
    band: int | None = None,
    nbuf: int = 2,
    budget_bytes: int = _VMEM_CEILING,
    open_flags=None,
    carry_tail: bool | None = None,
    ysplit27: int = 4,
    gy: torch.Tensor | None = None,
    gx: torch.Tensor | None = None,
    gc: torch.Tensor | None = None,
    rhs: torch.Tensor | None = None,
    rhs_coeff: float = 0.0,
) -> torch.Tensor:
    """``depth`` 7- or 27-point Jacobi substeps of ``(…, cz, cy, cx)``
    cores in ONE pass (see the module docstring for the modes).

    ``a_mz``/``a_pz``: ``(…, depth, cy, cx)`` z-ghost slabs. ``gy``
    ``(…, cz+2k, 2k, cx)``, ``gx`` ``(…, cz+2k, cy, 2k)`` and, with both,
    ``gc`` ``(…, cz+2k, 2k, 2k)``: the ghost strips of a distributed or
    open y/x axis, 7 points only. ``rhs``: a pre-ghosted ``(…, cz+2k, cy,
    cx)`` field; every substep adds ``rhs_coeff * rhs`` at the cell's own
    coordinates (7 points, z-slab mode only). ``coeffs7`` may be 27
    OFFSETS26-ordered coefficients (+ centre), z-slab mode only.

    ``band``, ``nbuf``, ``budget_bytes``, ``carry_tail`` and ``ysplit27``
    shaped the TPU kernel's VMEM pipeline and are accepted for its
    signature: the CUDA kernel marches column tiles down z, so the TPU's
    refusals of a band that does not divide ``cz`` into >= 2 bands of >=
    ``depth`` planes, and of ``carry_tail`` without such a band, are gone.
    Kept: ``depth >= 1``, the slab and strip shapes, ``depth <= cz``,
    ``depth <= cy``/``cx`` on a ghosted axis, ``cy, cx >= 3``, ``gc``
    exactly with both ``gy`` and ``gx``, and 27 points and ``rhs`` only in
    z-slab mode. A pass deeper than one launch runs (``STREAM3D_MAX_J``, 8
    substeps) runs as a chain of launches over scratch copies of the
    extended volume.
    """
    cz, cy, cx = core_shape
    k = depth
    lead = tuple(core.shape[:-3])
    w = _weights3d(coeffs7)
    if tuple(core.shape[-3:]) != tuple(core_shape):
        raise ValueError(f"core {tuple(core.shape)} != {core_shape}")
    if tuple(a_mz.shape) != lead + (k, cy, cx) or tuple(a_pz.shape) != lead + (k, cy, cx):
        raise ValueError(
            f"ghost slabs must be {lead + (k, cy, cx)}, got "
            f"{tuple(a_mz.shape)}/{tuple(a_pz.shape)}"
        )
    if k < 1:
        raise ValueError(f"depth must be >= 1, got {k}")
    ghost_y, ghost_x = gy is not None, gx is not None
    if ghost_y or ghost_x:
        if len(w) == 27:
            raise ValueError(
                "ghosted y/x axes are 7-point only; the 27-point form "
                "needs a z-slab mesh (impl='compact-asm' serves "
                "distributed y/x)"
            )
        want = lead + (cz + 2 * k, 2 * k, cx)
        if ghost_y and tuple(gy.shape) != want:
            raise ValueError(f"gy must be {want}, got {tuple(gy.shape)}")
        want = lead + (cz + 2 * k, cy, 2 * k)
        if ghost_x and tuple(gx.shape) != want:
            raise ValueError(f"gx must be {want}, got {tuple(gx.shape)}")
        if (ghost_y and ghost_x) != (gc is not None):
            raise ValueError(
                "gc (the xy-corner strip) is required exactly when both "
                "gy and gx are given"
            )
        want = lead + (cz + 2 * k, 2 * k, 2 * k)
        if gc is not None and tuple(gc.shape) != want:
            raise ValueError(f"gc must be {want}, got {tuple(gc.shape)}")
        if (ghost_y and k > cy) or (ghost_x and k > cx):
            raise ValueError(f"depth {k} exceeds a ghosted plane extent")
    elif gc is not None:
        raise ValueError(
            "gc (the xy-corner strip) is required exactly when both gy and gx are given")
    if rhs is not None:
        if len(w) == 27:
            raise ValueError("rhs smoothing is 7-point only")
        if ghost_y or ghost_x:
            raise ValueError(
                "rhs smoothing needs a z-slab mesh (self-wrapping y/x); "
                "ghosted y/x axes are not supported with rhs"
            )
        want = lead + (cz + 2 * k, cy, cx)
        if tuple(rhs.shape) != want:
            raise ValueError(f"rhs must be PRE-GHOSTED {want}, got {tuple(rhs.shape)}")
    if band is not None and band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if k > cz:
        raise ValueError(f"depth {k} > core depth {cz}: the slabs are the neighbours' planes")
    if cy < 3 or cx < 3:
        raise ValueError(f"plane extents must be >= 3, got {cy}x{cx}")
    flags = _flags3d(open_flags, lead, core.device)
    if route(core, "seven_point_streamed_pallas"):
        contig = [None if t is None else t.contiguous() for t in (core, a_mz, a_pz, gy, gx, gc, rhs)]
        out, launches = _launch3d(*contig, flags, w, k, rhs_coeff)
        seven_point_streamed_pallas.launches += launches
        return out
    return seven_point_streamed_plain(core, a_mz, a_pz, coeffs7, k, flags, gy, gx, gc,
                                      rhs, rhs_coeff)


#: The kernel wrappers, in the order of the TPU kernel table.
WRAPPERS = (nine_point_streamed_2d, seven_point_streamed_pallas)
reset_launches, launch_counts = counters(WRAPPERS)
