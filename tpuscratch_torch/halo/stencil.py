"""Stencil compute + the exchange-compute iteration loop.

The twin of ``tpuscratch.halo.stencil`` over the stacked-tile tensor: every
function takes and returns ``(rows, cols, ph, pw)`` tiles (the compute
helpers work on any leading dims). The loop is a Python loop of eager
torch operations, where the JAX package folds the steps into one
``lax.scan``. ``impl`` picks the compute path: ``xla``, ``deep`` and
``overlap`` are torch tensor operations; ``pallas``, ``blocked``,
``deep-pallas`` and ``resident`` launch the hand-written CUDA kernels of
``ops.stencil_kernel``, and ``run_stencil_stream`` the kernel of
``ops.stencil_stream``, on CUDA tensors (their plain torch versions on
CPU tensors).

Every new core is written OUT OF PLACE: a kernel or update that writes the
tile it is still reading with shifted reads races (see ``rebuild``).
"""

from __future__ import annotations

import torch

from tpuscratch_torch.comm.collectives import _recording, record_op
from tpuscratch_torch.halo.exchange import (
    HaloSpec,
    _index,
    halo_arrivals,
    halo_exchange,
    halo_scatter,
)
from tpuscratch_torch.halo.layout import TileLayout

JACOBI = (0.25, 0.25, 0.25, 0.25, 0.0)


def five_point(tile: torch.Tensor, layout: TileLayout, coeffs=JACOBI) -> torch.Tensor:
    """One Jacobi-style 5-point update of the core; halo is read, not
    written. ``coeffs`` = (north, south, west, east, center)."""
    if layout.halo_y < 1 or layout.halo_x < 1:
        raise ValueError(
            f"five_point needs halo >= 1, got ({layout.halo_y},{layout.halo_x})"
        )
    new_core = _new_values(
        tile, 0, layout.core_h, 0, layout.core_w, layout, coeffs
    )
    return rebuild(tile, new_core, layout)


def nine_point(
    tile: torch.Tensor,
    layout: TileLayout,
    coeffs=(0.125, 0.125, 0.125, 0.125, 0.0625, 0.0625, 0.0625, 0.0625, 0.0),
) -> torch.Tensor:
    """One 9-point update of the core, reading the corner ghosts the
    8-neighbor exchange fills. ``coeffs`` = (north, south, west, east, nw,
    ne, sw, se, center)."""
    if layout.halo_y < 1 or layout.halo_x < 1:
        raise ValueError(
            f"nine_point needs halo >= 1, got ({layout.halo_y},{layout.halo_x})"
        )
    hy, hx = layout.halo_y, layout.halo_x
    h, w = layout.core_h, layout.core_w
    sl = lambda dy, dx: tile[  # noqa: E731
        ..., hy + dy : hy + dy + h, hx + dx : hx + dx + w
    ]
    cn, cs, cw, ce, cnw, cne, csw, cse, cc = coeffs
    new_core = (
        cn * sl(-1, 0) + cs * sl(1, 0) + cw * sl(0, -1) + ce * sl(0, 1)
        + cnw * sl(-1, -1) + cne * sl(-1, 1)
        + csw * sl(1, -1) + cse * sl(1, 1)
        + cc * sl(0, 0)
    )
    return rebuild(tile, new_core, layout)


def rebuild(tile: torch.Tensor, new_core: torch.Tensor, layout: TileLayout) -> torch.Tensor:
    """Wrap a freshly-computed core back into the padded tile's border.

    By concatenation into a FRESH buffer, never by writing the core into
    ``tile``: an in-place core update while shifted reads of the same
    buffer are still live is a Gauss-Seidel-like race (the JAX package
    hit it as an XLA:CPU miscompile; on a GPU it is a real data race).
    """
    hy, hx = layout.halo_y, layout.halo_x
    h, w = layout.core_h, layout.core_w
    mid = torch.cat(
        [tile[..., hy : hy + h, :hx], new_core, tile[..., hy : hy + h, hx + w :]],
        dim=-1,
    )
    return torch.cat([tile[..., :hy, :], mid, tile[..., hy + h :, :]], dim=-2)


def _compute(tile: torch.Tensor, layout: TileLayout, coeffs, impl: str) -> torch.Tensor:
    if len(coeffs) == 9:
        if impl != "xla":
            raise ValueError(
                f"9-point coeffs are only supported by impl='xla', got {impl!r}"
            )
        return nine_point(tile, layout, coeffs)
    if impl == "xla":
        return five_point(tile, layout, coeffs)
    if impl == "pallas":
        from tpuscratch_torch.ops.stencil_kernel import five_point_pallas

        return five_point_pallas(tile, layout, tuple(coeffs))
    if impl == "blocked":
        from tpuscratch_torch.ops.stencil_kernel import five_point_blocked

        return five_point_blocked(tile, layout, tuple(coeffs))
    raise ValueError(f"unknown stencil impl {impl!r}")


def _new_values(t: torch.Tensor, r0: int, r1: int, c0: int, c1: int, layout, coeffs) -> torch.Tensor:
    """Updated values for core cells rows [r0,r1) x cols [c0,c1), read from
    the (padded-coordinate) tile ``t``."""
    hy, hx = layout.halo_y, layout.halo_x
    cn, cs, cw, ce, cc = coeffs
    ry, rx = hy + r0, hx + c0
    h, w = r1 - r0, c1 - c0
    return (
        cn * t[..., ry - 1 : ry - 1 + h, rx : rx + w]
        + cs * t[..., ry + 1 : ry + 1 + h, rx : rx + w]
        + cw * t[..., ry : ry + h, rx - 1 : rx - 1 + w]
        + ce * t[..., ry : ry + h, rx + 1 : rx + 1 + w]
        + cc * t[..., ry : ry + h, rx : rx + w]
    )


def stencil_step_overlap(tile: torch.Tensor, spec: HaloSpec, coeffs=JACOBI) -> torch.Tensor:
    """Exchange split around the interior compute — the async-halo variant.

    The interior of the core reads only core cells, so its update is
    computed from the PRE-exchange tiles; only the 1-cell boundary ring
    of the core waits for the arrivals. Eager torch runs the pieces in
    order on one stream; the split keeps the JAX package's dataflow (and
    its results) so a later stream- or graph-based schedule can overlap
    them.
    """
    lay = spec.layout
    if len(coeffs) != 5:
        raise ValueError("the overlap impl supports 5-point coeffs only")
    if lay.halo_y < 1 or lay.halo_x < 1:
        raise ValueError("five_point needs halo >= 1 on both axes")
    h, w = lay.core_h, lay.core_w
    if h < 3 or w < 3:
        # no interior to overlap; fall back to the plain step
        return five_point(halo_exchange(tile, spec), lay, coeffs)

    arrivals = halo_arrivals(tile, spec)
    interior = _new_values(tile, 1, h - 1, 1, w - 1, lay, coeffs)
    t2 = halo_scatter(tile, spec, arrivals)

    top = _new_values(t2, 0, 1, 0, w, lay, coeffs)
    bottom = _new_values(t2, h - 1, h, 0, w, lay, coeffs)
    left = _new_values(t2, 1, h - 1, 0, 1, lay, coeffs)
    right = _new_values(t2, 1, h - 1, w - 1, w, lay, coeffs)

    mid = torch.cat([left, interior, right], dim=-1)
    new_core = torch.cat([top, mid, bottom], dim=-2)
    return rebuild(t2, new_core, lay)


def stencil_step(tile: torch.Tensor, spec: HaloSpec, coeffs=JACOBI, impl: str = "xla") -> torch.Tensor:
    """Exchange then compute — one iteration of the flagship loop.

    ``impl``: 'xla' (torch ops), 'pallas' / 'blocked' (the hand-written
    5-point kernel, ``ops.stencil_kernel``), or 'overlap' (interior
    compute split from the halo transfers, ``stencil_step_overlap``).
    """
    if impl not in ("xla", "pallas", "blocked", "overlap"):
        raise ValueError(f"unknown stencil impl {impl!r}")
    if len(coeffs) == 9 and spec.neighbors != 8:
        raise ValueError(
            "9-point coeffs need a neighbors=8 HaloSpec: a 4-neighbor "
            "exchange never fills the corner ghosts the stencil reads"
        )
    if impl == "overlap":
        return stencil_step_overlap(tile, spec, coeffs)
    tile = halo_exchange(tile, spec)
    return _compute(tile, spec.layout, coeffs, impl)


def run_stencil(tile: torch.Tensor, spec: HaloSpec, steps: int, coeffs=JACOBI, impl: str = "xla", unroll: int = 1) -> torch.Tensor:
    """N iterations of exchange + compute. ``unroll`` is accepted for the
    JAX package's signature; an eager loop has nothing to unroll."""
    for _ in range(steps):
        tile = stencil_step(tile, spec, coeffs, impl)
    return tile


def run_stencil_resident(tile: torch.Tensor, spec: HaloSpec, steps: int, coeffs=JACOBI, unroll: int = 8) -> torch.Tensor:
    """N iterations in one kernel launch — the single-device fast path.

    On a 1x1 periodic topology the halo exchange is a self-wrap, so the
    ghost cells are redundant: periodic wrap is modular indexing of the
    core, and the whole loop runs in ``resident_periodic_pallas`` (one
    cooperative launch). Returns the padded tiles with the halo re-wrapped
    (one trailing exchange), interchangeable with ``run_stencil``'s.
    """
    lay = spec.layout
    if spec.topology.dims != (1, 1):
        raise ValueError(
            f"resident stencil is single-device only, got mesh {spec.topology.dims}"
        )
    if not all(spec.topology.periodic):
        raise ValueError(
            "resident stencil requires a periodic topology; use "
            "run_stencil or run_stencil_deep(impl='xla') for open "
            "boundaries"
        )
    from tpuscratch_torch.ops.stencil_kernel import resident_periodic_pallas

    hy, hx = lay.halo_y, lay.halo_x
    core = tile[0, 0, hy : hy + lay.core_h, hx : hx + lay.core_w].contiguous()
    new_core = resident_periodic_pallas(core, steps, tuple(coeffs), unroll)
    return halo_exchange(rebuild(tile, new_core[None, None], lay), spec)


def _neighbor_block(block: torch.Tensor, spec, off) -> torch.Tensor:
    """Each rank's copy of ``block`` (stacked over the mesh dims) from
    the rank at ``-off`` from it: the block a ``ppermute`` toward ``off``
    delivers. Zeros where no rank sends (an open edge, MPI_PROC_NULL), the
    block itself where every rank sends to itself. Only the gather is a
    ``ppermute`` in the JAX package, so only it is recorded as a
    ``collective-permute`` in an open ledger."""
    topo = spec.topology
    pairs = topo.send_permutation(off)
    if not pairs:
        return torch.zeros_like(block)
    if len(pairs) == topo.size and all(s == d for s, d in pairs):
        return block
    if _recording:
        record_op("collective-permute", block.numel() // topo.size * block.element_size(),
                  len(pairs))
    src = list(range(topo.size))
    for s, d in pairs:
        src[d] = s
    flat = block.flatten(0, topo.ndim - 1).index_select(0, _index(tuple(src), block.device))
    missing = tuple(sorted(set(range(topo.size)) - {d for _, d in pairs}))
    if missing:
        flat[_index(missing, block.device)] = 0
    return flat.view(block.shape)


def _stream_flags(spec: HaloSpec, device) -> torch.Tensor | None:
    """Per-rank int32 [top, bottom, left, right] open-end flags, stacked
    ``(rows, cols, 4)``; None when the topology is fully periodic."""
    if all(spec.topology.periodic):
        return None
    dims = spec.topology.dims
    flags = _open_side_flags(spec, torch.int32, device)
    return torch.stack([f[..., 0, 0].expand(dims) for f in flags], dim=-1).contiguous()


def run_stencil_stream(
    tile: torch.Tensor,
    spec: HaloSpec,
    steps: int,
    coeffs=JACOBI,
    depth: int = 8,
    band: int | None = None,
) -> torch.Tensor:
    """``steps`` iterations through the streamed kernel
    (``ops.stencil_stream.nine_point_streamed_2d``): ``depth`` substeps a
    launch, one ``depth``-deep gather of ghosts per pass, the remainder of
    ``steps`` as a shallower last pass. Any cartesian layout, 5- or
    9-point coefficients, periodic or open ends:

    - row ghosts travel as ``(depth, W)`` slabs, the row neighbours' far
      rows (zeros past an open end);
    - a periodic column axis of size 1 self-wraps in the kernel (wrap
      mode); otherwise ``(H + 2*depth, depth)`` ghost-column slabs carry
      the column neighbours' edge columns with the diagonal neighbours'
      corner blocks at the ends (ghost mode);
    - open ends are re-zeroed after every substep through per-rank flags.

    The slabs are gathered from the stacked cores with torch indexing over
    the rank dims. Takes and returns the stacked padded tiles (trailing
    exchange), interchangeable with the other impls'.
    """
    from tpuscratch_torch.ops.stencil_stream import nine_point_streamed_2d

    lay = spec.layout
    topo = spec.topology
    want = tuple(topo.dims) + lay.padded_shape
    if tuple(tile.shape) != want:
        raise ValueError(f"tiles {tuple(tile.shape)} != stacked padded {want}")
    H, W = lay.core_h, lay.core_w
    if not 1 <= depth <= H:
        raise ValueError(f"stream depth {depth} must be in [1, core height {H}]")
    hy, hx = lay.halo_y, lay.halo_x
    core = tile[..., hy : hy + H, hx : hx + W]
    wrap_x = topo.dims[1] == 1 and topo.periodic[1]
    flags = _stream_flags(spec, tile.device)

    def pass_fn(c, d):
        gather = lambda block, off: _neighbor_block(block, spec, off)  # noqa: E731
        a_top = gather(c[..., H - d :, :], (1, 0))
        a_bot = gather(c[..., :d, :], (-1, 0))
        gl = gr = None
        if not wrap_x:
            gl = torch.cat([gather(c[..., H - d :, W - d :], (1, 1)),
                            gather(c[..., :, W - d :], (0, 1)),
                            gather(c[..., :d, W - d :], (-1, 1))], dim=-2)
            gr = torch.cat([gather(c[..., H - d :, :d], (1, -1)),
                            gather(c[..., :, :d], (0, -1)),
                            gather(c[..., :d, :d], (-1, -1))], dim=-2)
        return nine_point_streamed_2d(c, a_top, a_bot, (H, W), tuple(coeffs), d, band,
                                      open_flags=flags, gl=gl, gr=gr)

    q, r = divmod(steps, depth)
    out = core
    for _ in range(q):
        out = pass_fn(out, depth)
    if r:
        out = pass_fn(out, r)
    return halo_exchange(rebuild(tile, out, lay), spec)


def shrink_step(a: torch.Tensor, coeffs) -> torch.Tensor:
    """One valid-region Jacobi step: (..., H, W) -> (..., H-2, W-2), every
    output cell computed from fully-valid neighbors."""
    H, W = a.shape[-2:]
    h, w = H - 2, W - 2
    cn, cs, cw, ce, cc = coeffs
    return (
        cn * a[..., 0:h, 1 : 1 + w]
        + cs * a[..., 2 : 2 + h, 1 : 1 + w]
        + cw * a[..., 1 : 1 + h, 0:w]
        + ce * a[..., 1 : 1 + h, 2 : 2 + w]
        + cc * a[..., 1 : 1 + h, 1 : 1 + w]
    )


def _open_side_flags(spec: HaloSpec, dtype, device) -> list[torch.Tensor]:
    """Per-rank (top, bottom, left, right) flags, 1.0 where that side's
    ghosts are a physical open edge, shaped to broadcast over the stacked
    ``(rows, cols, h, w)`` tensor."""
    topo = spec.topology
    rows, cols = topo.dims
    flags = []
    for axis, n in ((0, rows), (1, cols)):
        idx = torch.arange(n, device=device)
        if topo.periodic[axis]:
            lo = hi = torch.zeros(n, dtype=dtype, device=device)
        elif n == 1:
            lo = hi = torch.ones(n, dtype=dtype, device=device)
        else:
            lo, hi = (idx == 0).to(dtype), (idx == n - 1).to(dtype)
        shape = (n, 1, 1, 1) if axis == 0 else (1, n, 1, 1)
        flags += [lo.reshape(shape), hi.reshape(shape)]
    return flags


def run_stencil_deep(tile: torch.Tensor, spec: HaloSpec, steps: int, coeffs=JACOBI, depth: int | None = None, impl: str = "xla") -> torch.Tensor:
    """Communication-avoiding iteration: one ``depth``-wide halo exchange
    buys ``depth`` update substeps (trapezoid/ghost-zone scheme).

    Open (non-periodic) boundaries are supported on the ``xla`` impl: a
    physical edge's ghost rings stay ZERO at every substep (MPI_PROC_NULL
    semantics), so after each substep the rings still acting as ghosts on
    an open side are re-zeroed. The ``pallas`` trapezoid kernel is
    periodic-only. ``depth`` defaults to the layout halo width; the
    remainder of ``steps`` runs as a shallower trailing trapezoid.

    ``impl='xla'`` runs the substep pyramid as torch ops (about one memory
    pass per substep); ``impl='pallas'`` runs the whole pyramid in one
    launch of the row-march kernel ``deep_trapezoid_pallas`` (one read +
    one write per ``depth`` substeps, a launch per 32 past that).
    """
    lay = spec.layout
    k = lay.halo_y if depth is None else depth
    if lay.halo_y != lay.halo_x:
        raise ValueError("deep stencil needs a square halo (halo_y == halo_x)")
    if not (1 <= k <= lay.halo_y):
        raise ValueError(f"depth {k} must be in [1, halo {lay.halo_y}]")
    topo = spec.topology
    open_any = not all(topo.periodic)
    if open_any and impl == "pallas":
        raise ValueError(
            "the pallas trapezoid kernel is periodic-only; use "
            "impl='xla' deep (open-boundary aware) or a per-step impl"
        )
    if min(lay.core_h, lay.core_w) < k:
        raise ValueError(
            f"core {lay.core_h}x{lay.core_w} smaller than depth {k}"
        )
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown deep stencil impl {impl!r}")

    flags = _open_side_flags(spec, tile.dtype, tile.device) if open_any else None

    def zero_open_margins(a, g):
        # the g outermost rings still acting as ghosts must stay zero on
        # open sides (they are real evolving data on periodic or interior
        # sides); `a` is a fresh intermediate, so updating it in place
        # aliases nothing
        f_my, f_py, f_mx, f_px = flags
        a[..., :g, :] *= 1 - f_my
        a[..., -g:, :] *= 1 - f_py
        a[..., :, :g] *= 1 - f_mx
        a[..., :, -g:] *= 1 - f_px
        return a

    def trapezoid(t, substeps):
        t = halo_exchange(t, spec)
        if impl == "pallas":
            from tpuscratch_torch.ops.stencil_kernel import deep_trapezoid_pallas

            core = deep_trapezoid_pallas(t, lay, substeps, tuple(coeffs))
        else:
            a = t
            for j in range(1, substeps + 1):
                a = shrink_step(a, coeffs)
                g = lay.halo_y - j
                if open_any and g > 0 and j < substeps:
                    a = zero_open_margins(a, g)
            crop = lay.halo_y - substeps
            core = a[..., crop:-crop, crop:-crop] if crop else a
        return rebuild(t, core, lay)

    rounds, rem = divmod(steps, k)
    out = tile
    for _ in range(rounds):
        out = trapezoid(out, k)
    if rem:
        out = trapezoid(out, rem)
    return out
