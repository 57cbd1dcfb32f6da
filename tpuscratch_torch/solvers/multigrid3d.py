"""Geometric multigrid for the 3D periodic Poisson problem.

The twin of ``tpuscratch.solvers.multigrid3d``: the 2D solver one
dimension up, on the 3D halo library. Smoothing and the residual are
7-point (the faces-only exchange); the trilinear transfer pair reads edge
and corner ghosts (the 26-neighbor exchange), so each level carries a
(faces, all-26) spec pair. Smoothers:

- ``jacobi`` / ``rbgs``: damped Jacobi, or red-black GS with (i+j+k) mod 2
  parity, one exchange a sweep (a half-sweep for rbgs);
- ``s_step > 1``: the s-step / trapezoid scheme — one deep axis-sequential
  exchange (``halo_exchange3d_seq``) buys ``s`` Jacobi sweeps (ghost depth
  ``s``) or ``s`` red-black sweeps (depth ``2s``), bit-identical to the
  per-sweep smoother;
- ``jacobi-stream``: the finest levels' Jacobi sweeps folded into passes
  of the streamed 3D kernel (``ops.stencil_stream.seven_point_streamed_pallas``,
  ``stream3d_kernel`` on the card) with its ``rhs`` term; the levels
  ``_stream_smoothable`` refuses run plain Jacobi.

Values are stacked ``(*mesh, cz, cy, cx)``; every slice counts from the
end. The cycle loop is ``solvers.multigrid.cycle_loop``: one host sync a
cycle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.p2p import ppermute
from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.halo.halo3d import (
    HaloSpec3D,
    TileLayout3D,
    assemble3d_cores,
    decompose3d_cores,
    halo_exchange3d,
    halo_exchange3d_seq,
)
from tpuscratch_torch.runtime.mesh import make_mesh, resolve_device, topology_of
from tpuscratch_torch.solvers.cg import local_sum, relres
from tpuscratch_torch.solvers.multigrid import cycle_loop, warn_unconverged

_W4 = (0.125, 0.375, 0.375, 0.125)


def _embed(core: torch.Tensor, layout: TileLayout3D) -> torch.Tensor:
    """A zero padded tile of ``layout`` holding ``core``."""
    d = layout.halo[0]
    p = core.new_zeros(core.shape[:-3] + layout.padded_shape)
    p[..., d:p.shape[-3] - d, d:p.shape[-2] - d, d:p.shape[-1] - d] = core
    return p


def _padded3(core: torch.Tensor, spec: HaloSpec3D) -> torch.Tensor:
    """Embed a core tile and fill its 1-ghost shell from the torus."""
    return halo_exchange3d(_embed(core, spec.layout), spec)


def periodic_laplacian3(core: torch.Tensor, spec: HaloSpec3D) -> torch.Tensor:
    """``A @ core`` for the periodic 7-point operator (diagonal 6)."""
    u = _padded3(core, spec)
    return (
        6.0 * u[..., 1:-1, 1:-1, 1:-1]
        - u[..., :-2, 1:-1, 1:-1] - u[..., 2:, 1:-1, 1:-1]
        - u[..., 1:-1, :-2, 1:-1] - u[..., 1:-1, 2:, 1:-1]
        - u[..., 1:-1, 1:-1, :-2] - u[..., 1:-1, 1:-1, 2:]
    )


def _neighbor_sum3(u, spec: HaloSpec3D):
    p = _padded3(u, spec)
    return (
        p[..., :-2, 1:-1, 1:-1] + p[..., 2:, 1:-1, 1:-1]
        + p[..., 1:-1, :-2, 1:-1] + p[..., 1:-1, 2:, 1:-1]
        + p[..., 1:-1, 1:-1, :-2] + p[..., 1:-1, 1:-1, 2:]
    )


def jacobi_smooth3(u, f, spec: HaloSpec3D, omega: float, sweeps: int):
    for _ in range(sweeps):
        u = u + (omega / 6.0) * (f - periodic_laplacian3(u, spec))
    return u


def _parity_masks(shape, offset: int, device=None):
    ii = torch.arange(shape[0], device=device)[:, None, None]
    jj = torch.arange(shape[1], device=device)[None, :, None]
    kk = torch.arange(shape[2], device=device)[None, None, :]
    return (ii + jj + kk + offset) % 2 == 0


def _require_even(spec: HaloSpec3D) -> None:
    if any(c % 2 for c in spec.layout.core):
        raise ValueError(f"red-black smoothing needs even core extents, got {spec.layout.core}")


def rbgs_smooth3(u, f, spec: HaloSpec3D, sweeps: int, reverse: bool = False):
    """Red-black GS with (i+j+k) mod 2 parity (global for even cores)."""
    _require_even(spec)
    red = _parity_masks(spec.layout.core, 0, u.device)
    first, second = (~red, red) if reverse else (red, ~red)

    def half(u, mask):
        return torch.where(mask, (f + _neighbor_sum3(u, spec)) / 6.0, u)

    for _ in range(sweeps):
        u = half(half(u, first), second)
    return u


def _require_periodic(spec: HaloSpec3D, name: str) -> None:
    if not all(spec.topology.periodic):
        # an open end's ghost rings would need re-zeroing every substep;
        # the mg solvers are periodic-only, so refuse rather than smooth wrong
        raise ValueError(f"{name} is periodic-only; use the per-sweep smoother "
                         "for open boundaries")


def jacobi_smooth3_stream(u, f, spec: HaloSpec3D, omega: float,
                          sweeps: int, depth: int = 4):
    """``sweeps`` damped-Jacobi sweeps through the streamed 3D kernel:
    min(sweeps, depth) sweeps fold into each pass. The smoother is affine,
    u' = (1-omega) u + (omega/6) nbsum(u) + (omega/6) f, so the kernel
    takes coefficients ((omega/6) x 6, 1-omega) and the rhs term, ghosted
    once a call (``f`` does not change across sweeps). z-slab meshes only
    (``_stream_smoothable``): the z ghosts are the core's own planes on a
    one-rank z axis, else the z neighbors' through ``ppermute``."""
    from tpuscratch_torch.ops.stencil_stream import seven_point_streamed_pallas

    _require_periodic(spec, "jacobi_smooth3_stream")
    topo = spec.topology
    cz, cy, cx = spec.layout.core
    coeffs = (omega / 6.0,) * 6 + (1.0 - omega,)
    wrap_z = topo.dims[0] == 1 and topo.periodic[0]

    def zghosts(c, d):
        top, bot = c[..., cz - d:, :, :], c[..., :d, :, :]
        if wrap_z:
            return top, bot
        return (ppermute(top, spec.axes, topo.send_permutation((1, 0, 0))),
                ppermute(bot, spec.axes, topo.send_permutation((-1, 0, 0))))

    def ghosted_f(d):
        f_mz, f_pz = zghosts(f, d)
        return torch.cat([f_mz, f, f_pz], dim=-3)

    def one_pass(c, d, rhs):
        a_mz, a_pz = zghosts(c, d)
        return seven_point_streamed_pallas(c, a_mz, a_pz, (cz, cy, cx), coeffs, d,
                                           rhs=rhs, rhs_coeff=omega / 6.0)

    k = min(depth, sweeps)
    q, r = divmod(sweeps, k)
    out = u
    if q:
        rhs_k = ghosted_f(k)
        for _ in range(q):
            out = one_pass(out, k, rhs_k)
    if r:
        out = one_pass(out, r, ghosted_f(r))
    return out


def _deep_spec(spec: HaloSpec3D, depth: int) -> HaloSpec3D:
    """The depth-``depth`` twin of a level's faces spec (the s-step
    smoother's ghost geometry)."""
    return HaloSpec3D(layout=TileLayout3D(spec.layout.core, (depth,) * 3),
                      topology=spec.topology, axes=spec.axes, neighbors=6)


def _embed_seq(core: torch.Tensor, dspec: HaloSpec3D) -> torch.Tensor:
    """Zero-embed a core tile at the deep spec's depth and fill the FULL
    ghost shell with the 6-transfer axis-sequential exchange."""
    return halo_exchange3d_seq(_embed(core, dspec.layout), dspec)


def _crop(a: torch.Tensor, c: int) -> torch.Tensor:
    return a[..., c:-c, c:-c, c:-c] if c else a


def jacobi_smooth3_deep(u, f, spec: HaloSpec3D, omega: float, sweeps: int, s: int):
    """``sweeps`` damped-Jacobi sweeps, ``s`` per halo exchange (the
    s-step / trapezoid scheme, fused with the rhs). One depth-``s``
    exchange fills the ghost shell; substep ``j`` updates every cell at
    least ``j`` rings in from the padded border with EXACTLY the per-sweep
    arithmetic, so the result is bit-identical to :func:`jacobi_smooth3`.
    ``ceil(sweeps/s)`` state exchanges plus ONE rhs ghost fill (depth
    ``s-1``) a call."""
    _require_periodic(spec, "jacobi_smooth3_deep")
    if s < 1:
        raise ValueError(f"s-step depth must be >= 1, got {s}")
    if s == 1:
        return jacobi_smooth3(u, f, spec, omega, sweeps)
    if s > min(spec.layout.core):
        raise ValueError(f"s={s} deeper than core {spec.layout.core}: neighbor slabs "
                         "would overlap")
    dspec = _deep_spec(spec, s)
    fp = _embed_seq(f, _deep_spec(spec, s - 1))

    def lap(a):
        # periodic_laplacian3's exact op order, on the shrinking window
        return (
            6.0 * a[..., 1:-1, 1:-1, 1:-1]
            - a[..., :-2, 1:-1, 1:-1] - a[..., 2:, 1:-1, 1:-1]
            - a[..., 1:-1, :-2, 1:-1] - a[..., 1:-1, 2:, 1:-1]
            - a[..., 1:-1, 1:-1, :-2] - a[..., 1:-1, 1:-1, 2:]
        )

    def trapezoid(core, k):
        a = _embed_seq(core, dspec)
        for j in range(1, k + 1):
            # substep j's output spans ghost ring s-j; the rhs tile is
            # ghosted to depth s-1, so crop j-1 rings to align
            a = a[..., 1:-1, 1:-1, 1:-1] + (omega / 6.0) * (_crop(fp, j - 1) - lap(a))
        return _crop(a, s - k)

    q, r = divmod(sweeps, s)
    out = u
    for _ in range(q):
        out = trapezoid(out, s)
    if r:
        out = trapezoid(out, r)
    return out


def rbgs_smooth3_deep(u, f, spec: HaloSpec3D, sweeps: int, s: int, reverse: bool = False):
    """``sweeps`` red-black GS sweeps, ``s`` per halo exchange: each sweep
    is TWO masked half-updates, so the trapezoid needs ghost depth ``2s``.
    Masks use GLOBAL parity (even cores start every rank's tile even), seen
    through the shrinking window: the per-sweep smoother's coloring and op
    order, so bit-identical to :func:`rbgs_smooth3`."""
    _require_periodic(spec, "rbgs_smooth3_deep")
    _require_even(spec)
    if s < 1:
        raise ValueError(f"s-step depth must be >= 1, got {s}")
    d = 2 * s
    if d > min(spec.layout.core):
        raise ValueError(f"s={s} needs ghost depth {d} > core {spec.layout.core}")
    dspec = _deep_spec(spec, d)
    fp = _embed_seq(f, _deep_spec(spec, d - 1))

    def nbsum(a):
        # _neighbor_sum3's exact op order, on the shrinking window
        return (
            a[..., :-2, 1:-1, 1:-1] + a[..., 2:, 1:-1, 1:-1]
            + a[..., 1:-1, :-2, 1:-1] + a[..., 1:-1, 2:, 1:-1]
            + a[..., 1:-1, 1:-1, :-2] + a[..., 1:-1, 1:-1, 2:]
        )

    def trapezoid(core, k):
        # k sweeps = 2k half-updates; half t's output sits t+1 crops in,
        # so its window parity offset is (t+1) mod 2
        a = _embed_seq(core, dspec)
        for t in range(2 * k):
            # half t's output spans ghost ring d-t-1; the rhs tile is
            # ghosted to depth d-1, so crop t rings to align
            red = _parity_masks(tuple(n - 2 for n in a.shape[-3:]), (t + 1) % 2, a.device)
            mask = red if (t % 2 == 0) != reverse else ~red
            a = torch.where(mask, (_crop(fp, t) + nbsum(a)) / 6.0, a[..., 1:-1, 1:-1, 1:-1])
        return _crop(a, d - 2 * k)

    q, r = divmod(sweeps, s)
    out = u
    for _ in range(q):
        out = trapezoid(out, s)
    if r:
        out = trapezoid(out, r)
    return out


def _stream_smoothable(spec: HaloSpec3D, sweeps: int) -> bool:
    """True when the streamed smoother serves this level — the JAX
    package's rule, kept as it is: a z-slab periodic mesh, a core deep
    enough for >= 2 bands of the fold depth, and planes at least 8 rows by
    128 columns. It decides which levels launch the kernel."""
    topo = spec.topology
    cz = spec.layout.core[0]
    k = min(4, sweeps)
    return (
        topo.dims[1] == 1 and topo.dims[2] == 1
        and all(topo.periodic)
        and cz >= 2 * k
        and spec.layout.core[1] >= 8 and spec.layout.core[2] >= 128
    )


def stream_launches(specs, nu: int = 2, coarse_sweeps: int = 32, depth: int = 4) -> int:
    """Launches of the streamed kernel one ``v_cycle3(smoother=
    "jacobi-stream")`` makes: at every level ``_stream_smoothable``
    admits, a pass per ``depth`` sweeps (and one for a remainder) of each
    of its two smoothing calls, ``nu`` sweeps each (the coarsest level
    ``(coarse_sweeps + 1) // 2``)."""
    total = 0
    for level, (s6, _) in enumerate(specs):
        sweeps = nu if level < len(specs) - 1 else (coarse_sweeps + 1) // 2
        if _stream_smoothable(s6, sweeps):
            k = min(depth, sweeps)
            total += 2 * (sweeps // k + (1 if sweeps % k else 0))
    return total


def _smooth3(u, f, spec, omega, sweeps, smoother, reverse=False, s_step: int = 1):
    """One smoothing pass; ``s_step > 1`` requests the s-step deep-halo
    variants, clamped per level to what the tile seats (coarse levels fall
    back to the per-sweep path)."""
    cz, cy, cx = spec.layout.core
    if smoother == "jacobi-stream":
        if _stream_smoothable(spec, sweeps):
            return jacobi_smooth3_stream(u, f, spec, omega, sweeps)
        return jacobi_smooth3(u, f, spec, omega, sweeps)
    deep = s_step > 1 and all(spec.topology.periodic) and sweeps > 1
    if smoother == "rbgs" and not (cz % 2 or cy % 2 or cx % 2):
        if deep:
            s_eff = min(s_step, sweeps, min(cz, cy, cx) // 2)
            if s_eff > 1:
                return rbgs_smooth3_deep(u, f, spec, sweeps, s_eff, reverse)
        return rbgs_smooth3(u, f, spec, sweeps, reverse)
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if deep:
        s_eff = min(s_step, sweeps, min(cz, cy, cx))
        if s_eff > 1:
            return jacobi_smooth3_deep(u, f, spec, omega, sweeps, s_eff)
    return jacobi_smooth3(u, f, spec, omega, sweeps)


def restrict_fw3(r: torch.Tensor, spec: HaloSpec3D) -> torch.Tensor:
    """Full-weighting restriction: the [1,3,3,1]/8 stencil cubed over each
    coarse cell's 4x4x4 fine neighborhood — reads edge and corner ghosts,
    so ``spec`` must carry the 26-neighbor plan."""
    rp = _padded3(r, spec)
    cz, cy, cx = (s // 2 for s in r.shape[-3:])
    acc = r.new_zeros(r.shape[:-3] + (cz, cy, cx))
    for a, wa in enumerate(_W4):
        for b, wb in enumerate(_W4):
            for c, wc in enumerate(_W4):
                acc = acc + wa * wb * wc * rp[..., a:a + 2 * cz - 1:2, b:b + 2 * cy - 1:2,
                                              c:c + 2 * cx - 1:2]
    return acc


def prolong_trilinear(e: torch.Tensor, spec: HaloSpec3D) -> torch.Tensor:
    """Cell-centered trilinear prolongation: each fine cell blends its 8
    nearest coarse cells with (3/4, 1/4) per-axis weights (corner ghosts —
    the 26-neighbor spec)."""
    ep = _padded3(e, spec)
    lead, (cz, cy, cx) = e.shape[:-3], e.shape[-3:]

    def sl(dz, dy, dx):
        return ep[..., 1 + dz:1 + dz + cz, 1 + dy:1 + dy + cy, 1 + dx:1 + dx + cx]

    octants = []
    for a in (0, 1):          # fine z within the coarse cell
        planes = []
        for b in (0, 1):      # fine y
            rows = []
            for c in (0, 1):  # fine x
                sz = -1 if a == 0 else 1
                sy = -1 if b == 0 else 1
                sx = -1 if c == 0 else 1
                v = (
                    27 * sl(0, 0, 0)
                    + 9 * (sl(sz, 0, 0) + sl(0, sy, 0) + sl(0, 0, sx))
                    + 3 * (sl(sz, sy, 0) + sl(sz, 0, sx) + sl(0, sy, sx))
                    + sl(sz, sy, sx)
                ) / 64.0
                rows.append(v)
            planes.append(torch.stack(rows, dim=-1).reshape(*lead, cz, cy, 2 * cx))
        octants.append(torch.stack(planes, dim=-2).reshape(*lead, cz, 2 * cy, 2 * cx))
    return torch.stack(octants, dim=-3).reshape(*lead, 2 * cz, 2 * cy, 2 * cx)


def level_specs3(layout: TileLayout3D, topo, axes, levels: int
                 ) -> list[tuple[HaloSpec3D, HaloSpec3D]]:
    """Per level, a (faces-only, all-26) spec PAIR: smoothing and the
    residual are 7-point and pay the 6-transfer plan; the two inter-level
    transfers read edge/corner ghosts and use the 26-plan."""
    specs = []
    for l in range(levels):
        core = tuple(c >> l for c in layout.core)
        if any(c < 1 for c in core) or (l < levels - 1 and any(c % 2 for c in core)):
            raise ValueError(f"tile {layout.core} does not support {levels} levels "
                             f"(level {l} would be {core})")
        lay = TileLayout3D(core, (1, 1, 1))
        specs.append(tuple(HaloSpec3D(layout=lay, topology=topo, axes=axes, neighbors=n)
                           for n in (6, 26)))
    return specs


def v_cycle3(
    u, f, specs, level: int = 0,
    nu: int = 2, coarse_sweeps: int = 32, omega: float = 6 / 7,
    smoother: str = "rbgs", s_step: int = 1,
):
    """One 3D V-cycle; post-smoothing reverses color order so the cycle
    is symmetric. ``specs`` is the ``level_specs3`` list of (faces,
    all-26) pairs. ``s_step > 1`` runs every smoothing pass
    communication-avoiding (bit-identical to the per-sweep smoother)."""
    s6, s26 = specs[level]
    if level == len(specs) - 1:
        half = (coarse_sweeps + 1) // 2
        u = _smooth3(u, f, s6, omega, half, smoother, s_step=s_step)
        return _smooth3(u, f, s6, omega, half, smoother, reverse=True, s_step=s_step)
    u = _smooth3(u, f, s6, omega, nu, smoother, s_step=s_step)
    r = f - periodic_laplacian3(u, s6)
    rc = 4.0 * restrict_fw3(r, s26)
    ec = v_cycle3(torch.zeros_like(rc), rc, specs, level + 1, nu, coarse_sweeps, omega,
                  smoother, s_step)
    u = u + prolong_trilinear(ec, specs[level + 1][1])
    return _smooth3(u, f, s6, omega, nu, smoother, reverse=True, s_step=s_step)


def _mg_prologue3(b_world: np.ndarray, mesh, levels: Optional[int], device=None):
    """Shared 3D driver prologue: default mesh (1x1x1 on ``device``),
    divisibility check, per-level spec pairs."""
    if mesh is None:
        mesh = make_mesh((1, 1, 1), ("z", "row", "col"), device)
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} != mesh device {mesh.device}")
    dims = tuple(mesh.shape)
    topo = topology_of(mesh, periodic=True)
    if any(w % d for w, d in zip(b_world.shape, dims)):
        raise ValueError(f"grid {b_world.shape} not divisible by mesh {dims}")
    layout = TileLayout3D(tuple(w // d for w, d in zip(b_world.shape, dims)), (1, 1, 1))
    if levels is None:
        levels = 1
        while (all(c >> levels >= 2 for c in layout.core)
               and all((c >> (levels - 1)) % 2 == 0 for c in layout.core)):
            levels += 1
    specs = level_specs3(layout, topo, tuple(mesh.axis_names), levels)
    cells = float(np.prod(b_world.shape))
    return mesh, dims, specs, tuple(mesh.axis_names), cells


def _mg3_program(mesh, specs, axes, cells, tol, max_cycles, nu,
                 coarse_sweeps, omega, smoother, s_step=1):
    """The 3D V-cycle solver program."""
    def local(b_tile):
        b = b_tile[..., 0, 0, 0, :, :, :]
        f = b - allreduce_sum(local_sum(b), axes) / cells

        def rs_of(u):
            r = f - periodic_laplacian3(u, specs[0][0])
            return allreduce_sum(local_sum(r * r), axes)

        rs0 = allreduce_sum(local_sum(f * f), axes)
        u, k, rs = cycle_loop(
            f, lambda u: v_cycle3(u, f, specs, 0, nu, coarse_sweeps, omega, smoother, s_step),
            rs_of, rs0, tol, max_cycles)
        u = u - allreduce_sum(local_sum(u), axes) / cells
        kt = torch.full(mesh.shape, k, dtype=torch.int32, device=b.device)
        return u[..., None, None, None, :, :, :], kt, relres(rs, rs0).reshape(mesh.shape)

    return run_spmd(mesh, local, P(*mesh.axis_names, None, None, None),
                    (P(*mesh.axis_names, None, None, None), P(), P()))


def _pcg3_program(mesh, specs, axes, cells, tol, max_iters, nu,
                  coarse_sweeps, omega, smoother, s_step=1):
    """The 3D MG-preconditioned CG program."""
    from tpuscratch_torch.solvers.cg import cg

    def local(b_tile):
        b = b_tile[..., 0, 0, 0, :, :, :]
        f = b - allreduce_sum(local_sum(b), axes) / cells

        def project(v):
            return v - allreduce_sum(local_sum(v), axes) / cells

        def precond(r):
            z = v_cycle3(torch.zeros_like(r), project(r), specs, 0, nu, coarse_sweeps, omega,
                         smoother, s_step)
            return project(z)

        x, k, rel = cg(lambda p: periodic_laplacian3(p, specs[0][0]), f, axes, tol=tol,
                       max_iters=max_iters, precond=precond)
        x = project(x)
        kt = torch.full(mesh.shape, k, dtype=torch.int32, device=b.device)
        return x[..., None, None, None, :, :, :], kt, rel.reshape(mesh.shape)

    return run_spmd(mesh, local, P(*mesh.axis_names, None, None, None),
                    (P(*mesh.axis_names, None, None, None), P(), P()))


def _solve3(program, b_world, mesh, dims):
    b = torch.from_numpy(decompose3d_cores(np.asarray(b_world), dims)).to(mesh.device)
    x_tiles, k, rel = program(b)
    return assemble3d_cores(x_tiles.cpu().numpy()), int(k), float(rel)


def mg_poisson3d_solve(
    b_world: np.ndarray,
    mesh=None,
    *,
    levels: Optional[int] = None,
    tol: float = 1e-5,
    max_cycles: int = 50,
    nu: int = 2,
    coarse_sweeps: int = 32,
    omega: float = 6 / 7,
    smoother: str = "rbgs",
    s_step: int = 1,
    device=None,
):
    """Solve ``A x = b - mean(b)`` (periodic 7-point Laplacian) by 3D
    V-cycles over a 3-axis mesh (default 1x1x1 on ``device``, the card
    unless ``device='cpu'``). Returns ``(x_world, cycles, relres)`` with
    zero-mean ``x`` (the 2D solver's contract, its ``relres`` caveat
    included). ``s_step > 1`` runs the smoothers communication-avoiding;
    ``smoother='jacobi-stream'`` smooths the finest levels through the
    streamed 3D kernel."""
    mesh, dims, specs, axes, cells = _mg_prologue3(b_world, mesh, levels, device)
    program = _mg3_program(mesh, tuple(specs), axes, cells, float(tol), int(max_cycles),
                           int(nu), int(coarse_sweeps), float(omega), smoother, int(s_step))
    x, k, relres = _solve3(program, b_world, mesh, dims)
    warn_unconverged("mg_poisson3d_solve", relres, tol)
    return x, k, relres


def pcg_poisson3d_solve(
    b_world: np.ndarray,
    mesh=None,
    *,
    levels: Optional[int] = None,
    tol: float = 1e-5,
    max_iters: int = 50,
    nu: int = 2,
    coarse_sweeps: int = 16,
    omega: float = 6 / 7,
    smoother: str = "rbgs",
    s_step: int = 1,
    device=None,
):
    """Multigrid-preconditioned CG on the 3D periodic Poisson problem —
    the 2D ``pcg_poisson_solve`` one dimension up: ``(x_world, iters,
    relres)``, a projected symmetric V-cycle preconditioner, true-residual
    stopping."""
    mesh, dims, specs, axes, cells = _mg_prologue3(b_world, mesh, levels, device)
    program = _pcg3_program(mesh, tuple(specs), axes, cells, float(tol), int(max_iters),
                            int(nu), int(coarse_sweeps), float(omega), smoother, int(s_step))
    x, k, relres = _solve3(program, b_world, mesh, dims)
    warn_unconverged("pcg_poisson3d_solve", relres, tol)
    return x, k, relres
