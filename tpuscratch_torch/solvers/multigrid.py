"""Geometric multigrid V-cycle for the periodic Poisson problem.

The twin of ``tpuscratch.solvers.multigrid``: V-cycles of halo-exchanged
smoothing and local inter-level transfers on the torus, every level on
the same 2D mesh with a halved core. Smoothers: damped Jacobi, or
red-black Gauss-Seidel (two masked half-updates a sweep, the default).
Transfers: cell-centered bilinear prolongation and full-weighting
restriction R = P^T/4, with the (2h)^2/h^2 = 4 scaling on the restricted
residual. The singular constant mode is projected out: the solve returns
the zero-mean solution of ``A x = b - mean(b)``.

Values are stacked ``(*mesh, core_h, core_w)``; every slice counts from
the end. The cycle loop is a Python loop whose stop rule (the JAX
package's ``rs > tol**2 rs0`` and its stagnation guard ``rs < 0.5 prev``)
is evaluated on the device in float32 and read as one bool from rank 0:
one host sync a cycle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.halo.exchange import HaloSpec, halo_exchange
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.solvers.cg import _embedded, host_flag, local_sum, relres

#: 1D full-weighting stencil, the adjoint of cell-centered bilinear
#: interpolation (normalized to sum 1).
_W4 = (0.125, 0.375, 0.375, 0.125)


def _padded(core: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """Embed a core tile and fill its 1-ghost ring from the torus."""
    return halo_exchange(_embedded(core, spec), spec)


def periodic_laplacian(core: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """``A @ core`` for the periodic 5-point operator."""
    u = _padded(core, spec)
    return (
        4.0 * u[..., 1:-1, 1:-1]
        - u[..., :-2, 1:-1] - u[..., 2:, 1:-1] - u[..., 1:-1, :-2] - u[..., 1:-1, 2:]
    )


def jacobi_smooth(u, f, spec: HaloSpec, omega: float, sweeps: int):
    """``sweeps`` damped-Jacobi iterations on ``A u = f`` (diagonal 4)."""
    for _ in range(sweeps):
        u = u + (omega / 4.0) * (f - periodic_laplacian(u, spec))
    return u


def _neighbor_sum(u, spec: HaloSpec):
    p = _padded(u, spec)
    return p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]


def rbgs_smooth(u, f, spec: HaloSpec, sweeps: int, reverse: bool = False):
    """``sweeps`` red-black Gauss-Seidel iterations: each color's update is
    one masked expression over the whole tile. The parity is GLOBAL: with
    even core extents every tile's origin has even global coordinates
    (checked). ``reverse`` runs black first — the post-smoother order that
    makes the V-cycle symmetric, which PCG needs of its preconditioner."""
    h, w = spec.layout.core_h, spec.layout.core_w
    if h % 2 or w % 2:
        raise ValueError(f"red-black smoothing needs even core extents, got {h}x{w}")
    ii = torch.arange(h, device=u.device)[:, None]
    jj = torch.arange(w, device=u.device)[None, :]
    red = (ii + jj) % 2 == 0
    first, second = (~red, red) if reverse else (red, ~red)

    def half(u, mask):
        return torch.where(mask, (f + _neighbor_sum(u, spec)) / 4.0, u)

    for _ in range(sweeps):
        u = half(half(u, first), second)
    return u


def restrict_fw(r: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """Full-weighting restriction: [1,3,3,1]/8 tensor stencil over each
    coarse cell's 4x4 fine neighborhood (needs the fine halo)."""
    rp = _padded(r, spec)
    ch, cw = r.shape[-2] // 2, r.shape[-1] // 2
    acc = r.new_zeros(r.shape[:-2] + (ch, cw))
    for a, wa in enumerate(_W4):
        for b, wb in enumerate(_W4):
            acc = acc + wa * wb * rp[..., a:a + 2 * ch - 1:2, b:b + 2 * cw - 1:2]
    return acc


def prolong_bilinear(e: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """Cell-centered bilinear prolongation: each fine cell is the
    (9, 3, 3, 1)/16 blend of its 4 nearest coarse cells (coarse halo)."""
    ep = _padded(e, spec)
    c = ep[..., 1:-1, 1:-1]
    no, so = ep[..., :-2, 1:-1], ep[..., 2:, 1:-1]
    we, ea = ep[..., 1:-1, :-2], ep[..., 1:-1, 2:]
    nw, ne = ep[..., :-2, :-2], ep[..., :-2, 2:]
    sw, se = ep[..., 2:, :-2], ep[..., 2:, 2:]
    f00 = (9 * c + 3 * no + 3 * we + nw) / 16
    f01 = (9 * c + 3 * no + 3 * ea + ne) / 16
    f10 = (9 * c + 3 * so + 3 * we + sw) / 16
    f11 = (9 * c + 3 * so + 3 * ea + se) / 16
    lead, (ch, cw) = e.shape[:-2], e.shape[-2:]
    top = torch.stack([f00, f01], dim=-1).reshape(*lead, ch, 2 * cw)
    bot = torch.stack([f10, f11], dim=-1).reshape(*lead, ch, 2 * cw)
    return torch.stack([top, bot], dim=-2).reshape(*lead, 2 * ch, 2 * cw)


def level_specs(layout: TileLayout, topo, axes, levels: int) -> list[HaloSpec]:
    """One HaloSpec per level; level l's core is the top core >> l."""
    specs = []
    for l in range(levels):
        th, tw = layout.core_h >> l, layout.core_w >> l
        if th < 1 or tw < 1 or (l < levels - 1 and (th % 2 or tw % 2)):
            raise ValueError(
                f"tile {layout.core_h}x{layout.core_w} does not support "
                f"{levels} levels (level {l} would be {th}x{tw})"
            )
        specs.append(HaloSpec(layout=TileLayout(th, tw, 1, 1), topology=topo, axes=axes,
                              neighbors=4))
    return specs


def _smooth(u, f, spec: HaloSpec, omega: float, sweeps: int,
            smoother: str, reverse: bool = False):
    """Smoother dispatch; odd-extent levels (possible at the coarsest)
    fall back to Jacobi, where checkerboard parity cannot be global."""
    if smoother == "rbgs" and spec.layout.core_h % 2 == 0 and spec.layout.core_w % 2 == 0:
        return rbgs_smooth(u, f, spec, sweeps, reverse)
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    return jacobi_smooth(u, f, spec, omega, sweeps)


def v_cycle(
    u, f, specs: list[HaloSpec], level: int = 0,
    nu: int = 2, coarse_sweeps: int = 32, omega: float = 0.8,
    smoother: str = "jacobi",
):
    """One V-cycle on ``A u = f`` at ``level``. Post-smoothing runs the
    smoother in REVERSE color order (rbgs), so the whole cycle is a
    symmetric operator — what PCG needs of its preconditioner."""
    spec = specs[level]
    if level == len(specs) - 1:
        # symmetry needs equal forward/reverse counts: round odd
        # coarse_sweeps up rather than silently de-symmetrizing
        half = (coarse_sweeps + 1) // 2
        u = _smooth(u, f, spec, omega, half, smoother)
        return _smooth(u, f, spec, omega, half, smoother, reverse=True)
    u = _smooth(u, f, spec, omega, nu, smoother)
    r = f - periodic_laplacian(u, spec)
    rc = 4.0 * restrict_fw(r, spec)  # (2h)^2/h^2 keeps the unit-spacing form
    ec = v_cycle(torch.zeros_like(rc), rc, specs, level + 1, nu, coarse_sweeps, omega, smoother)
    u = u + prolong_bilinear(ec, specs[level + 1])
    return _smooth(u, f, spec, omega, nu, smoother, reverse=True)


def _mg_prologue(b_world: np.ndarray, mesh, levels: Optional[int], device=None):
    """Shared driver prologue of the multigrid solvers: mesh, topology,
    per-level specs, with ``levels`` defaulting to the deepest the
    per-rank tile allows (coarsest tile >= 2 in both dims)."""
    from tpuscratch_torch.halo.driver import _setup

    mesh, topo, layout, _ = _setup(b_world.shape, mesh, (1, 1), periodic=True, neighbors=4,
                                   device=device)
    if levels is None:
        levels = 1
        while (
            layout.core_h >> levels >= 2
            and layout.core_w >> levels >= 2
            and (layout.core_h >> (levels - 1)) % 2 == 0
            and (layout.core_w >> (levels - 1)) % 2 == 0
        ):
            levels += 1
    specs = level_specs(layout, topo, tuple(mesh.axis_names), levels)
    cells = float(b_world.shape[0] * b_world.shape[1])
    return mesh, topo, layout, specs, tuple(mesh.axis_names), cells


def cycle_loop(f, cycle, rs_of, rs0, tol: float, max_cycles: int):
    """The JAX package's cycle ``while_loop``: cycle while ``k <
    max_cycles``, ``rs > tol**2 rs0`` and ``rs < 0.5 prev`` (the
    stagnation guard: a healthy cycle contracts the SQUARED norm by ~0.06;
    under 2x means the f32 residual floor). The comparisons run on the
    device in float32; one bool a cycle comes to the host. Returns ``(u,
    cycles, rs)``."""
    stop2 = torch.tensor(tol, dtype=f.dtype, device=f.device) ** 2 * rs0
    u, rs, prev, k = torch.zeros_like(f), rs0, torch.full_like(rs0, np.inf), 0
    while k < max_cycles and host_flag((rs > stop2) & (rs < 0.5 * prev)):
        u = cycle(u)
        u, rs, prev, k = u, rs_of(u), rs, k + 1
    return u, k, rs


def _mg_program(mesh, specs, axes, cells, tol, max_cycles, nu,
                coarse_sweeps, omega, smoother):
    """The V-cycle solver program: stacked right-hand sides -> (solutions,
    cycles, relres)."""
    def local(b_tile):
        b = b_tile[..., 0, 0, :, :]
        f = b - allreduce_sum(local_sum(b), axes) / cells  # project out nullspace

        def rs_of(u):
            r = f - periodic_laplacian(u, specs[0])
            return allreduce_sum(local_sum(r * r), axes)

        rs0 = allreduce_sum(local_sum(f * f), axes)
        u, k, rs = cycle_loop(
            f, lambda u: v_cycle(u, f, specs, 0, nu, coarse_sweeps, omega, smoother),
            rs_of, rs0, tol, max_cycles)
        u = u - allreduce_sum(local_sum(u), axes) / cells  # zero-mean branch
        kt = torch.full(mesh.shape, k, dtype=torch.int32, device=b.device)
        return u[..., None, None, :, :], kt, relres(rs, rs0).reshape(mesh.shape)

    return run_spmd(mesh, local, P(*mesh.axis_names, None, None),
                    (P(*mesh.axis_names, None, None), P(), P()))


def _pcg_program(mesh, specs, axes, cells, tol, max_iters, nu,
                 coarse_sweeps, omega, smoother):
    """The MG-preconditioned CG program."""
    from tpuscratch_torch.solvers.cg import cg

    def local(b_tile):
        b = b_tile[..., 0, 0, :, :]
        f = b - allreduce_sum(local_sum(b), axes) / cells

        def project(v):
            return v - allreduce_sum(local_sum(v), axes) / cells

        def precond(r):
            # projected V-cycle (P M P): f32 rounding leaks a constant
            # component into r, which the V-cycle on the singular torus
            # operator would amplify without bound
            z = v_cycle(torch.zeros_like(r), project(r), specs, 0, nu, coarse_sweeps, omega,
                        smoother)
            return project(z)

        x, k, rel = cg(lambda p: periodic_laplacian(p, specs[0]), f, axes, tol=tol,
                       max_iters=max_iters, precond=precond)
        x = x - allreduce_sum(local_sum(x), axes) / cells
        kt = torch.full(mesh.shape, k, dtype=torch.int32, device=b.device)
        return x[..., None, None, :, :], kt, rel.reshape(mesh.shape)

    return run_spmd(mesh, local, P(*mesh.axis_names, None, None),
                    (P(*mesh.axis_names, None, None), P(), P()))


def warn_unconverged(name: str, relres: float, tol: float) -> None:
    """Surface an unconverged return loudly: the stagnation guard exits
    the cycle loop at the f32 residual floor, which can leave ``relres >
    tol`` looking like a normal return. The 4x slack skips the healthy
    stopped-a-shade-above-the-floor case. Written as ``not (<=)`` so a NaN
    residual also warns."""
    if not (relres <= 4 * tol):
        import warnings

        warnings.warn(
            f"{name}: did not reach tol={tol:g} (relres={relres:.3e}) — "
            "stagnated at the dtype residual floor or hit the cycle cap; "
            "check the returned relres",
            RuntimeWarning,
            stacklevel=3,
        )


def _solve(program, b_world, mesh, topo, layout):
    """Decompose, run, reassemble: ``(x_world, iters, relres)``."""
    from tpuscratch_torch.halo.driver import assemble, decompose

    flat = TileLayout(layout.core_h, layout.core_w, 0, 0)
    b = torch.from_numpy(decompose(np.asarray(b_world), topo, flat)).to(mesh.device)
    x_tiles, k, rel = program(b)
    return assemble(x_tiles.cpu().numpy(), topo, flat), int(k), float(rel)


def mg_poisson_solve(
    b_world: np.ndarray,
    mesh=None,
    *,
    levels: Optional[int] = None,
    tol: float = 1e-5,
    max_cycles: int = 50,
    nu: int = 2,
    coarse_sweeps: int = 32,
    omega: float = 0.8,
    smoother: str = "rbgs",
    device=None,
):
    """Solve ``A x = b - mean(b)`` (periodic 5-point Laplacian) by
    V-cycles over a 2D mesh (default 1x1 on ``device``, the card unless
    ``device='cpu'``). Returns ``(x_world, cycles, relres)`` with zero-mean
    ``x``. ``omega`` applies to the Jacobi smoother only. ``relres`` is the
    verdict: the stagnation guard may stop above ``tol`` at the f32
    residual floor (a ``RuntimeWarning`` fires past 4x ``tol``)."""
    mesh, topo, layout, specs, axes, cells = _mg_prologue(b_world, mesh, levels, device)
    program = _mg_program(mesh, tuple(specs), axes, cells, float(tol), int(max_cycles),
                          int(nu), int(coarse_sweeps), float(omega), smoother)
    x, k, relres = _solve(program, b_world, mesh, topo, layout)
    warn_unconverged("mg_poisson_solve", relres, tol)
    return x, k, relres


def pcg_poisson_solve(
    b_world: np.ndarray,
    mesh=None,
    *,
    levels: Optional[int] = None,
    tol: float = 1e-5,
    max_iters: int = 50,
    nu: int = 2,
    coarse_sweeps: int = 16,
    omega: float = 0.8,
    smoother: str = "rbgs",
    device=None,
):
    """Multigrid-preconditioned CG on the periodic Poisson problem: one
    symmetric V-cycle as the preconditioner (nu pre == nu post sweeps, the
    post-smoother in reverse color order, adjoint transfers), projected on
    the zero-mean subspace. Same contract as :func:`mg_poisson_solve`:
    ``(x_world, iters, relres)``."""
    mesh, topo, layout, specs, axes, cells = _mg_prologue(b_world, mesh, levels, device)
    program = _pcg_program(mesh, tuple(specs), axes, cells, float(tol), int(max_iters),
                           int(nu), int(coarse_sweeps), float(omega), smoother)
    x, k, relres = _solve(program, b_world, mesh, topo, layout)
    warn_unconverged("pcg_poisson_solve", relres, tol)
    return x, k, relres
