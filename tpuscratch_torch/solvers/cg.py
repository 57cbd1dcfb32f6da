"""Distributed conjugate gradient on the 2D 5-point Laplacian.

The twin of ``tpuscratch.solvers.cg``: the matvec is a halo exchange and
a local stencil, every inner product a per-rank sum and an
``allreduce_sum`` — the reference's two flagships (the halo exchange of
``stencil2D.h`` and the allreduced dot of ``mpicuda2-4.cu``) in one loop.

On the stacked mesh a value is ``(*mesh, *local)``: a rank's sum runs over
its LOCAL dims only (a whole-tensor sum would add every rank's and is
right on a one-rank mesh alone), and a replicated scalar is a
``(*mesh, 1, ...)`` tensor that broadcasts against the vectors.

The JAX package runs the iteration in one ``lax.while_loop`` on the
device; here it is a Python loop. The stop rule is evaluated on the
device in float32, as there (``rs > tol**2 * rs0``), and its one bool is
read from rank 0 (the scalars are replicated): ONE host sync an
iteration, which is what keeps the iteration count the JAX package's.

Operator convention: ``A u = 4 u - u_up - u_down - u_left - u_right``
with zero-Dirichlet boundaries: the topology is open, and the exchange
keeps an open side's ghosts (MPI_PROC_NULL), zeros, because the matvec
embeds the core into a zeroed padded tile each application.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.spmd import P, current_mesh, run_spmd
from tpuscratch_torch.halo.exchange import HaloSpec, halo_exchange
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.runtime.mesh import StackedMesh


def local_sum(x: torch.Tensor) -> torch.Tensor:
    """Each rank's sum of its local block, kept as ``(*mesh, 1, ...)``."""
    lead = len(current_mesh().shape)
    return x.sum(dim=tuple(range(lead, x.ndim)), keepdim=True)


def host_flag(t: torch.Tensor) -> bool:
    """Rank 0's entry of a replicated bool tensor: one host sync."""
    return bool(t.reshape(-1)[0])


def relres(rs: torch.Tensor, rs0: torch.Tensor) -> torch.Tensor:
    """``sqrt(rs / rs0)``, the relative residual norm (rs0 kept off 0)."""
    return torch.sqrt(rs / rs0.clamp_min(torch.finfo(rs.dtype).tiny))


def _embedded(core: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """A zero padded tile holding ``core`` (halo 1 on both axes)."""
    padded = core.new_zeros(core.shape[:-2] + spec.layout.padded_shape)
    padded[..., 1:-1, 1:-1] = core
    return padded


def dirichlet_laplacian(core: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """``A @ core`` for the zero-Dirichlet 5-point Laplacian, on the
    stacked ``(rows, cols, core_h, core_w)`` cores. One halo exchange fills
    the distance-1 neighbor strips; open boundaries stay zero."""
    lay = spec.layout
    if (lay.halo_y, lay.halo_x) != (1, 1):
        raise ValueError(f"5-point operator needs halo (1,1), got layout {lay}")
    if spec.neighbors != 4:
        raise ValueError("use neighbors=4: corner transfers are dead weight here")
    u = halo_exchange(_embedded(core, spec), spec)
    return (
        4.0 * u[..., 1:-1, 1:-1]
        - u[..., :-2, 1:-1]
        - u[..., 2:, 1:-1]
        - u[..., 1:-1, :-2]
        - u[..., 1:-1, 2:]
    )


def cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    axes,
    *,
    tol: float = 1e-5,
    max_iters: int = 1000,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """(Preconditioned) conjugate gradient for SPD ``matvec`` over mesh
    ``axes``.

    Call inside ``run_spmd``: ``b`` is the stacked local shards,
    ``matvec`` maps them to the same (doing its own neighbor
    communication), and inner products are per-rank sums allreduced over
    ``axes``. Runs until ``||r|| <= tol * ||b||`` or ``max_iters``.
    ``precond``, when given, applies an SPD approximation of ``A^-1``;
    convergence is measured on the TRUE residual norm ``r.r``.

    Two allreduces an iteration: ``p.Ap``, and ``(r.z, r.r)`` stacked into
    one (:func:`pipelined_cg` folds them into one). One host sync an
    iteration reads the stop rule.

    Returns ``(x, iters, relres)``: the stacked solution, the iterations
    taken (an int) and the relative residual norm (a replicated
    ``(*mesh, 1, ...)`` tensor).
    """
    dtype = b.dtype

    def gdot(u, v):
        return allreduce_sum(local_sum(u * v), axes)

    def rz_rs(r, z):
        """(r.z, r.r) as ONE stacked collective, unconditionally."""
        both = allreduce_sum(torch.stack([local_sum(r * z), local_sum(r * r)], dim=-1), axes)
        return both[..., 0], both[..., 1]

    x = torch.zeros_like(b)
    r = b
    p = b if precond is None else precond(b)
    rz, rs0 = rz_rs(b, p)         # rs is the TRUE residual stop rule
    rs = rs0
    stop2 = torch.tensor(tol, dtype=dtype, device=b.device) ** 2 * rs0
    k = 0
    while k < max_iters and host_flag(rs > stop2):
        ap = matvec(p)
        alpha = rz / gdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r if precond is None else precond(r)
        rz_new, rs = rz_rs(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k, relres(rs, rs0)


def pipelined_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    axes,
    *,
    tol: float = 1e-5,
    max_iters: int = 1000,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    replace_every: int = 96,
):
    """Ghysels–Vanroose pipelined CG: ONE stacked allreduce an iteration.

    Same contract as :func:`cg`. The auxiliary vectors ``w = A u``, ``z =
    A q`` etc. are carried so that the three scalars an iteration needs —
    ``gamma = r.u``, ``delta = w.u`` and ``r.r`` for the stop rule — are
    products of vectors already at hand and fold into one length-3
    allreduce. Every ``replace_every`` iterations the residual chain is
    refreshed from its definition (``r = b - Ax``, ``u = Mr``, ``w = Au``)
    and the next iteration restarts the Krylov process (``beta = 0``), the
    JAX package's remedy for f32 recurrence drift. Whether an iteration
    restarts or refreshes turns on the host's iteration count, so neither
    costs a sync; the stop rule costs one an iteration, as in :func:`cg`.
    ``precond`` must be SPD.
    """
    dtype = b.dtype
    apply_m = (lambda v: v) if precond is None else precond

    def fused3(r, u, w):
        """(r.u, w.u, r.r) — THE one collective per iteration."""
        out = allreduce_sum(
            torch.stack([local_sum(r * u), local_sum(w * u), local_sum(r * r)], dim=-1), axes)
        return out[..., 0], out[..., 1], out[..., 2]

    x = torch.zeros_like(b)
    r = b
    u = apply_m(r)
    w = matvec(u)
    gamma, delta, rs0 = fused3(r, u, w)
    rs = rs0
    stop2 = torch.tensor(tol, dtype=dtype, device=b.device) ** 2 * rs0
    zv = q = s = p = torch.zeros_like(b)
    gamma_prev = alpha_prev = torch.ones_like(gamma)
    k = 0
    while k < max_iters and host_flag(rs > stop2):
        m = apply_m(w)
        n = matvec(m)
        # a segment start (k = 0 or just-refreshed state) restarts the
        # Krylov process: beta = 0 discards the stale direction history
        if k % replace_every == 0:
            beta = torch.zeros_like(gamma)
            denom = delta
        else:
            beta = gamma / gamma_prev
            denom = delta - beta * gamma / alpha_prev
        alpha = gamma / denom
        zv = n + beta * zv
        q = m + beta * q
        s = w + beta * s
        p = u + beta * p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * zv
        if (k + 1) % replace_every == 0:
            r = b - matvec(x)
            u = apply_m(r)
            w = matvec(u)
        gamma_prev, alpha_prev = gamma, alpha
        gamma, delta, rs = fused3(r, u, w)
        k += 1
    return x, k, relres(rs, rs0)


#: poisson_solve method name -> solver loop
METHODS = {"cg": cg, "pipelined": pipelined_cg}


def _poisson_program(mesh: StackedMesh, spec: HaloSpec, tol: float, iters: int,
                     method: str = "cg"):
    """The CG program: stacked ``(rows, cols, core_h, core_w)`` right-hand
    sides -> (solutions, iterations, relres)."""
    solver = METHODS[method]
    axes = tuple(mesh.axis_names)

    def local(b_tile):
        b = b_tile[..., 0, 0, :, :]
        x, k, rel = solver(lambda p: dirichlet_laplacian(p, spec), b, axes,
                           tol=tol, max_iters=iters)
        # the iteration count as a replicated value, as the JAX program returns it
        kt = torch.full(mesh.shape, k, dtype=torch.int32, device=b.device)
        return x[..., None, None, :, :], kt, rel.reshape(mesh.shape)

    return run_spmd(mesh, local, P(*mesh.axis_names, None, None),
                    (P(*mesh.axis_names, None, None), P(), P()))


def poisson_solve(
    b_world: np.ndarray,
    mesh: Optional[StackedMesh] = None,
    *,
    tol: float = 1e-5,
    max_iters: Optional[int] = None,
    method: str = "cg",
    device=None,
):
    """Solve ``A x = b`` (zero-Dirichlet 5-point Laplacian) distributed:
    decompose ``b`` over a 2D mesh (default 1x1 on ``device``, the card
    unless ``device='cpu'``), run the CG program, reassemble. Returns
    ``(x_world, iters, relres)``. ``method='pipelined'`` selects the
    single-reduction loop (:func:`pipelined_cg`)."""
    from tpuscratch_torch.halo.driver import _setup, assemble, decompose

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {tuple(METHODS)}")
    gh, gw = b_world.shape
    mesh, topo, layout, spec = _setup(b_world.shape, mesh, (1, 1), periodic=False,
                                      neighbors=4, device=device)
    iters = max_iters if max_iters is not None else gh * gw
    program = _poisson_program(mesh, spec, float(tol), int(iters), method)
    # CG state vectors are core tiles (no ghost ring): decompose/assemble
    # with a halo-0 view of the same layout
    flat = TileLayout(layout.core_h, layout.core_w, 0, 0)
    b = torch.from_numpy(decompose(np.asarray(b_world), topo, flat)).to(mesh.device)
    x_tiles, k, rel = program(b)
    return assemble(x_tiles.cpu().numpy(), topo, flat), int(k), float(rel)


def laplacian_apply_np(x: np.ndarray) -> np.ndarray:
    """Numpy oracle for ``dirichlet_laplacian`` on the whole grid (a copy
    of the JAX package's)."""
    p = np.pad(x, 1)
    return 4.0 * x - p[:-2, 1:-1] - p[2:, 1:-1] - p[1:-1, :-2] - p[1:-1, 2:]
