"""Spectral (FFT) solver for the periodic Poisson problem.

The twin of ``tpuscratch.solvers.spectral``: the periodic 5-point (7-point
in 3D) Laplacian is diagonal in Fourier space, so one distributed FFT
round trip — two all_to_all transposes and a pointwise eigenvalue divide —
solves it. The operator is singular on the constant mode; the solve
projects it out and returns the zero-mean solution.

Eigenvalues in the sin² form ``4 sin²(πk/H) + 4 sin²(πl/W)`` (no
cancellation in f32), singular exactly at the k = l = 0 mode.

Two transform backends (``parallel.fft``): ``impl='xla'`` runs the
complex64 ``torch.fft`` path, ``impl='dft'`` the (re, im) float32 pair
path, ``'auto'`` picks as ``complex_supported`` says.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.comm.spmd import P, axis_index, run_spmd
from tpuscratch_torch.parallel.fft import (
    complex_supported,
    fft2_sharded,
    fft2_sharded_pair,
    fft3_sharded,
    fft3_sharded_pair,
    ifft2_from_pencil,
    ifft2_from_pencil_pair,
    ifft3_from_pencil,
    ifft3_from_pencil_pair,
)
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_1d, resolve_device


def periodic_laplacian_np(x: np.ndarray) -> np.ndarray:
    """Numpy oracle: periodic 5-point operator (positive-semidefinite)."""
    return (
        4.0 * x
        - np.roll(x, 1, 0) - np.roll(x, -1, 0)
        - np.roll(x, 1, 1) - np.roll(x, -1, 1)
    )


def _resolve(impl: str) -> str:
    if impl == "auto":
        impl = "xla" if complex_supported() else "dft"
    if impl not in ("xla", "dft"):
        raise ValueError(f"impl must be auto|xla|dft, got {impl!r}")
    return impl


def _mesh_1d(mesh: Optional[StackedMesh], device) -> StackedMesh:
    if mesh is None:
        return make_mesh_1d("x", device=device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} != mesh device {mesh.device}")
    return mesh


def _inv(lam: torch.Tensor, singular: torch.Tensor) -> torch.Tensor:
    return torch.where(singular, 0.0, 1.0 / torch.where(singular, 1.0, lam))


def periodic_poisson_fft(
    b_world: np.ndarray, mesh: Optional[StackedMesh] = None, impl: str = "auto",
    device=None,
):
    """Solve ``A x = b - mean(b)`` for the periodic 5-point Laplacian.

    Rows of the grid are split over a 1D mesh (default: one rank on
    ``device``, the card unless ``device='cpu'``). Returns the zero-mean
    ``x_world``; the residual is machine precision, not iterative — there
    is no tolerance knob.
    """
    impl = _resolve(impl)
    mesh = _mesh_1d(mesh, device)
    (ax,) = mesh.axis_names
    n = mesh.size
    gh, gw = b_world.shape
    if gh % n or gw % n:
        raise ValueError(
            f"grid {b_world.shape} needs both dims divisible by the "
            f"{n}-rank mesh (rows for the shard, cols for the transpose)"
        )
    program = _spectral_program(mesh, ax, n, gh, gw, impl)
    b = torch.from_numpy(np.ascontiguousarray(b_world)).to(mesh.device)
    return program(b).cpu().numpy()


def _spectral_program(mesh, ax, n, gh, gw, impl):
    """The spectral program: the (gh, gw) world -> its solution."""
    def inv_eigenvalues(d):
        # d: each rank's index, (n,); the pencil is (gh, gw/n), columns
        # d*(gw/n) ... of the global spectrum
        dev = d.device
        k = torch.arange(gh, dtype=torch.float32, device=dev)
        l = d[:, None] * (gw // n) + torch.arange(gw // n, dtype=torch.float32, device=dev)
        lam = (
            4.0 * torch.sin(math.pi * k / gh)[:, None] ** 2
            + 4.0 * torch.sin(math.pi * l / gw)[..., None, :] ** 2
        )
        singular = (k == 0)[:, None] & (l == 0)[..., None, :]
        return _inv(lam, singular)

    def local(b):
        inv = inv_eigenvalues(axis_index(ax))
        if impl == "dft":
            re, im = fft2_sharded_pair(b, torch.zeros_like(b), ax, restore_layout=False)
            re, _ = ifft2_from_pencil_pair(re * inv, im * inv, ax)
            return re.to(b.dtype)
        hat = fft2_sharded(b, ax, restore_layout=False)  # (gh, gw/n) pencil
        return torch.real(ifft2_from_pencil(hat * inv, ax)).to(b.dtype)

    return run_spmd(mesh, local, P(ax), P(ax))


def periodic_poisson3d_fft(
    b_world: np.ndarray, mesh: Optional[StackedMesh] = None, impl: str = "auto",
    device=None,
):
    """Solve ``A x = b - mean(b)`` for the periodic 7-point Laplacian —
    :func:`periodic_poisson_fft` one dimension up, over the 3D pencil FFT:
    z-slabs split over a 1D mesh, ONE all_to_all per transform direction,
    eigenvalues ``4 sin²(πk/Z) + 4 sin²(πl/Y) + 4 sin²(πm/X)``. Same
    backend contract as the 2D solver."""
    impl = _resolve(impl)
    mesh = _mesh_1d(mesh, device)
    (ax,) = mesh.axis_names
    n = mesh.size
    gz, gy, gx = b_world.shape
    if gz % n or gy % n:
        raise ValueError(
            f"grid {b_world.shape} needs Z and Y divisible by the "
            f"{n}-rank mesh (Z for the shard, Y for the transpose)"
        )
    program = _spectral3_program(mesh, ax, n, gz, gy, gx, impl)
    b = torch.from_numpy(np.ascontiguousarray(b_world)).to(mesh.device)
    return program(b).cpu().numpy()


def _spectral3_program(mesh, ax, n, gz, gy, gx, impl):
    def inv_eigenvalues(d):
        # pencil layout (X, Y/n, Z): kx full, ky this rank's shard, kz full
        dev = d.device
        m = torch.arange(gx, dtype=torch.float32, device=dev)
        l = d[:, None] * (gy // n) + torch.arange(gy // n, dtype=torch.float32, device=dev)
        k = torch.arange(gz, dtype=torch.float32, device=dev)
        lam = (
            4.0 * torch.sin(math.pi * m / gx)[:, None, None] ** 2
            + 4.0 * torch.sin(math.pi * l / gy)[..., None, :, None] ** 2
            + 4.0 * torch.sin(math.pi * k / gz)[None, None, :] ** 2
        )
        singular = (
            (m == 0)[:, None, None]
            & (l == 0)[..., None, :, None]
            & (k == 0)[None, None, :]
        )
        return _inv(lam, singular)

    def local(b):
        inv = inv_eigenvalues(axis_index(ax))
        if impl == "dft":
            re, im = fft3_sharded_pair(b, torch.zeros_like(b), ax, restore_layout=False)
            re, _ = ifft3_from_pencil_pair(re * inv, im * inv, ax)
            return re.to(b.dtype)
        hat = fft3_sharded(b, ax, restore_layout=False)  # (X, Y/n, Z)
        return torch.real(ifft3_from_pencil(hat * inv, ax)).to(b.dtype)

    return run_spmd(mesh, local, P(ax), P(ax))
