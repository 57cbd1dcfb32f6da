"""Shared example plumbing: device bring-up and pretty printing (the twin
of ``examples/_common.py``).

Every example mirrors one reference program (the mpi1..mpi10 progression,
the CUDA dot products, the stencil drivers, the pingpong benchmarks). Most
need several ranks: here a mesh of 8 ranks stacked on one device, the
card unless the CPU is asked for (``TPUSCRATCH_ON_CPU=1`` or a ``device``
argument) -- the port's form of the reference's trick of many MPI ranks on
one node (mpicuda2.cu:31-32).
"""

from __future__ import annotations

import torch

N_DEVICES = 8


def ensure_devices(n: int = N_DEVICES, device=None) -> torch.device:
    """The device the example's ``n`` stacked ranks run on (see
    ``runtime.hostenv.ensure_devices``); exits with its message when there
    is none."""
    from tpuscratch_torch.runtime import hostenv

    try:
        return hostenv.ensure_devices(n, device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def banner(title: str) -> None:
    print(f"== {title} ==")
