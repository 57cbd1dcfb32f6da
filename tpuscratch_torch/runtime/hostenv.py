"""Host-environment control: which device a program of the port runs on.

The twin of ``tpuscratch.runtime.hostenv``, with the port's meaning. The
JAX package pins a virtual CPU mesh of N devices so that multi-rank code
runs on one box (the reference's trick of many MPI ranks on one node,
mpicuda2.cu:31-32), and uses real hardware only when
``TPUSCRATCH_ON_DEVICE`` asks for it. Here a mesh of N ranks is stacked on
ONE device (``runtime.mesh``), so nothing is pinned: the question is only
which device. Entry points run on the card unless the caller asks for the
CPU, by an argument or by ``TPUSCRATCH_ON_CPU`` (the twin of
``TPUSCRATCH_ON_DEVICE``: set, the plain CPU path runs). Without a card
and without that request, ``ensure_devices`` raises, as
``runtime.mesh.resolve_device`` does: nothing falls back to the CPU
quietly.
"""

from __future__ import annotations

import os

import torch

from tpuscratch_torch.runtime.mesh import resolve_device

#: set to 1 / true / yes / on: run the plain CPU path
CPU_ENV = "TPUSCRATCH_ON_CPU"
_TRUTHY = ("1", "true", "yes", "on")


def force_cpu_devices(n: int = 8) -> None:
    """Make this process's entry points run on the CPU, for a stacked mesh
    of up to ``n`` ranks (any ``n``: the ranks share the one device)."""
    if n < 1:
        raise ValueError(f"need >= 1 ranks, got {n}")
    os.environ[CPU_ENV] = "1"


def on_device_requested() -> bool:
    """True unless ``TPUSCRATCH_ON_CPU`` asks for the CPU: the port runs on
    the card by default (the JAX package's default is the virtual CPU
    mesh)."""
    return os.environ.get(CPU_ENV, "").strip().lower() not in _TRUTHY


def ensure_devices(n: int = 8, device=None) -> torch.device:
    """The device a program of ``n`` stacked ranks runs on: ``device``
    when given, else the CPU if ``TPUSCRATCH_ON_CPU`` asks for it, else the
    current card. Raises without a card unless the CPU was asked for."""
    if n < 1:
        raise ValueError(f"need >= 1 ranks, got {n}")
    if device is None and not on_device_requested():
        device = "cpu"
    return resolve_device(device)
