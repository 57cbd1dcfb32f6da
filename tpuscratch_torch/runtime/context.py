"""Runtime bring-up: the MPI_Init / rank / size / hostname layer.

The twin of ``tpuscratch.runtime.context``. The reference's prologue is
MPI_Init, Comm_size, Comm_rank and Get_processor_name (mpi1.cpp:11-14)
plus binding the process to a GPU (mpi-2d-stencil-subarray-cuda.cu:40-73).
Here ``initialize()`` introspects one process: its hostname, the cards it
sees and their names, and returns an immutable ``RuntimeContext``. The
multi-process rendezvous (``torch.distributed``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Optional

import torch

from tpuscratch_torch.runtime.errors import ErrorPolicy, guarded
from tpuscratch_torch.runtime.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class RuntimeContext:
    """Identity of this process within the job (MPI rank/size analogue)."""

    process_index: int
    process_count: int
    hostname: str
    backend: str
    local_devices: tuple
    global_devices: tuple
    device_names: tuple = ()

    @property
    def is_root(self) -> bool:
        return self.process_index == 0

    @property
    def local_device_count(self) -> int:
        return len(self.local_devices)

    @property
    def global_device_count(self) -> int:
        return len(self.global_devices)

    def hello(self) -> str:
        """'process N of M on HOST: ...' -- the mpi1 hello line
        (mpi1.cpp:15-16) with the device identity the GPU programs log at
        start-up (mpicuda2.cu:203-209)."""
        names = f" ({', '.join(sorted(set(self.device_names)))})" if self.device_names else ""
        return (
            f"process {self.process_index} of {self.process_count} on "
            f"{self.hostname}: {self.local_device_count} local / "
            f"{self.global_device_count} global {self.backend} device(s){names}"
        )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    error_policy: ErrorPolicy = ErrorPolicy.RAISE,
    device=None,
) -> RuntimeContext:
    """This process's identity: the cards of this host (backend ``cuda``),
    or the CPU when ``device='cpu'`` is passed. Raises without a card
    otherwise. The distributed arguments would start a multi-process
    rendezvous, which is not ported: they raise ``NotImplementedError``."""
    if any(a is not None for a in (coordinator_address, num_processes, process_id)):
        raise NotImplementedError(
            "multi-process rendezvous (torch.distributed) is not ported yet "
            "(ROADMAP A7); tpuscratch_torch runs every rank stacked on one card")
    with guarded("runtime initialize", error_policy):
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
            names = tuple(torch.cuda.get_device_name(i) for i in range(len(devices)))
        else:
            devices, names = (dev,), ()
        return RuntimeContext(
            process_index=0,
            process_count=1,
            hostname=socket.gethostname(),
            backend=dev.type,
            local_devices=devices,
            global_devices=devices,
            device_names=names,
        )


def node_census(ctx: RuntimeContext) -> int:
    """Number of distinct hosts in the job (the reference gathers
    hostnames into a set on rank 0, mpicuda2.cu:118-156): one process per
    host, so the process count."""
    return ctx.process_count
