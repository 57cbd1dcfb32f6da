"""Pingpong latency/bandwidth probe over the stacked mesh.

The twin of ``tpuscratch.bench.pingpong``. The reference sends one round
trip of N values GPU to GPU, times it with MPI_Wtime, verifies the echo
and prints PASSED/FAILED (test-benchmark/mpi-pingpong-gpu.cpp:24-87; the
async variant's host-staging ablations at mpi-pingpong-gpu-async.cpp:
43-106). Here a round trip is two ``ppermute`` hops between two ranks of
a stacked mesh. On one card the ranks are slices of one tensor, so a
hop is an on-card copy and no link is crossed: the sweep measures the
copy path, not an interconnect. The host-staging ablations copy through
pinned or pageable host memory, or through a buffer of the native host
pool.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpuscratch_torch.bench.timing import BenchResult, time_device
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.comm.p2p import pingpong
from tpuscratch_torch.native import hostpool
from tpuscratch_torch.runtime import memory
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device

DEFAULT_SIZES = tuple(8 * 4**i for i in range(13))  # 8 B ... 128 MiB (f32)


def pingpong_program(mesh: StackedMesh, axis: str, n_elems: int, a: int = 0, b: int = 1, rounds: int = 1):
    """The SPMD pingpong: rank a's shard bounces to b and back."""
    return run_spmd(mesh, lambda x: pingpong(x, axis, a=a, b=b, rounds=rounds), P(axis), P(axis))


def verify_echo(mesh: StackedMesh, axis: str, n_elems: int) -> bool:
    """PASSED/FAILED self-check: the echoed payload equals the original
    (mpi-pingpong-gpu.cpp:58-61)."""
    n = mesh.size
    payload = np.zeros((n, n_elems), dtype=np.float32)
    payload[0] = np.random.default_rng(0).standard_normal(n_elems)
    # b = n-1: partner rank 1 normally, a self-loop on a 1-rank mesh
    f = pingpong_program(mesh, axis, n_elems, b=n - 1)
    out = f(torch.from_numpy(payload.reshape(-1)).to(mesh.device)).cpu().numpy()
    return bool((out.reshape(n, n_elems)[0] == payload[0]).all())


def sweep(
    mesh: StackedMesh,
    axis: str = "x",
    sizes_bytes: Sequence[int] = DEFAULT_SIZES,
    rounds: int = 1,
    iters: int = 10,
    fence: str = "block",
) -> list[BenchResult]:
    """Latency/bandwidth over message sizes (8 B - 128 MiB by default).
    One round trip moves the payload twice: bytes_moved = 2 * size *
    rounds. p50 over ``iters`` timed repetitions after warmup."""
    n = mesh.size
    results = []
    for size in sizes_bytes:
        n_elems = max(1, size // 4)  # f32 payload
        f = pingpong_program(mesh, axis, n_elems, b=n - 1, rounds=rounds)
        x = torch.zeros(n * n_elems, dtype=torch.float32, device=mesh.device)
        results.append(time_device(
            f, x, iters=iters, warmup=2, fence=fence,
            name=f"pingpong {size}B", bytes_moved=2 * n_elems * 4 * rounds,
        ))
    return results


def host_staging_roundtrip(n_elems: int, iters: int = 10, device=None) -> BenchResult:
    """The HOST_COPY ablation: device -> host -> device staging, timed --
    what keeping the data on the device saves (mpi-pingpong-gpu-async.cpp:
    59-70)."""
    dev = resolve_device(device)
    x = torch.zeros(n_elems, dtype=torch.float32, device=dev)
    return time_device(
        lambda v: v.cpu().to(dev), x, iters=iters, warmup=1,
        name=f"host staging {n_elems * 4}B", bytes_moved=2 * n_elems * 4,
    )


def _buffer_staging(buf: torch.Tensor, n_elems: int, iters: int, label: str, device) -> BenchResult:
    """device -> persistent host buffer -> device, with the buffer's
    allocator as the only variable."""
    dev = resolve_device(device)
    x = torch.zeros(n_elems, dtype=torch.float32, device=dev)

    def stage(v):
        buf.copy_(v)          # D2H into the buffer
        return buf.to(dev)    # H2D out of it

    return time_device(
        stage, x, iters=iters, warmup=1,
        name=f"{label} staging {n_elems * 4}B", bytes_moved=2 * n_elems * 4,
    )


def native_pool_staging_roundtrip(n_elems: int, iters: int = 10, device=None) -> BenchResult:
    """The reference's ``host_allocator`` ablation: stage through a buffer
    of the native pool (``native/src/host_pool.cpp``: page-aligned, mlocked
    where permitted; host_allocator.h:58-93 is the CUDA counterpart,
    exercised the same way by mpi-pingpong-gpu-async.cpp:43-49). Compare
    with ``pageable_buffer_staging_roundtrip``: the same copies, only the
    buffer's allocator differs. The buffer is not registered with the
    card, so its copies stage through the driver as pageable ones do."""
    buf = hostpool.default_pool().alloc(n_elems * 4)
    try:
        host = buf.tensor(torch.float32, (n_elems,))
        try:
            return _buffer_staging(host, n_elems, iters, "native-pool", device)
        finally:
            del host  # the buffer refuses to free while a view is alive
    finally:
        buf.free()


def pageable_buffer_staging_roundtrip(n_elems: int, iters: int = 10, device=None) -> BenchResult:
    """The control of the allocator ablation: the same persistent-buffer
    copies through plain pageable host memory."""
    buf = torch.empty(n_elems, dtype=torch.float32)
    return _buffer_staging(buf, n_elems, iters, "pageable-buffer", device)


def pinned_staging_roundtrip(n_elems: int, pinned: bool = True, iters: int = 10, device=None) -> BenchResult:
    """The PAGE_LOCKED ablation: stage through page-locked vs pageable
    host memory (mpi-pingpong-gpu-async.cpp:43-49)."""
    x = torch.zeros(n_elems, dtype=torch.float32, device=resolve_device(device))
    label = "pinned" if pinned else "pageable"
    return time_device(
        lambda v: memory.host_roundtrip(v, pinned=pinned), x, iters=iters, warmup=1,
        name=f"{label} staging {n_elems * 4}B", bytes_moved=2 * n_elems * 4,
    )
