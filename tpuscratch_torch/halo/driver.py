"""Whole-grid drivers: decompose, iterate, reassemble.

The twin of ``tpuscratch.halo.driver``: cut the world into per-rank
padded tiles, run ``steps`` exchange+compute iterations on the stacked
``(rows, cols, ph, pw)`` tensor, and reassemble the cores. ``decompose``,
``assemble`` and ``distributed_stencil`` take and return numpy arrays, so
a state saved by the JAX package (``np.asarray`` of its tiles, a
checkpoint's ``.npy``) continues here through ``tiles_from_numpy``.
``checkpointed_stencil`` is ``distributed_stencil`` in chunks of
``save_every`` steps over the chunked runtime (``runtime.chunked``):
checkpointed, resumable bit for bit (from either package's checkpoints),
elastic over the mesh shape with ``reshard=True``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.halo.exchange import HaloSpec
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import (
    JACOBI,
    run_stencil,
    run_stencil_deep,
    run_stencil_resident,
    run_stencil_stream,
)
from tpuscratch_torch.ops.halo_dma import run_stencil_dma, run_stencil_dma_hbm
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_2d, resolve_device, topology_of
from tpuscratch_torch.runtime.topology import CartTopology


def decompose(world: np.ndarray, topo: CartTopology, layout: TileLayout) -> np.ndarray:
    """Cut a (rows*core_h, cols*core_w) world into padded per-rank tiles of
    shape (rows, cols, padded_h, padded_w); ghost borders start at zero
    (they are filled by the first exchange)."""
    rows, cols = topo.dims
    th, tw = layout.core_h, layout.core_w
    if world.shape != (rows * th, cols * tw):
        raise ValueError(
            f"world {world.shape} != grid {(rows * th, cols * tw)}"
        )
    tiles = np.zeros((rows, cols) + layout.padded_shape, dtype=world.dtype)
    hy, hx = layout.halo_y, layout.halo_x
    for r in range(rows):
        for c in range(cols):
            tiles[r, c, hy : hy + th, hx : hx + tw] = world[
                r * th : (r + 1) * th, c * tw : (c + 1) * tw
            ]
    return tiles


def assemble(tiles: np.ndarray, topo: CartTopology, layout: TileLayout) -> np.ndarray:
    """Inverse of decompose: concatenate the cores back into the world."""
    rows, cols = topo.dims
    th, tw = layout.core_h, layout.core_w
    hy, hx = layout.halo_y, layout.halo_x
    world = np.zeros((rows * th, cols * tw), dtype=tiles.dtype)
    for r in range(rows):
        for c in range(cols):
            world[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = tiles[
                r, c, hy : hy + th, hx : hx + tw
            ]
    return world


def tiles_from_numpy(np_tiles: np.ndarray, device=None) -> torch.Tensor:
    """Stacked tiles (rows, cols, ph, pw) from numpy onto ``device`` (the
    card unless the caller asks for the CPU), bit for bit — e.g. the
    state of a JAX run, to continue it here."""
    if np_tiles.ndim != 4:
        raise ValueError(f"want (rows, cols, ph, pw) tiles, got {np_tiles.shape}")
    host = torch.from_numpy(np.array(np_tiles, order="C", copy=True))
    return host.to(resolve_device(device))


def tiles3d_from_numpy(np_tiles: np.ndarray, device=None) -> torch.Tensor:
    """Stacked 3D tiles (mz, my, mx, pz, py, px) from numpy onto ``device``
    (the card unless the caller asks for the CPU), bit for bit."""
    if np_tiles.ndim != 6:
        raise ValueError(f"want (mz, my, mx, pz, py, px) tiles, got {np_tiles.shape}")
    host = torch.from_numpy(np.array(np_tiles, order="C", copy=True))
    return host.to(resolve_device(device))


def cores3d_from_numpy(np_cores: np.ndarray, device=None) -> torch.Tensor:
    """Stacked 3D cores (mz, my, mx, cz, cy, cx), the state the compact and
    stream impls of ``halo.halo3d`` carry, from numpy onto ``device``."""
    return tiles3d_from_numpy(np_cores, device)


#: Impls that run one exchange and one update a step.
PER_STEP = ("xla", "pallas", "blocked", "overlap")


def _depth(impl: str, default: int) -> int:
    """The ``:k`` depth of an impl string (``stream:16``, ``dma-deep:8``)."""
    depth = int(impl.split(":", 1)[1]) if ":" in impl else default
    if depth < 1:
        raise ValueError(f"{impl.split(':')[0]} depth must be >= 1, got {impl!r}")
    return depth


def make_stencil_program(
    mesh: StackedMesh,
    spec: HaloSpec,
    steps: int,
    coeffs=JACOBI,
    impl: str = "xla",
    unroll: int | None = None,
):
    """The program: (rows, cols, ph, pw) tiles on ``mesh.device`` -> same,
    after ``steps`` exchange+compute iterations. ``impl``:

    - ``xla``, ``overlap``, ``pallas``, ``blocked``: one exchange per step;
    - ``deep`` / ``deep-pallas``: the communication-avoiding trapezoid
      (depth = the layout halo width; torch ops / the shared-memory kernel);
    - ``resident``: the single-device one-launch kernel;
    - ``stream[:k]``: the streamed kernel, k substeps a launch (default 8);
    - ``dma``: the DMA-halo ring kernel, all steps in one launch;
      ``dma-deep:k``: its depth-k kernel, k substeps a launch;
      ``dma-hbm``: one launch per step.

    9-point coefficients run on ``xla``, the ``dma`` impls and ``stream``.
    ``unroll`` is accepted for the JAX package's signature."""
    if len(coeffs) == 9 and impl != "xla" and not impl.startswith(("dma", "stream")):
        raise ValueError(
            f"9-point coeffs need impl='xla', a dma impl, or 'stream:k', got {impl!r}"
        )
    if tuple(spec.topology.dims) != tuple(mesh.shape):
        raise ValueError(f"spec topology {spec.topology.dims} != mesh {mesh.shape}")
    if impl == "resident":
        run = lambda t: run_stencil_resident(t, spec, steps, coeffs, unroll=8 if unroll is None else unroll)  # noqa: E731
    elif impl == "dma-hbm":
        run = lambda t: run_stencil_dma_hbm(t, spec, steps, coeffs)  # noqa: E731
    elif impl == "stream" or impl.startswith("stream:"):
        sdepth = _depth(impl, 8)
        run = lambda t: run_stencil_stream(t, spec, steps, coeffs, sdepth)  # noqa: E731
    elif impl == "dma" or impl.startswith("dma-deep:"):
        depth = _depth(impl, 1)
        run = lambda t: run_stencil_dma(t, spec, steps, coeffs, depth)  # noqa: E731
    elif impl in ("deep", "deep-pallas"):
        sub = "pallas" if impl == "deep-pallas" else "xla"
        run = lambda t: run_stencil_deep(t, spec, steps, coeffs, impl=sub)  # noqa: E731
    elif impl in PER_STEP:
        run = lambda t: run_stencil(t, spec, steps, coeffs, impl, unroll or 1)  # noqa: E731
    else:
        raise ValueError(f"unknown stencil impl {impl!r}")

    def program(tiles: torch.Tensor) -> torch.Tensor:
        if tiles.device != mesh.device:
            raise ValueError(f"tiles on {tiles.device}, mesh on {mesh.device}")
        return run(tiles)

    return program


def _setup(world_shape, mesh: Optional[StackedMesh], halo, periodic: bool,
           neighbors: int = 8, device=None):
    """Shared driver prologue: default mesh, topology, divisibility check,
    layout and spec construction."""
    if mesh is None:
        mesh = make_mesh_2d(device=device)
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} != mesh device {mesh.device}")
    topo = topology_of(mesh, periodic=periodic)
    rows, cols = topo.dims
    if world_shape[0] % rows or world_shape[1] % cols:
        raise ValueError(f"world {world_shape} not divisible by mesh {topo.dims}")
    layout = TileLayout(
        world_shape[0] // rows, world_shape[1] // cols, halo[0], halo[1]
    )
    spec = HaloSpec(layout=layout, topology=topo, axes=tuple(mesh.axis_names),
                    neighbors=neighbors)
    return mesh, topo, layout, spec


def _chunk_impl(impl: str, halo: tuple[int, int]):
    """(impl, halo, unroll) of a chunked run's impl string: ``deep:k`` and
    ``deep-pallas:k`` name the trapezoid depth (a k x k halo, which must
    agree with a non-default ``halo``), ``resident:U`` the resident
    kernel's unroll; any other impl passes through."""
    base, _, arg = impl.partition(":")
    if base in ("deep", "deep-pallas") and arg:
        k = _depth(impl, 1)
        if tuple(halo) not in ((1, 1), (k, k)):
            raise ValueError(f"impl {impl!r} sets a {k}x{k} halo, the caller asked for {halo}")
        return base, (k, k), None
    if base == "resident" and arg:
        return base, tuple(halo), _depth(impl, 8)
    return impl, tuple(halo), None


def checkpointed_stencil(
    world: np.ndarray,
    steps: int,
    ckpt_dir: str,
    save_every: int = 100,
    mesh: Optional[StackedMesh] = None,
    halo: tuple[int, int] = (1, 1),
    coeffs=JACOBI,
    impl: str = "xla",
    periodic: bool = True,
    keep: int = 3,
    sink=None,
    chaos=None,
    recorder=None,
    reshard: bool = False,
    async_ckpt: bool = False,
    device=None,
) -> np.ndarray:
    """``distributed_stencil`` with preemption survival: the tile state is
    checkpointed every ``save_every`` steps and the run RESUMES from the
    newest checkpoint in ``ckpt_dir`` when one exists. The mesh defaults
    to 1x1 on ``device`` (the card unless ``device='cpu'``). Besides
    ``make_stencil_program``'s impls, ``deep:k`` / ``deep-pallas:k`` set
    the trapezoid's depth (a k x k halo) and ``resident:U`` the resident
    kernel's unroll, as the stencil bench reads them; each chunk runs one
    program of ``save_every`` steps with that impl.

    ``reshard=True`` makes the resume ELASTIC over the mesh shape: a
    checkpoint whose tiles were decomposed for a different process grid
    (a preempted-and-shrunk slice) is loaded in its saved layout,
    reassembled to the world, and re-decomposed onto THIS mesh — the
    cores round-trip exactly (ghosts are refilled by every step's
    leading exchange), so the continued run computes the same cells.
    Off (the default), a mismatched-mesh resume fails loudly at leaf
    validation.

    ``async_ckpt=True`` switches the saves to the snapshot-then-publish
    path (``runtime.async_ckpt``): the loop pays only the host-copy
    wall (``ckpt/snapshot`` events), the serialize+publish overlaps the
    next chunk on a background writer (``ckpt/write``), and the barrier
    drains before each snapshot, at preemption points, and at exit —
    published checkpoints byte-identical to the blocking path's.

    ``sink`` (an ``obs.sink.Sink``) receives one ``halo/chunk`` event
    per save chunk — step reached, fenced wall seconds, cell-updates/s —
    plus one ``ckpt/save`` event per save (its wall seconds feed the
    goodput checkpoint bucket) — the same telemetry the trainer emits.
    ``recorder`` (an ``obs.trace.FlightRecorder``; a fresh bounded one
    when absent) collects ``halo/chunk``/``ckpt/save`` spans for
    Chrome-trace export and emits cumulative ``trace/phase`` totals at
    the end of the run.

    ``chaos`` (an ``ft.ChaosPlan``) plugs the fault injector in: a
    transient ``comm/halo_chunk`` CommError around each compiled chunk,
    checkpoint-IO faults through ``save``'s stage hook (saves run under
    ``ft.retry``), and ``halo/preempt`` — a simulated preemption AFTER a
    chunk's save, the supervisor's restartable signal.  Absent (the
    default), no hook code runs.

    A killed run re-invoked with the same arguments continues where the
    last atomic save landed and produces a BIT-IDENTICAL result to an
    uninterrupted run (same chunk boundaries, exact f32 round trip through
    the .npy format, kernels that give the same bits every call); the JAX
    package's checkpoints continue here too (the same format and layout).
    """
    return checkpointed_stencil_program(
        world, steps, ckpt_dir, save_every=save_every, mesh=mesh, halo=halo,
        coeffs=coeffs, impl=impl, periodic=periodic, keep=keep, sink=sink,
        chaos=chaos, recorder=recorder, reshard=reshard,
        async_ckpt=async_ckpt, device=device,
    ).run()


def checkpointed_stencil_program(
    world: np.ndarray,
    steps: int,
    ckpt_dir: str,
    save_every: int = 100,
    mesh: Optional[StackedMesh] = None,
    halo: tuple[int, int] = (1, 1),
    coeffs=JACOBI,
    impl: str = "xla",
    periodic: bool = True,
    keep: int = 3,
    sink=None,
    chaos=None,
    recorder=None,
    reshard: bool = False,
    async_ckpt: bool = False,
    workload: str = "halo",
    device=None,
):
    """:func:`checkpointed_stencil` as a steppable
    ``runtime.chunked.ChunkedProgram`` — same arguments, same event
    stream, same bit-identical resume contract, but the chunk loop is
    the shared runtime's, so a ``MeshScheduler`` can time-slice the
    stencil against other workloads at save boundaries.  ``run()``
    returns the assembled world; ``workload`` tags every emitted
    event."""
    from tpuscratch_torch.obs.sink import NullSink
    from tpuscratch_torch.obs.trace import FlightRecorder, emit_phase_totals
    from tpuscratch_torch.runtime import checkpoint
    from tpuscratch_torch.runtime.chunked import (
        ChunkedProgram,
        ChunkResult,
        WorkloadSink,
        kernel_builds,
    )

    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    sink = WorkloadSink(sink if sink is not None else NullSink(), workload)
    rec = recorder if recorder is not None else FlightRecorder()
    base, halo, unroll = _chunk_impl(impl, halo)
    mesh, topo, layout, spec = _setup(world.shape, mesh, halo, periodic, device=device)

    tiles = decompose(world, topo, layout)
    start = 0
    if checkpoint.latest_step(ckpt_dir) is not None:
        tiles, start, _meta = checkpoint.restore(ckpt_dir, tiles,
                                                 reshard=reshard)
        if start > steps:
            raise ValueError(
                f"checkpoint in {ckpt_dir} is at step {start}, beyond the "
                f"requested {steps} — refusing to return an over-stepped "
                "state as the answer (use a fresh ckpt_dir)"
            )
        if tiles.shape[:2] != tuple(topo.dims):
            # elastic resume: the saved decomposition was for another
            # process grid — reassemble the world from the old layout
            # (cores only; ghosts are refilled by the leading exchange
            # of every step) and re-cut it for THIS mesh
            r0, c0 = tiles.shape[:2]
            old_layout = TileLayout(world.shape[0] // r0,
                                    world.shape[1] // c0,
                                    layout.halo_y, layout.halo_x)
            old_topo = CartTopology((r0, c0), (periodic, periodic))
            tiles = decompose(assemble(tiles, old_topo, old_layout),
                              topo, layout)
    sink.emit(
        "halo/config",
        world_h=world.shape[0], world_w=world.shape[1], steps=steps,
        impl=impl, mesh=f"{topo.dims[0]}x{topo.dims[1]}",
        resumed_at=start,
    )
    cells = world.shape[0] * world.shape[1]
    save_policy = None
    if chaos is not None:
        from tpuscratch_torch.ft.retry import DEFAULT_SAVE_RETRY

        save_policy = DEFAULT_SAVE_RETRY
    hal = {"state": tiles_from_numpy(tiles, mesh.device),
           "programs": {}}  # chunk size -> program

    def remake():
        return checkpointed_stencil_program(
            world, steps, ckpt_dir, save_every=save_every, mesh=mesh,
            halo=halo, coeffs=coeffs, impl=impl, periodic=periodic,
            keep=keep, sink=sink, chaos=chaos, recorder=recorder,
            reshard=reshard, async_ckpt=async_ckpt, workload=workload,
            device=device,
        )

    def run_chunk(cp, pos):
        chunk = min(save_every, steps - pos)
        if chunk not in hal["programs"]:
            hal["programs"][chunk] = make_stencil_program(
                mesh, spec, chunk, coeffs, base, unroll
            )
        # a kernel built (nvcc) and loaded inside this chunk makes its
        # bracket build-dominated wall; obs.goodput carves compile_s out
        # of the step bucket
        built = kernel_builds()
        hal["state"] = hal["programs"][chunk](hal["state"])
        if hal["state"].is_cuda:
            torch.cuda.synchronize(hal["state"].device)  # fences the span
        return chunk, kernel_builds() > built

    def make_event(cp, pos, payload, chunk_sp):
        chunk, fresh = payload
        chunk_s = chunk_sp.seconds
        return ChunkResult(pos=pos + chunk, event={
            "step": pos + chunk, "chunk": chunk, "wall_s": round(chunk_s, 6),
            "cell_updates_per_s": round(cells * chunk / chunk_s, 3),
            "compile_s": round(chunk_s, 6) if fresh else 0.0,
        })

    def snapshot(cp, pos):
        return hal["state"], {"steps_total": steps, "impl": impl}

    def epilogue(cp):
        emit_phase_totals(cp.sink, cp.rec)
        cp.sink.flush()
        return assemble(hal["state"].cpu().numpy(), topo, layout)

    return ChunkedProgram(
        workload=workload, prefix="halo", total=steps, pos=start,
        run_chunk=run_chunk, make_event=make_event, snapshot=snapshot,
        epilogue=epilogue, fail_site="comm/halo_chunk", fail_op="halo_chunk",
        preempt_site="halo/preempt", ckpt_dir=ckpt_dir, keep=keep,
        save_retry=save_policy, async_ckpt=async_ckpt, sink=sink,
        recorder=rec, chaos=chaos, remake=remake,
    )


def distributed_stencil(
    world: np.ndarray,
    steps: int,
    mesh: Optional[StackedMesh] = None,
    halo: tuple[int, int] = (1, 1),
    coeffs=JACOBI,
    impl: str = "xla",
    periodic: bool = True,
    sink=None,
    device=None,
) -> np.ndarray:
    """End-to-end: decompose over the mesh (default: 1x1 on ``device``, the
    card unless ``device='cpu'``), iterate, reassemble. ``sink`` (anything
    with ``emit(kind, **fields)`` and ``flush()``) receives one
    ``halo/run`` event with the fenced wall seconds and cell-updates/s."""
    mesh, topo, layout, spec = _setup(world.shape, mesh, halo, periodic, device=device)
    program = make_stencil_program(mesh, spec, steps, coeffs, impl)
    tiles = tiles_from_numpy(decompose(world, topo, layout), mesh.device)
    t0 = time.perf_counter()
    out = program(tiles)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    wall = time.perf_counter() - t0
    if sink is not None:
        sink.emit(
            "halo/run",
            world_h=world.shape[0], world_w=world.shape[1], steps=steps,
            impl=impl, mesh=f"{topo.dims[0]}x{topo.dims[1]}",
            wall_s=round(wall, 6),
            cell_updates_per_s=round(
                world.shape[0] * world.shape[1] * steps / wall, 3
            ),
        )
        sink.flush()
    return assemble(out.cpu().numpy(), topo, layout)
