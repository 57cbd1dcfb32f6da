"""The supervised solver runner: long solves on the production machinery.

The twin of ``tpuscratch.solvers.runner``: the trainer/halo-driver chunk
loop (``runtime.chunked``) pointed at the 3D multigrid Poisson solve. The
V-cycles run in CHUNKS, the full solver state (solution tiles + the
convergence scalars the stopping rule carries) is checkpointed at every
chunk boundary through the crash-safe publish protocol, and a re-invoked
run resumes BIT-IDENTICAL to an uninterrupted one — chunk boundaries are
deterministic, the ``.npy`` round trip is exact and the smoothers give
the same bits every call.

The production hooks mirror the other two chunk loops:

- ``obs``: one ``solver/chunk`` event per chunk (cycles reached, fenced
  wall seconds, cell-updates/s, build share) + ``ckpt/save`` walls —
  ``obs.goodput.goodput_report`` books them into the step/checkpoint
  buckets;
- ``ft``: ``comm/solver_chunk`` chaos site before each chunk (a transient
  ``CommError`` — the supervisor's restartable class), checkpoint saves
  under ``ft.retry``, and ``solver/preempt`` AFTER the save, so the
  restarted run resumes exactly where the preempted one stopped;
  :func:`supervised_mg3d_solve` wraps the whole loop in
  ``ft.supervisor.supervise``.

A chunk is a plain function over the stacked cores: V-cycles under the
JAX package's stop rule, one host read of rank 0's flag a cycle (the
whole-solve loop's ``host_flag``). ``smoother="jacobi-stream"`` smooths
the finest levels through the streamed 3D kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.halo.halo3d import assemble3d_cores, decompose3d_cores
from tpuscratch_torch.solvers.cg import host_flag, local_sum
from tpuscratch_torch.solvers.multigrid3d import (
    _mg_prologue3,
    periodic_laplacian3,
    v_cycle3,
)

__all__ = ["SolveReport", "checkpointed_mg3d_solve", "mg3d_solve_program",
           "supervised_mg3d_solve"]


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """What one (possibly resumed) supervised solve did — the solver
    sibling of ``TrainReport``/``GenerateReport``."""

    cycles: int          # V-cycles applied in total (across resumes)
    relres: float        # achieved relative residual
    converged: bool      # relres <= tol (False: max_cycles or stagnation)
    chunks: int          # chunk invocations THIS run
    resumed_at: int      # cycle the run picked up from (0 = fresh)


def _mg3_chunk_program(mesh, specs, axes, cells, tol, chunk, max_cycles,
                       nu, coarse_sweeps, omega, smoother, s_step):
    """The chunk: ``fn(u_tiles, b_tiles, rs, prev, k)`` advances the solver
    state by up to ``chunk`` V-cycles from cycle ``k`` (an int), stopping
    early on convergence or stagnation, exactly the whole-solve loop's
    rule, so a chunked run walks the same cycle sequence. Returns
    ``(u_tiles, rs, prev, k, rs0)``: ``rs``, ``prev`` and the initial
    residual ``rs0`` 0-dim f32 tensors on the mesh's device, ``k`` the
    cycle reached."""
    tile_spec = P(*mesh.axis_names, None, None, None)

    def chunk_fn(u_tiles, b_tiles, rs, prev, k: int):
        reached = {"k": k}

        def local(u_tile, b_tile, rs, prev):
            b = b_tile[..., 0, 0, 0, :, :, :]
            u = u_tile[..., 0, 0, 0, :, :, :]
            f = b - allreduce_sum(local_sum(b), axes) / cells
            rs0 = allreduce_sum(local_sum(f * f), axes).reshape(mesh.shape)
            stop2 = torch.tensor(tol, dtype=f.dtype, device=f.device) ** 2 * rs0
            # a fresh run passes rs=inf sentinels; cycle 0 seeds the true
            # initial residual (recomputed deterministically on resume)
            if k == 0:
                rs = rs0

            def rs_of(u):
                r = f - periodic_laplacian3(u, specs[0][0])
                return allreduce_sum(local_sum(r * r), axes).reshape(mesh.shape)

            k_c, k_end = k, min(k + chunk, max_cycles)
            while k_c < k_end and host_flag((rs > stop2) & (rs < 0.5 * prev)):
                u = v_cycle3(u, f, specs, 0, nu, coarse_sweeps, omega, smoother, s_step)
                rs, prev, k_c = rs_of(u), rs, k_c + 1
            reached["k"] = k_c
            return u[..., None, None, None, :, :, :], rs, prev, rs0

        u, rs, prev, rs0 = run_spmd(mesh, local, (tile_spec, tile_spec, P(), P()),
                                    (tile_spec, P(), P(), P()))(u_tiles, b_tiles, rs, prev)
        return u, rs, prev, reached["k"], rs0

    return chunk_fn


def checkpointed_mg3d_solve(
    b_world: np.ndarray,
    ckpt_dir: str,
    *,
    mesh=None,
    levels: Optional[int] = None,
    tol: float = 1e-5,
    max_cycles: int = 50,
    chunk_cycles: int = 4,
    nu: int = 2,
    coarse_sweeps: int = 32,
    omega: float = 6 / 7,
    smoother: str = "rbgs",
    s_step: int = 1,
    keep: int = 3,
    sink=None,
    chaos=None,
    recorder=None,
    log=lambda s: None,
    reshard: bool = False,
    async_ckpt: bool = False,
    device=None,
) -> tuple[np.ndarray, SolveReport]:
    """``mg_poisson3d_solve`` with preemption survival: V-cycles run in
    chunks of ``chunk_cycles``, the solver state is saved at
    every chunk boundary, and a re-invoked run resumes from the newest
    checkpoint in ``ckpt_dir`` — producing a result BIT-IDENTICAL to an
    uninterrupted run (under injected preemption and
    ``CommError`` chaos).  Returns ``(x_world, SolveReport)`` with
    zero-mean ``x``. The mesh defaults to 1x1x1 on ``device`` (the card
    unless ``device='cpu'``); the JAX package's checkpoints resume here.

    This is a RE-INVOCABLE body in the :func:`ft.supervisor.supervise`
    sense; :func:`supervised_mg3d_solve` is the wrapped form.  ``chaos``
    plugs the fault injector in (``comm/solver_chunk`` before each
    chunk, checkpoint-IO faults through ``save``'s stage hook with the
    save under ``ft.retry``, ``solver/preempt`` after the save);
    ``sink``/``recorder`` receive the same chunk/save telemetry the
    trainer and halo driver emit, in the ``solver/*`` namespace.
    ``s_step`` passes through to the communication-avoiding smoothers.

    ``reshard=True`` makes the resume elastic over the mesh shape: a
    checkpoint whose solution tiles were cut for a different 3D process
    grid is reassembled and re-decomposed onto THIS mesh (the core
    tiles round-trip exactly; the convergence scalars are replicated).
    The continued solve is replay-deterministic on the new mesh — its
    psum groupings differ from the old mesh's, so cross-mesh residual
    trajectories agree to reassociation tolerance, not bitwise.
    ``async_ckpt=True`` switches the chunk-boundary saves to the
    snapshot-then-publish path (``runtime.async_ckpt``), with the
    barrier drained before each snapshot, at preemption points, and at
    exit.
    """
    return mg3d_solve_program(
        b_world, ckpt_dir, mesh=mesh, levels=levels, tol=tol,
        max_cycles=max_cycles, chunk_cycles=chunk_cycles, nu=nu,
        coarse_sweeps=coarse_sweeps, omega=omega, smoother=smoother,
        s_step=s_step, keep=keep, sink=sink, chaos=chaos, recorder=recorder,
        log=log, reshard=reshard, async_ckpt=async_ckpt, device=device,
    ).run()


def mg3d_solve_program(
    b_world: np.ndarray,
    ckpt_dir: str,
    *,
    mesh=None,
    levels: Optional[int] = None,
    tol: float = 1e-5,
    max_cycles: int = 50,
    chunk_cycles: int = 4,
    nu: int = 2,
    coarse_sweeps: int = 32,
    omega: float = 6 / 7,
    smoother: str = "rbgs",
    s_step: int = 1,
    keep: int = 3,
    sink=None,
    chaos=None,
    recorder=None,
    log=lambda s: None,
    reshard: bool = False,
    async_ckpt: bool = False,
    workload: str = "solver",
    device=None,
):
    """:func:`checkpointed_mg3d_solve` as a steppable
    ``runtime.chunked.ChunkedProgram`` — same arguments, same
    ``solver/*`` event stream, same bit-identical resume, but each
    ``tick()`` is one chunk of V-cycles, so a co-scheduler can
    time-slice the solve against other workloads.  ``run()`` returns
    ``(x_world, SolveReport)``; ``workload`` tags every emitted event."""
    from tpuscratch_torch.obs.sink import NullSink
    from tpuscratch_torch.obs.trace import FlightRecorder, emit_phase_totals
    from tpuscratch_torch.runtime import checkpoint
    from tpuscratch_torch.runtime.chunked import (
        ChunkedProgram,
        ChunkResult,
        WorkloadSink,
        kernel_builds,
    )

    if chunk_cycles < 1:
        raise ValueError(f"chunk_cycles must be >= 1, got {chunk_cycles}")
    sink = WorkloadSink(sink if sink is not None else NullSink(), workload)
    rec = recorder if recorder is not None else FlightRecorder()
    mesh, dims, specs, axes, cells = _mg_prologue3(b_world, mesh, levels, device)
    program = _mg3_chunk_program(
        mesh, tuple(specs), axes, cells, float(tol), int(chunk_cycles),
        int(max_cycles), int(nu), int(coarse_sweeps), float(omega),
        smoother, int(s_step),
    )

    b_np = decompose3d_cores(np.asarray(b_world), dims)
    b_tiles = torch.from_numpy(b_np).to(mesh.device)
    f32 = b_np.dtype
    state = {
        "u": np.zeros_like(b_np),
        "rs": np.asarray(np.inf, f32),
        "prev": np.asarray(np.inf, f32),
        "k": np.asarray(0, np.int32),
    }
    resumed_at = 0
    if checkpoint.latest_step(ckpt_dir) is not None:
        state, resumed_at, _meta = checkpoint.restore(ckpt_dir, state,
                                                      reshard=reshard)
        if resumed_at > max_cycles:
            raise ValueError(
                f"checkpoint in {ckpt_dir} is at cycle {resumed_at}, beyond "
                f"the requested {max_cycles} — refusing to return an "
                "over-stepped state (use a fresh ckpt_dir)"
            )
        if np.shape(state["u"])[:3] != tuple(dims):
            # elastic resume: the tiles were cut for another process
            # grid — the core decomposition is a pure relayout, so
            # reassemble the world and re-cut it for THIS mesh
            state["u"] = decompose3d_cores(assemble3d_cores(state["u"]), dims)
        log(f"resuming at cycle {resumed_at}")

    sink.emit(
        "solver/config", solver="mg3d",
        world=f"{b_world.shape[0]}x{b_world.shape[1]}x{b_world.shape[2]}",
        mesh=f"{dims[0]}x{dims[1]}x{dims[2]}", smoother=smoother,
        s_step=int(s_step), chunk=int(chunk_cycles), tol=tol,
        resumed_at=int(resumed_at),
    )

    save_policy = None
    if chaos is not None:
        from tpuscratch_torch.ft.retry import DEFAULT_SAVE_RETRY

        save_policy = DEFAULT_SAVE_RETRY

    sol = {
        "u": torch.from_numpy(state["u"]).to(mesh.device),
        "rs": torch.from_numpy(state["rs"]).to(mesh.device),
        "prev": torch.from_numpy(state["prev"]).to(mesh.device),
        "rs0": None,
        "k_prev": int(state["k"]),
        "chunks": 0,
    }
    cells_total = float(np.prod(b_world.shape))

    def remake():
        return mg3d_solve_program(
            b_world, ckpt_dir, mesh=mesh, levels=levels, tol=tol,
            max_cycles=max_cycles, chunk_cycles=chunk_cycles, nu=nu,
            coarse_sweeps=coarse_sweeps, omega=omega, smoother=smoother,
            s_step=s_step, keep=keep, sink=sink, chaos=chaos,
            recorder=recorder, log=log, reshard=reshard,
            async_ckpt=async_ckpt, workload=workload, device=device,
        )

    def run_chunk(cp, pos):
        built = kernel_builds()
        u, rs, prev, k_new, rs0 = program(sol["u"], b_tiles, sol["rs"],
                                          sol["prev"], pos)
        float(rs)  # fences the span (the stop rule read the flags already)
        sol.update(u=u, rs=rs, prev=prev, rs0=rs0)
        return k_new, kernel_builds() > built

    def make_event(cp, pos, payload, chunk_sp):
        k_new, fresh = payload
        advanced = k_new - pos
        chunk_s = chunk_sp.seconds
        sol["chunks"] += 1
        sol["k_prev"] = pos
        return ChunkResult(pos=k_new, event={
            "cycle": k_new, "chunk": advanced, "wall_s": round(chunk_s, 6),
            "cell_updates_per_s": round(
                cells_total * max(advanced, 1) / chunk_s, 3),
            "relres2": float(sol["rs"]) / max(float(sol["rs0"]), 1e-30),
            # a chunk that built a kernel is build-dominated wall —
            # the halo driver's convention at chunk granularity
            "compile_s": round(chunk_s, 6) if fresh else 0.0,
        })

    def snapshot(cp, pos):
        snap_state = {"u": sol["u"], "rs": sol["rs"], "prev": sol["prev"],
                      "k": np.asarray(pos, np.int32)}
        return snap_state, {"solver": "mg3d", "tol": tol,
                            "max_cycles": max_cycles}

    def post_boundary(cp, k_new):
        # the stop rules run AFTER the preemption point, exactly where
        # the legacy loop evaluated them
        stop2 = float(tol) ** 2 * float(sol["rs0"])
        if float(sol["rs"]) <= stop2:
            return True
        if k_new < min(sol["k_prev"] + chunk_cycles, max_cycles):
            # the in-program stagnation rule stopped the chunk short
            log(f"stagnated at cycle {k_new} "
                f"(relres^2 "
                f"{float(sol['rs']) / max(float(sol['rs0']), 1e-30):.3e})")
            return True
        return False

    def epilogue(cp):
        emit_phase_totals(cp.sink, cp.rec)
        tiny = float(np.finfo(np.dtype(f32)).tiny)
        rs0 = sol["rs0"]
        if rs0 is None:
            # resumed at/after max_cycles with nothing left to run: the
            # restored rs is the state; rs0 is recomputed host-side
            # (report only — stop decisions always use the device value)
            f_host = b_world.astype(np.float64)
            f_host = f_host - f_host.mean()
            rs0 = float((f_host * f_host).sum())
        relres = float(np.sqrt(float(sol["rs"]) / max(float(rs0), tiny)))
        converged = relres <= tol
        report = SolveReport(
            cycles=int(cp.pos), relres=relres, converged=converged,
            chunks=sol["chunks"], resumed_at=int(resumed_at),
        )
        cp.sink.emit(
            "solver/run", cycles=report.cycles, relres=report.relres,
            converged=report.converged, chunks=report.chunks,
            resumed_at=report.resumed_at,
        )
        cp.sink.flush()
        # mean projection on the HOST (deterministic either path): the
        # assembled world minus its mean — the whole-solve program's
        # final psum projection, reassembled-side
        x = assemble3d_cores(sol["u"].cpu().numpy())
        return x - x.mean(dtype=np.float64).astype(x.dtype), report

    return ChunkedProgram(
        workload=workload, prefix="solver", total=max_cycles,
        pos=int(state["k"]), run_chunk=run_chunk, make_event=make_event,
        snapshot=snapshot, epilogue=epilogue, post_boundary=post_boundary,
        span_args=lambda p: {"cycle_begin": p},
        save_span_args=lambda p: {"cycle": p},
        fail_site="comm/solver_chunk", fail_op="solver_chunk",
        preempt_site="solver/preempt", ckpt_dir=ckpt_dir, keep=keep,
        save_retry=save_policy, async_ckpt=async_ckpt, sink=sink,
        recorder=rec, chaos=chaos, log=log, remake=remake,
    )


def supervised_mg3d_solve(
    b_world: np.ndarray,
    ckpt_dir: str,
    *,
    budget=None,
    restartable=None,
    sink=None,
    metrics=None,
    recorder=None,
    log=lambda s: None,
    sleep=time.sleep,
    **solve_kw,
) -> tuple[np.ndarray, SolveReport]:
    """:func:`ft.supervisor.supervise` around
    :func:`checkpointed_mg3d_solve` — the solver's ``supervise_train``.
    Each restart re-invokes the chunked solve, which resumes from
    ``latest_step(ckpt_dir)`` and replays deterministically; a chaos
    plan in ``solve_kw['chaos']`` persists ACROSS restarts, so consumed
    one-shot faults stay consumed in the replay.  Returns the completing
    invocation's ``(x_world, SolveReport)``."""
    from tpuscratch_torch.ft.supervisor import supervise_program

    def factory():
        return mg3d_solve_program(
            b_world, ckpt_dir, sink=sink, recorder=recorder, log=log,
            **solve_kw,
        )

    return supervise_program(factory, budget=budget,
                             restartable=restartable, sink=sink,
                             metrics=metrics, recorder=recorder,
                             log=log, sleep=sleep)
