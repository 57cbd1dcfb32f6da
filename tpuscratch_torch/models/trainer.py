"""Checkpointed training driver: the ML-side `checkpointed_stencil`.

Composes the framework's subsystems into one preemption-surviving
training loop: the composed transformer train step (models/transformer —
ring attention over sp, expert MoE over dp, grad + SGD in one step
function), atomic checkpointing (runtime/checkpoint), and rank-aware
logging. A run killed between chunks and re-invoked with the same
arguments resumes at ``latest_step`` and produces BIT-IDENTICAL params
to an uninterrupted run: deterministic data (seeded per step), identical
chunk boundaries, and an exact f32 round trip through the checkpoint
format — the same contract ``halo.driver.checkpointed_stencil`` proves
for the stencil side (tests/test_trainer.py kills a run to prove this
one).

The twin of ``tpuscratch.models.trainer``: the same data stream (numpy
draws), the same chunk boundaries, checkpoint format, resume checks,
guard ladder and event stream, over the port's train steps on a stacked
mesh (the card unless the mesh was made on the CPU). The guard statuses
stay on the device and are read once a chunk, with the chunk's loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpuscratch_torch.ft.chaos import bind_sink
from tpuscratch_torch.ft.guards import (
    STATUS_CLIPPED,
    STATUS_SKIPPED,
    GuardPolicy,
    GuardState,
)
from tpuscratch_torch.ft.retry import DEFAULT_SAVE_RETRY, RetryPolicy
from tpuscratch_torch.models.transformer import (
    TransformerConfig,
    init_adam_state,
    init_params,
    stack_layers,
    train_step,
    train_step_adam,
)
from tpuscratch_torch.models.zero import (
    init_plan_zero_state,
    init_zero_adam_state,
    put_plan_state,
    train_step_plan,
    train_step_zero,
    zero_state_from_numpy,
)
from tpuscratch_torch.parallel.plan import ShardingPlan
from tpuscratch_torch.runtime.errors import CommError
from tpuscratch_torch.obs.metrics import CompileCounter, MetricsRegistry
from tpuscratch_torch.obs.sink import NullSink
from tpuscratch_torch.obs.trace import FlightRecorder, emit_phase_totals
from tpuscratch_torch.runtime import checkpoint
from tpuscratch_torch.runtime.chunked import (
    ChunkedProgram,
    ChunkResult,
    WorkloadSink,
    kernel_builds,
)
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device


@functools.lru_cache(maxsize=8)
def _target_w(seed: int, d_model: int) -> np.ndarray:
    """The task's fixed linear map (seeded by the run, not the step, so
    the task is stationary); cached — it would otherwise be redrawn
    host-side every training step."""
    w = np.random.default_rng(seed).standard_normal((d_model, d_model))
    return (0.5 * w / np.sqrt(d_model)).astype(np.float32)


def synthetic_batch(seed: int, step: int, batch: int, seq: int, d_model: int,
                    device=None):
    """Deterministic per-step batch on ``device`` (the card unless the
    caller asks for the CPU): same (seed, step) -> same data, on any host
    and in either package (the draws are numpy's) — the property that
    makes resume bit-exact without a data loader state to checkpoint."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    x = rng.standard_normal((batch, seq, d_model)).astype(np.float32)
    y = (x @ _target_w(seed, d_model)).astype(np.float32)
    dev = resolve_device(device)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _cfg_fingerprint(cfg: TransformerConfig) -> str:
    """JSON-stable identity of the model config, stored in checkpoint
    metadata so a resume with a different architecture fails loudly
    instead of silently training a different model from restored
    weights."""
    fields = dataclasses.asdict(cfg)
    return ",".join(f"{k}={fields[k]}" for k in sorted(fields))


def _restore_state(ckpt_dir: str, params, opt, step, mesh_shape=None,
                   reshard=False, live_plan=None, commit=None):
    """Restore the full training state at ``step`` (params alone for
    SGD, params+moments for Adam/ZeRO) — the ONE restore/unpack sequence
    the entry resume and the guard rollback share.  ``mesh_shape`` (the
    ZeRO path) makes the checkpoint layer itself reject a checkpoint
    whose dp-sharded optimizer leaves were laid out for a different
    mesh — unless ``reshard`` is set, in which case the saved layout is
    loaded as-is and the ZeRO moment shards are REGROUPED onto
    ``live_plan`` via ``models.zero.reshard_state`` (the elastic resume
    path; ``commit`` puts the regrouped numpy state back on the device).
    Returns (params, opt, step, metadata)."""
    state = {"params": params, "opt": opt} if opt is not None else params
    state, step, meta = checkpoint.restore(ckpt_dir, state, step=step,
                                           mesh_shape=mesh_shape,
                                           reshard=reshard)
    if opt is None:
        return state, opt, step, meta
    params_r, opt_r = state["params"], state["opt"]
    if reshard and live_plan is not None and isinstance(opt_r, dict) \
            and "mu_flat" in opt_r:
        from tpuscratch_torch.models.zero import reshard_state

        saved_plan = {k: int(v) for k, v in meta["plan"].items()}
        if saved_plan != live_plan:
            opt_r = commit(reshard_state(checkpoint.to_host(opt_r), params_r,
                                         saved_plan, live_plan))
    return params_r, opt_r, step, meta


@dataclasses.dataclass(frozen=True)
class TrainReport:
    steps_run: int       # committed in THIS invocation (resume skips the
    #                      rest; rolled-back chunks don't count)
    final_step: int
    losses: tuple[float, ...]  # loss at each save point, this invocation
    # guard ladder counts (zero when no guard was attached)
    skipped: int = 0
    clipped: int = 0
    rollbacks: int = 0


def train(
    mesh: StackedMesh,
    cfg: TransformerConfig,
    steps: int,
    ckpt_dir: str,
    *,
    lr: float = 0.05,
    optimizer: str = "sgd",
    save_every: int = 10,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    seed: int = 0,
    keep: int = 3,
    log: Callable[[str], None] = lambda s: None,
    obs=None,
    recorder: Optional[FlightRecorder] = None,
    chaos=None,
    guard: Optional[GuardPolicy | GuardState] = None,
    save_retry: Optional[RetryPolicy] = None,
    zero: bool = False,
    accum_steps: int = 1,
    plan: Optional[ShardingPlan] = None,
    reshard: bool = False,
    async_ckpt: bool = False,
) -> tuple[dict, TrainReport]:
    """Run (or resume) ``steps`` training steps, checkpointing every
    ``save_every``. Returns (params, report). ``optimizer`` is 'sgd' or
    'adam'; Adam's moment state is checkpointed WITH the params (the
    full training state, sharded like the params), so resume is
    bit-identical for both.

    ``obs`` (an ``obs.sink.Sink``) turns on telemetry: one
    ``train/chunk`` event per save chunk — loss, grad-norm, tokens/s,
    step device time, compile count — plus a final ``train/run`` +
    metrics snapshot.  The grad-norm output is only computed by the step
    when a sink is attached, so an uninstrumented run's step is
    unchanged; either way a ``CompileCounter`` counts the step's builds,
    one a run, rollback replays included (tests assert == 1).

    ``recorder`` (an ``obs.trace.FlightRecorder``; a fresh one is
    created when absent — the flight recorder is always-on and bounded)
    collects ``train/chunk`` / ``ckpt/save`` / ``train/rollback`` spans
    for Chrome-trace export; per-phase totals are emitted as cumulative
    ``trace/phase`` events through the sink at the end of the run (the
    straggler table's input).  The ``train/chunk`` event additionally
    carries ``steps``/``tokens``/``chunk_s``/``compile_s``, and every
    ``ckpt/save``/``ft/rollback`` event a duration, so ``obs.goodput``
    can partition the run's wall time from the artifact alone.

    Fault tolerance (all default-off; the uninstrumented program and
    loop are unchanged when absent):

    - ``chaos`` (an ``ft.ChaosPlan``) plugs the fault injector in:
      batch corruption per step (``train/grad``), transient CommErrors
      around the compiled step (``comm/train_step``), checkpoint-IO
      faults through ``save``'s stage hook (``ckpt/save``), and
      simulated preemption at chunk boundaries AFTER the save
      (``train/preempt`` — raises ``ft.Preempted`` for the supervisor).
    - ``guard`` (an ``ft.GuardPolicy``, or an ``ft.GuardState`` to keep
      one counter set across supervised restarts) compiles the
      device-side finiteness/spike/clip guard into the step and runs
      the host escalation ladder on the statuses read back each chunk:
      skipped steps apply nothing (in-program), over-norm steps apply
      clipped updates, and more than ``max_skips`` CONSECUTIVE skips
      roll the run back to the last checkpoint and replay the chunk
      (bounded by ``max_rollbacks``, then ``ft.GuardFailure``).
    - ``save_retry`` (an ``ft.RetryPolicy``) wraps every checkpoint
      save; defaults on when ``chaos`` is attached so injected IO
      faults are absorbed rather than fatal.

    ``zero=True`` (requires ``optimizer='adam'``) selects the
    ZeRO-sharded path (``models.zero``): gradients reduce-scatter over
    "dp" instead of all-reducing, the Adam moments live as dp-sharded
    flat shards (optimizer memory ÷ |dp|, written in place by the
    fused kernel where each rank's shard is its own memory), and updated params are all-gathered for the next
    forward.  The checkpoint then holds the SHARDED optimizer leaves
    and records the mesh shape — resuming on a mesh with a different
    |dp| raises a ``CommError`` instead of mis-loading.
    ``accum_steps=k`` (ZeRO only) folds k microbatches into each
    update with gradient accumulation, deferring the single
    reduce-scatter to the last microbatch; each step then consumes k
    consecutive entries of the deterministic batch stream, so
    ``accum_steps`` is part of the resume identity like ``batch``.

    ``plan`` (a ``parallel.ShardingPlan`` built over THIS mesh)
    replaces the hardcoded dp x sp assumption with the plan's axis
    mapping and schedule.  A dp x sp plan (no pp axis, or pp=1 with
    one microbatch) runs the EXACT legacy program — bit-identical —
    with the plan's overlap policy threaded into the ZeRO sync legs.
    A PIPELINED plan (``pp`` axis, ``n_micro`` microbatches) trains
    the stage-stacked model through the GPipe schedule composed with
    dp x sp (and, under ``zero=True``, with dp-sharded ZeRO moments and
    the bubble-filling decomposed grad sync) — one step function,
    ``optimizer='adam'`` required.  The checkpoint records the
    normalized plan identity; resuming under a mismatched plan raises
    a ``CommError``, the same contract as a mismatched-|dp| ZeRO
    restore.

    ``reshard=True`` is the elastic escape hatch for exactly those two
    ``CommError``s: a checkpoint whose ZeRO moments were laid out for a
    DIFFERENT plan/mesh (a preempted-and-shrunk slice) is loaded in its
    saved layout and regrouped onto this run's plan at restore time
    (``models.zero.reshard_state`` — gather-by-manifest, re-split by
    the live ``zero_state_spec``, put back on the mesh's device).
    The layout FAMILY must match (stage-stacked vs flat dp x sp), and
    ``batch``/``seq``/``seed``/... stay part of the resume identity —
    the regroup changes the layout of the state, never the trajectory.
    The resumed run is bit-identical to its own replay on the new plan.

    ``async_ckpt=True`` replaces the blocking checkpoint saves with the
    snapshot-then-publish path (``runtime.async_ckpt``): the step loop
    only pays the device→pinned-host copy (emitted as ``ckpt/snapshot``)
    while a background writer serializes and publishes through the same
    crash-consistent protocol (emitted as ``ckpt/write`` at its true
    end stamp) — published checkpoints are byte-identical to the
    blocking path's, at most one write is in flight, and the barrier is
    drained before each next snapshot, at preemption points, and at
    exit."""
    return train_program(
        mesh, cfg, steps, ckpt_dir, lr=lr, optimizer=optimizer,
        save_every=save_every, batch=batch, seq=seq, seed=seed, keep=keep,
        log=log, obs=obs, recorder=recorder, chaos=chaos, guard=guard,
        save_retry=save_retry, zero=zero, accum_steps=accum_steps,
        plan=plan, reshard=reshard, async_ckpt=async_ckpt,
    ).run()


def train_program(
    mesh: StackedMesh,
    cfg: TransformerConfig,
    steps: int,
    ckpt_dir: str,
    *,
    lr: float = 0.05,
    optimizer: str = "sgd",
    save_every: int = 10,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    seed: int = 0,
    keep: int = 3,
    log: Callable[[str], None] = lambda s: None,
    obs=None,
    recorder: Optional[FlightRecorder] = None,
    chaos=None,
    guard: Optional[GuardPolicy | GuardState] = None,
    save_retry: Optional[RetryPolicy] = None,
    zero: bool = False,
    accum_steps: int = 1,
    plan: Optional[ShardingPlan] = None,
    reshard: bool = False,
    async_ckpt: bool = False,
    workload: str = "train",
) -> ChunkedProgram:
    """:func:`train` as an UN-RUN ``runtime.chunked.ChunkedProgram`` —
    the steppable form a co-scheduler or
    ``ft.supervisor.supervise_program`` consumes.  All validation,
    checkpoint resume and step-function construction happens here,
    eagerly, so a mismatched resume fails at build time; each ``tick()``
    then runs one save chunk with the EXACT legacy event stream
    (``train/chunk``, the guard ladder's ``ft/*``,
    ``ckpt/save``/``ckpt/snapshot``) — every event additionally tagged
    ``workload=`` for per-job goodput accounting.  ``program.remake()``
    rebuilds it resumed from ``ckpt_dir`` — the restart factory the
    supervisor re-invokes after a preemption."""
    orig_guard = guard  # remake re-passes the caller's policy/state

    def remake():
        return train_program(
            mesh, cfg, steps, ckpt_dir, lr=lr, optimizer=optimizer,
            save_every=save_every, batch=batch, seq=seq, seed=seed,
            keep=keep, log=log, obs=obs, recorder=recorder, chaos=chaos,
            guard=orig_guard, save_retry=save_retry, zero=zero,
            accum_steps=accum_steps, plan=plan, reshard=reshard,
            async_ckpt=async_ckpt, workload=workload,
        )

    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"optimizer must be sgd|adam, got {optimizer!r}")
    if zero and optimizer != "adam":
        raise ValueError("zero=True shards optimizer state: optimizer "
                         f"must be 'adam', got {optimizer!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1 and not zero:
        raise ValueError("accum_steps > 1 is the ZeRO path's "
                         "deferred-sync feature: pass zero=True")
    dp_ax, sp_ax = (plan.dp, plan.sp) if plan is not None else ("dp", "sp")
    if plan is not None and (
        tuple(plan.mesh.axis_names) != tuple(mesh.axis_names)
        or plan.mesh.shape != mesh.shape
    ):
        raise ValueError(
            f"plan was built for mesh {plan.mesh.shape}, train() "
            f"was handed mesh {mesh.shape} — build the plan over "
            f"the mesh you train on (its axes are validated there)"
        )
    pipelined = plan is not None and plan.pipelined
    if pipelined and optimizer != "adam":
        raise ValueError(
            "a pipelined plan trains with optimizer='adam' "
            f"(got {optimizer!r})"
        )
    if pipelined and accum_steps != 1:
        raise ValueError(
            "a pipelined plan already microbatches through n_micro; "
            "accum_steps must be 1"
        )
    dp_n = mesh.shape[mesh.axis_names.index(dp_ax)]
    sp_n = mesh.shape[mesh.axis_names.index(sp_ax)]
    pp_n = plan.pp_size if pipelined else 1
    batch = batch if batch is not None else 2 * dp_n
    seq = seq if seq is not None else 8 * sp_n
    if pipelined and (batch // dp_n) % plan.n_micro:
        raise ValueError(
            f"local batch {batch // dp_n} (batch {batch} / |dp| {dp_n}) "
            f"not divisible by the plan's n_micro {plan.n_micro}"
        )
    # normalized plan identity: a pp=1 single-microbatch plan IS the
    # legacy program, so the two resume interchangeably; anything
    # pipelined is its own state layout and data schedule
    plan_id = (plan.describe() if plan is not None else
               {"dp": int(dp_n), "sp": int(sp_n), "pp": 1, "n_micro": 1})
    if zero:
        mesh_shape = {"dp": int(dp_n), "sp": int(sp_n)}
        if pipelined:
            mesh_shape["pp"] = int(pp_n)
    else:
        mesh_shape = None

    def fresh_state():
        if pipelined:
            params = stack_layers(init_params(seed, cfg, device=mesh.device))
            opt = (put_plan_state(init_plan_zero_state(params, plan),
                                  plan, cfg)
                   if zero else init_adam_state(params))
            return params, opt
        params = init_params(seed, cfg, device=mesh.device)
        if zero:
            return params, init_zero_adam_state(params, dp_n)
        return params, (init_adam_state(params) if optimizer == "adam"
                        else None)

    def commit_opt(opt):
        """A regrouped (numpy) ZeRO state back on the device, in its
        layout (``put_plan_state`` checks the plan's split)."""
        if pipelined:
            return put_plan_state(opt, plan, cfg)
        return zero_state_from_numpy(opt, mesh.device)

    params, opt = fresh_state()
    start = 0
    if checkpoint.latest_step(ckpt_dir) is not None:
        # the bit-identical contract only holds if the resumed run replays
        # the same trajectory: fail loudly on a mismatched re-invocation —
        # batch/seq/cfg change the data stream and the compiled step just
        # as much as lr/seed do. Metadata is checked BEFORE any leaf load
        # so an architecture change surfaces as this error, not as a
        # leaf-count mismatch from restore.
        start, meta = checkpoint.peek_metadata(ckpt_dir)
        checked = (("lr", lr), ("seed", seed), ("batch", batch), ("seq", seq),
                   ("cfg", _cfg_fingerprint(cfg)), ("optimizer", optimizer),
                   ("zero", zero), ("accum_steps", accum_steps))
        missing = [k for k in (*dict(checked), "plan") if k not in meta]
        if missing:
            raise ValueError(
                f"resume mismatch: checkpoint in {ckpt_dir} lacks {missing} "
                f"in its metadata (use a fresh ckpt_dir)"
            )
        if start > steps:
            raise ValueError(
                f"checkpoint in {ckpt_dir} is at step {start}, beyond the "
                f"requested {steps} (use a fresh ckpt_dir)"
            )
        mesh_mismatch = (zero and meta.get("mesh_shape") is not None
                         and meta["mesh_shape"] != mesh_shape)
        # the plan is part of the state's meaning: stage-stacked params,
        # (pp, dp)-sharded moments, and the microbatched data schedule
        # all depend on it — a mismatched plan fails with the same
        # CommError contract as a mismatched-|dp| ZeRO restore, unless
        # reshard=True regroups the state onto the live plan
        stored_plan = meta["plan"]
        live_pipelined = plan_id["pp"] > 1 or plan_id["n_micro"] > 1
        stored_pipelined = stored_plan["pp"] > 1 or stored_plan["n_micro"] > 1
        plan_mismatch = stored_plan != plan_id
        if (mesh_mismatch or plan_mismatch) \
                and stored_pipelined != live_pipelined:
            raise CommError(
                "train/resume",
                f"checkpoint in {ckpt_dir} was trained under plan "
                f"{stored_plan}, this run's plan is {plan_id} — the "
                f"stage-stacked and the flat dp x sp layouts are "
                f"different state STRUCTURES; reshard=True regroups "
                f"shards within a family, it cannot cross one",
            )
        if mesh_mismatch and not reshard:
            # the dp-sharded flat moments are laid out for ONE |dp|;
            # CommError (not ValueError) — this is a sharding-layout
            # failure, the class the comm/runtime layer owns
            raise CommError(
                "train/resume",
                f"checkpoint in {ckpt_dir} holds ZeRO optimizer state "
                f"sharded for mesh {meta['mesh_shape']}, this run's mesh "
                f"is {mesh_shape} — dp-sharded moments cannot be "
                f"re-laid-out implicitly; pass reshard=True to regroup "
                f"them onto this mesh at restore time (or resume on a "
                f"matching mesh)",
            )
        if plan_mismatch and not reshard:
            raise CommError(
                "train/resume",
                f"checkpoint in {ckpt_dir} was trained under plan "
                f"{stored_plan}, this run's plan is {plan_id} — the "
                f"stage/mesh layout of the state cannot be re-laid-out "
                f"implicitly; pass reshard=True to regroup it onto this "
                f"plan at restore time (or resume under a matching "
                f"plan)",
            )
        for key, val in checked:
            if meta[key] != val:
                raise ValueError(
                    f"resume mismatch: checkpoint has {key}={meta[key]}, "
                    f"this run asked for {val} (use a fresh ckpt_dir)"
                )
        params, opt, start, meta = _restore_state(
            ckpt_dir, params, opt, start, mesh_shape=mesh_shape,
            reshard=reshard, live_plan=plan_id, commit=commit_opt,
        )
        log(f"resumed at step {start} (meta {meta})")

    sink = WorkloadSink(obs if obs is not None else NullSink(), workload)
    want_gnorm = sink.enabled
    metrics = MetricsRegistry()
    counter = CompileCounter()
    rec = recorder if recorder is not None else FlightRecorder()
    sink.emit(
        "train/config",
        steps=steps, lr=lr, optimizer=optimizer, batch=batch, seq=seq,
        seed=seed, resumed_at=start, cfg=_cfg_fingerprint(cfg),
    )
    # guard may be a policy (fresh counters) or a GuardState (shared
    # across supervised restarts, the ChaosPlan-persistence convention —
    # skip/clip/rollback counts then survive a preemption)
    if isinstance(guard, GuardState):
        guard_state, guard = guard, guard.policy
    else:
        guard_state = GuardState(guard) if guard is not None else None
    step_guard = guard.step_guard() if guard is not None else None
    if pipelined:
        step_fn = train_step_plan(plan, cfg, lr=lr, zero=zero,
                                  counter=counter,
                                  with_grad_norm=want_gnorm,
                                  guard=step_guard)
    elif zero:
        step_fn = train_step_zero(
            mesh, cfg, lr=lr, counter=counter, accum_steps=accum_steps,
            with_grad_norm=want_gnorm, guard=step_guard, dp=dp_ax,
            sp=sp_ax,
            overlap_blocks=plan.overlap_blocks if plan is not None else 0,
        )
    elif optimizer == "adam":
        step_fn = train_step_adam(mesh, cfg, lr=lr, counter=counter,
                                  with_grad_norm=want_gnorm,
                                  guard=step_guard, dp=dp_ax, sp=sp_ax)
    else:
        step_fn = train_step(mesh, cfg, lr=lr, counter=counter,
                             with_grad_norm=want_gnorm, guard=step_guard,
                             dp=dp_ax, sp=sp_ax)
    if chaos is not None:
        # injected faults land in the run's own event stream
        bind_sink(chaos, sink)
        # the collective wrapper: each step call may raise a transient
        # CommError — the supervisor's restartable class
        step_fn = chaos.wrap_collective(step_fn, "train_step")
    metadata = {
        "steps_total": steps, "lr": lr, "seed": seed,
        "batch": batch, "seq": seq, "cfg": _cfg_fingerprint(cfg),
        "optimizer": optimizer, "zero": zero, "accum_steps": accum_steps,
        "plan": plan_id,
    }
    if zero:
        metadata["mesh_shape"] = mesh_shape
    save_policy = save_retry if save_retry is not None else (
        DEFAULT_SAVE_RETRY if chaos is not None else None
    )
    losses: list[float] = []
    st = {"params": params, "opt": opt, "ran": 0,
          "ref_loss": float("nan")}  # spike baseline: previous chunk's loss
    run_t0 = time.perf_counter()

    def run_chunk(cp, pos):
        chunk = min(save_every, steps - pos)
        loss = gnorm = None
        statuses = []
        compile_s = 0.0
        params, opt = st["params"], st["opt"]
        # the spike baseline is the previous chunk's loss: one small copy
        # to the device a chunk
        rl = (torch.tensor(st["ref_loss"], dtype=torch.float32, device=mesh.device)
              if guard is not None else None)
        for i in range(chunk):
            if accum_steps > 1:
                # each update consumes accum_steps consecutive entries
                # of the deterministic stream (at k=1 this is exactly
                # the legacy indexing, so trajectories line up)
                micro = [
                    synthetic_batch(seed, (pos + i) * accum_steps + j,
                                    batch, seq, cfg.d_model, mesh.device)
                    for j in range(accum_steps)
                ]
                x = torch.stack([m[0] for m in micro])
                y = torch.stack([m[1] for m in micro])
            else:
                x, y = synthetic_batch(seed, pos + i, batch, seq,
                                       cfg.d_model, mesh.device)
            if chaos is not None:
                x = chaos.corrupt_batch(x, pos + i)
            # build detection: a kernel's nvcc build and load run inside
            # its first launch, so the bracket around a step that built a
            # kernel library is build-dominated wall — the goodput
            # report's "compile" badput bucket
            built = kernel_builds()
            step_t0 = time.perf_counter()
            if guard is not None:
                if optimizer == "adam":
                    params, opt, loss, gnorm, gst = step_fn(params, opt, x,
                                                            y, rl)
                else:
                    params, loss, gnorm, gst = step_fn(params, x, y, rl)
                statuses.append(gst)
            elif optimizer == "adam":
                params, opt, loss, *rest = step_fn(params, opt, x, y)
                gnorm = rest[0] if rest else None
            else:
                params, loss, *rest = step_fn(params, x, y)
                gnorm = rest[0] if rest else None
            if kernel_builds() > built:
                compile_s += time.perf_counter() - step_t0
        loss_f = float(loss)  # the chunk's one host read: fences the span
        if statuses:
            statuses = torch.stack(statuses).tolist()
        st["params"], st["opt"] = params, opt
        return chunk, loss_f, gnorm, statuses, compile_s

    def make_event(cp, pos, payload, chunk_sp):
        chunk, loss_f, gnorm, statuses, compile_s = payload
        chunk_sp.args["compile_s"] = round(compile_s, 6)
        chunk_s = chunk_sp.seconds
        if guard is not None:
            st_host = [int(s) for s in statuses]
            skips = st_host.count(STATUS_SKIPPED)
            clips = st_host.count(STATUS_CLIPPED)
            if skips or clips:
                metrics.counter("ft/skipped_steps").inc(skips)
                metrics.counter("ft/clipped_steps").inc(clips)
                cp.sink.emit("ft/guard", step=pos + chunk, skipped=skips,
                             clipped=clips)
            if guard_state.observe(st_host):
                # the stream is poisoned, not glitched: discard this
                # chunk, restore the last committed state, replay
                guard_state.rolled_back()  # GuardFailure past the budget
                metrics.counter("ft/rollbacks").inc()
                rb_sp = cp.rec.open_span("train/rollback",
                                         from_step=pos + chunk)
                # the in-flight async write must publish before we ask
                # "what is the last committed step"
                cp.drain()
                rb_to = checkpoint.latest_step(ckpt_dir)
                if rb_to is None:
                    st["params"], st["opt"] = fresh_state()
                    rb_to = 0
                else:
                    rb_p, rb_o, rb_to, _ = _restore_state(
                        ckpt_dir, st["params"], st["opt"], rb_to,
                        mesh_shape=mesh_shape, reshard=reshard,
                        live_plan=plan_id, commit=commit_opt,
                    )
                    st["params"], st["opt"] = rb_p, rb_o
                cp.rec.close_span(rb_sp)
                # lost wall: the discarded chunk's compute + the restore
                # — the goodput "rollback" badput bucket
                cp.sink.emit("ft/rollback", from_step=pos + chunk,
                             to_step=rb_to,
                             lost_s=round(chunk_s + rb_sp.seconds, 6))
                log(f"guard rollback: step {pos + chunk} -> {rb_to}")
                st["ref_loss"] = float("nan")
                return ChunkResult(pos=rb_to, rollback=True)
        new = pos + chunk
        st["ran"] += chunk
        losses.append(loss_f)
        if math.isfinite(loss_f):
            st["ref_loss"] = loss_f
        metrics.counter("train/steps").inc(chunk)
        metrics.gauge("train/loss").set(loss_f)
        metrics.histogram("train/step_s").observe(chunk_s / chunk)
        metrics.gauge("train/compiles").set(counter.count)
        chunk_ev = {
            "step": new, "loss": loss_f,
            "steps": chunk,
            "tokens": chunk * accum_steps * batch * seq,
            "chunk_s": round(chunk_s, 6),
            "compile_s": round(compile_s, 6),
            "step_s": round(chunk_s / chunk, 6),
            "steps_per_s": round(chunk / chunk_s, 3),
            "tokens_per_s": round(
                chunk * accum_steps * batch * seq / chunk_s, 3
            ),
            "compiles": counter.count,
        }
        if gnorm is not None:
            gnorm_f = float(gnorm)
            chunk_ev["grad_norm"] = gnorm_f
            metrics.gauge("train/grad_norm").set(gnorm_f)
        return ChunkResult(pos=new, event=chunk_ev)

    def snapshot(cp, pos):
        state = ({"params": st["params"], "opt": st["opt"]}
                 if st["opt"] is not None else st["params"])
        return state, metadata

    def on_saved(cp, pos):
        log(f"step {pos}/{steps}: loss {losses[-1]:.5f}")

    def epilogue(cp):
        cp.sink.emit(
            "train/run",
            steps_run=st["ran"], final_step=cp.pos,
            wall_s=round(time.perf_counter() - run_t0, 6),
            compiles=counter.count,
        )
        emit_phase_totals(cp.sink, cp.rec)
        cp.sink.emit_metrics(metrics.snapshot(), scope=metrics.id)
        cp.sink.flush()
        gs = guard_state
        return st["params"], TrainReport(
            st["ran"], cp.pos, tuple(losses),
            skipped=gs.skips if gs else 0,
            clipped=gs.clips if gs else 0,
            rollbacks=gs.rollbacks if gs else 0,
        )

    return ChunkedProgram(
        workload=workload, prefix="train", total=steps, pos=start,
        run_chunk=run_chunk, make_event=make_event, snapshot=snapshot,
        epilogue=epilogue, on_saved=on_saved, preempt_site="train/preempt",
        ckpt_dir=ckpt_dir, keep=keep, save_retry=save_policy,
        write_retry=save_policy, async_ckpt=async_ckpt, sink=sink,
        recorder=rec, metrics=metrics, chaos=chaos, log=log, remake=remake,
    )
