"""Composed-training throughput: tokens/s of the full train step.

The twin of ``tpuscratch.bench.train_bench``: the dp x sp transformer
train step (``models.transformer``: ring attention over sp,
expert-parallel MoE over dp, gradients, the copy-axis reduction and the
update) end to end. There, ``steps`` steps are one compiled scan; here
they are an eager loop, each step reading the previous one's parameters,
the whole loop fenced. ``optimizer`` "sgd" or "adam"; ``zero=True`` the
ZeRO step (``models.zero``, Adam with dp-sharded moments through the fused
kernel), ``accum_steps=k`` its deferred-sync accumulation; ``plan`` (a
``parallel.plan.ShardingPlan``) the plan-composed step: a pipelined plan
trains the stacked layers with Adam through ``models.zero.train_step_plan``,
another threads the plan's overlap blocks into the ZeRO step.

FLOP accounting (reported beside tokens/s): active parameters a token =
4 d^2 (attention projections) + capacity_factor * 2 d d_ff (the routed
expert at the router's capacity) a layer, ~6 FLOPs per active parameter
per token (forward 2, backward 4), plus attention's sequence-quadratic
term 12 S d a token a layer (halved when causal).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.bench.timing import BenchResult, time_device
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
    train_step_plan,
    train_step_zero,
)
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh


def train_flops_per_token(cfg: TransformerConfig, seq: int) -> float:
    """Approximate train-step FLOPs per token (see the module docstring)."""
    d, f = cfg.d_model, cfg.d_ff
    dense = 4 * d * d + cfg.capacity_factor * 2 * d * f
    attn = 12 * seq * d * (0.5 if cfg.causal else 1.0)
    return 6.0 * dense * cfg.n_layers + attn * cfg.n_layers


def train_throughput_program(mesh: StackedMesh, cfg: TransformerConfig, steps: int,
                             lr: float = 1e-3, optimizer: str = "sgd", zero: bool = False,
                             accum_steps: int = 1, plan=None):
    """fn(params, x, y) -> (params, loss) running ``steps`` train steps (the
    data is reused: throughput, not learning). ``optimizer="adam"`` starts
    fresh moments inside the program and carries them through;
    ``zero=True`` (Adam only) runs the ZeRO step with fresh dp-sharded
    moments, and ``accum_steps=k`` (ZeRO only) shapes x and y as ``(k,
    batch, seq, d)`` and syncs once a step.

    ``plan`` (over ``mesh``) selects the plan-composed program: a pipelined
    plan runs ``train_step_plan`` (Adam, ZeRO moments with ``zero``) on the
    ``stack_layers`` layout, with fresh moments; another threads
    ``plan.overlap_blocks`` into the ZeRO step."""
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"optimizer must be sgd|adam, got {optimizer!r}")
    if zero and optimizer != "adam":
        raise ValueError("zero=True requires optimizer='adam'")
    if accum_steps > 1 and not zero:
        raise ValueError("accum_steps > 1 is the ZeRO deferred-sync path")
    overlap_blocks = plan.overlap_blocks if plan is not None else 0
    if plan is not None and plan.pipelined:
        if accum_steps != 1:
            raise ValueError("a pipelined plan already microbatches through n_micro; "
                             "accum_steps must be 1")
        if optimizer != "adam":
            raise ValueError("a pipelined plan trains with adam")
        step = train_step_plan(plan, cfg, lr=lr, zero=zero)

        def run(params, x, y):
            opt = init_plan_zero_state(params, plan) if zero else init_adam_state(params)
            loss = None
            for _ in range(steps):
                params, opt, loss = step(params, opt, x, y)
            return params, loss
    elif zero:
        dp, sp = (plan.dp, plan.sp) if plan is not None else ("dp", "sp")
        step = train_step_zero(mesh, cfg, lr=lr, dp=dp, sp=sp, accum_steps=accum_steps,
                               overlap_blocks=overlap_blocks)
        n_dp = mesh.shape[mesh.axis_names.index(dp)]

        def run(params, x, y):
            opt = init_zero_adam_state(params, n_dp)
            loss = None
            for _ in range(steps):
                params, opt, loss = step(params, opt, x, y)
            return params, loss
    elif optimizer == "adam":
        step = train_step_adam(mesh, cfg, lr=lr)

        def run(params, x, y):
            opt = init_adam_state(params)
            loss = None
            for _ in range(steps):
                params, opt, loss = step(params, opt, x, y)
            return params, loss
    else:
        step = train_step(mesh, cfg, lr=lr)

        def run(params, x, y):
            loss = None
            for _ in range(steps):
                params, loss = step(params, x, y)
            return params, loss

    return run


def default_train_setup(on_card: bool):
    """BASELINE row 11's workload: (model cfg, batch, seq, steps). On the
    card the JAX package's TPU shapes (d_model 1024, 8 heads, 4 experts,
    d_ff 4096, 4 layers, capacity factor 2, the flash kernels; batch 8, seq
    2048, 20 steps), on the CPU its CPU shapes."""
    if on_card:
        cfg = TransformerConfig(d_model=1024, n_heads=8, n_experts=4, d_ff=4096, n_layers=4,
                                capacity_factor=2.0, attn_impl="pallas")
        return cfg, 8, 2048, 20
    return TransformerConfig(d_model=32, n_heads=2, n_experts=2, d_ff=64, n_layers=1), 2, 16, 2


def train_data(seed: int, batch: int, seq: int, d_model: int, device,
               accum_steps: int = 1) -> tuple:
    """(x, y) ``(batch, seq, d_model)`` f32 standard normals from ``seed``,
    ``(accum_steps, batch, seq, d_model)`` when ``accum_steps > 1``."""
    shape = (batch, seq, d_model) if accum_steps == 1 else (accum_steps, batch, seq, d_model)
    return tuple(torch.tensor(a, device=device) for a in _data_numpy(seed, shape))


@functools.lru_cache(maxsize=2)
def _data_numpy(seed: int, shape: tuple) -> tuple:
    # kept for the next call with the same draws (a benchmark takes them
    # once a run, and they cost seconds on the host); train_data copies
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def bench_train(mesh: Optional[StackedMesh] = None, cfg: Optional[TransformerConfig] = None,
                batch: Optional[int] = None, seq: Optional[int] = None,
                steps: Optional[int] = None, iters: int = 3, fence: str = "readback",
                seed: int = 0, optimizer: str = "sgd", zero: bool = False, accum_steps: int = 1,
                plan=None, device=None) -> BenchResult:
    """tokens/s of the composed train step; items = tokens processed. The
    mesh defaults to 1x1 on ``device`` (the card unless the caller asks for
    the CPU); ``plan`` brings its own mesh, and a pipelined plan stacks the
    layers and streams ``plan.n_micro`` microbatches a step. The first run
    is the correctness gate: its loss must be finite."""
    if plan is not None:
        mesh = plan.mesh
    if mesh is None:
        mesh = make_mesh((1, 1), ("dp", "sp"), device)
    on_card = mesh.device.type == "cuda"
    dcfg, dbatch, dseq, dsteps = default_train_setup(on_card)
    cfg = cfg if cfg is not None else dcfg
    n_dp = mesh.shape[mesh.axis_names.index("dp")]
    n_sp = mesh.shape[mesh.axis_names.index("sp")]
    batch = batch if batch is not None else (dbatch if on_card else dbatch * n_dp)
    seq = seq if seq is not None else (dseq if on_card else 8 * n_sp)
    steps = steps if steps is not None else dsteps
    prog = train_throughput_program(mesh, cfg, steps, optimizer=optimizer, zero=zero,
                                    accum_steps=accum_steps, plan=plan)
    x, y = train_data(seed, batch, seq, cfg.d_model, mesh.device, accum_steps)
    params = init_params(seed, cfg, mesh.device)
    pipelined = plan is not None and plan.pipelined
    if pipelined:
        params = stack_layers(params)
    _, loss = prog(params, x, y)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"train step produced loss {float(loss)}")
    mesh_tag = "x".join(str(s) for s in mesh.shape)
    opt_tag = (f"{'zero-' if zero else ''}{optimizer}"
               + (f"-accum{accum_steps}" if accum_steps > 1 else ""))
    if plan is not None:
        ov = plan.overlap_blocks
        opt_tag += ((f"-pp{plan.pp_size}-M{plan.n_micro}" if pipelined else "")
                    + (f"-ov{ov}" if ov else "-serial"))
    return time_device(
        prog, params, x, y, iters=iters, warmup=1, fence=fence,
        name=(f"train d{cfg.d_model} ff{cfg.d_ff} L{cfg.n_layers} e{cfg.n_experts} "
              f"{cfg.compute_dtype} {opt_tag} b{batch} s{seq} x{steps} on {mesh_tag} "
              f"({cfg.attn_impl})"),
        items=batch * seq * steps * accum_steps)


def profile_train(mesh: StackedMesh, cfg: TransformerConfig, batch: int, seq: int,
                  steps: int = 2, seed: int = 0, zero: bool = False) -> dict:
    """Where a train step's time goes: ``steps`` SGD steps (``zero``: ZeRO
    Adam steps) timed unprofiled, then as many under ``torch.profiler`` (CPU
    and CUDA activity), after one warm-up run. Returns the unprofiled and profiled wall a step, the
    device's kernel time a step (one stream, so kernels do not overlap), its
    idle share against the unprofiled wall, kernel launches a step, and
    kernel time a step by group and by name (the ten largest)."""
    from torch.profiler import ProfilerActivity, profile

    from tpuscratch_torch.bench.decode_bench import device_time_split

    x, y = train_data(seed, batch, seq, cfg.d_model, mesh.device)
    params = init_params(seed, cfg, mesh.device)
    if zero:
        zstep = train_step_zero(mesh, cfg, lr=1e-3)
        opt = init_zero_adam_state(params, mesh.shape[mesh.axis_names.index("dp")])

        def step(p, xs, ys):
            nonlocal opt
            p, opt, loss = zstep(p, opt, xs, ys)
            return p, loss
    else:
        step = train_step(mesh, cfg, lr=1e-3)

    def run(p):
        loss = None
        for _ in range(steps):
            p, loss = step(p, x, y)
        torch.cuda.synchronize(mesh.device)
        return p, loss

    p, _ = run(params)
    t0 = time.perf_counter()
    p, _ = run(p)
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(p)
        wall = time.perf_counter() - t0
    split = device_time_split(prof, steps)
    step_ms = plain_wall / steps * 1e3
    return {"step_ms": step_ms, "profiled_step_ms": wall / steps * 1e3,
            "device_ms": split["device_ms"], "idle_share": 1.0 - split["device_ms"] / step_ms,
            "launches_per_step": split["launches"], "groups_ms": split["groups_ms"],
            "top_ms": split["top_ms"]}
