"""Config-11 ablation harness: where the composed train step spends its
time, and the degenerate pipeline-parallel rows.

The twin of ``tpuscratch.bench.train_ablation``. ``python -m
tpuscratch_torch.bench.train_ablation`` runs, on the card at config 11's
model (d_model 1024, 8 heads, 4 experts, d_ff 4096, 4 layers, flash
attention; batch 8 x seq 2048, 20 steps): the f32 and bf16 steps, bf16 with
the plain ring, with one expert at capacity 1, with Adam; forward-only
loss loops; and the pipelined step on a 1x1x1 mesh at n_micro 1 and 4.
Where the JAX harness folds the steps into one ``lax.scan``, these are
loops of eager steps, each reading the last one's result. Nothing is
caught: a failing row fails the run.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuscratch_torch.bench.timing import BenchResult, time_device
from tpuscratch_torch.bench.train_bench import bench_train, train_data
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.models.transformer import (
    TransformerConfig,
    _loss,
    init_params,
    param_spec,
    stack_layers,
    train_step_pp,
)
from tpuscratch_torch.runtime.mesh import make_mesh

BASE = TransformerConfig(d_model=1024, n_heads=8, n_experts=4, d_ff=4096, n_layers=4,
                         capacity_factor=2.0, attn_impl="pallas")
B, S, STEPS = 8, 2048, 20


def run(label: str, cfg: TransformerConfig, optimizer: str = "sgd", device=None) -> float:
    """ms a step of ``STEPS`` train steps on a 1x1 mesh; printed."""
    mesh = make_mesh((1, 1), ("dp", "sp"), device)
    r = bench_train(mesh, cfg, batch=B, seq=S, steps=STEPS, iters=3, optimizer=optimizer)
    ms = r.p50 / STEPS * 1e3
    print(f"{label}: {ms:.1f} ms/step  {r.items_per_s:.3e} tok/s", flush=True)
    return ms


def fwd_only(label: str, cfg: TransformerConfig, device=None) -> float:
    """ms a step of ``STEPS`` forward losses (no gradients), each step's
    input nudged by the last loss so no step can be skipped; printed."""
    mesh = make_mesh((1, 1), ("dp", "sp"), device)
    pspec = param_spec(cfg)

    def body(params, x, y):
        loss = None
        for _ in range(STEPS):
            loss = _loss(params, x, y, cfg, "sp", "dp")
            x = x + loss[..., None, None, None].to(x.dtype) * 1e-6
        return x[..., 0, 0, 0] + loss

    prog = run_spmd(mesh, body, (pspec, P("dp", "sp"), P("dp", "sp")), P())
    x, y = train_data(0, B, S, cfg.d_model, mesh.device)
    params = init_params(0, cfg, mesh.device)
    with torch.no_grad():
        r = time_device(prog, params, x, y, iters=3, warmup=1, fence="readback", name=label)
    ms = r.p50 / STEPS * 1e3
    print(f"{label}: {ms:.1f} ms/step", flush=True)
    return ms


def pp_row_bench(cfg: TransformerConfig, batch: int, seq: int, steps: int, n_micro: int,
                 iters: int = 3, fence: str = "readback", device=None) -> BenchResult:
    """tokens/s of the 3-axis train step (SGD) on the degenerate 1x1x1 mesh:
    the schedule's overhead on one card (config 11's pp row)."""
    mesh = make_mesh((1, 1, 1), ("dp", "sp", "stage"), device)
    step = train_step_pp(mesh, cfg, lr=1e-3, n_micro=n_micro)

    def prog(params, x, y):
        loss = None
        for _ in range(steps):
            params, loss = step(params, x, y)
        return params, loss

    x, y = train_data(0, batch, seq, cfg.d_model, mesh.device)
    stacked = stack_layers(init_params(0, cfg, mesh.device))
    _, loss = prog(stacked, x, y)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"pipelined train step produced loss {float(loss)}")
    return time_device(prog, stacked, x, y, iters=iters, warmup=1, fence=fence,
                       name=(f"train-pp d{cfg.d_model} L{cfg.n_layers} M={n_micro} b{batch} "
                             f"s{seq} x{steps} on 1x1x1"),
                       items=batch * seq * steps)


def pp_row(n_micro: int, device=None) -> float:
    r = pp_row_bench(BASE, batch=B, seq=S, steps=STEPS, n_micro=n_micro, device=device)
    ms = r.p50 / STEPS * 1e3
    print(f"pp degenerate 1x1x1 M={n_micro}: {ms:.1f} ms/step  {r.items_per_s:.3e} tok/s",
          flush=True)
    return ms


def main() -> int:
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    bf = dataclasses.replace(BASE, compute_dtype="bfloat16")
    run("f32 full (config-11 anchor)", BASE)
    run("bf16 full", bf)
    run("bf16 attn=xla (dense hops)", dataclasses.replace(bf, attn_impl="xla"))
    run("bf16 e=1 cap=1 (MoE share)", dataclasses.replace(bf, n_experts=1, capacity_factor=1.0))
    run("bf16 adam", bf, optimizer="adam")
    fwd_only("bf16 fwd-only (loss loop)", bf)
    fwd_only("f32 fwd-only (loss loop)", BASE)
    fwd_only("bf16 e=1 cap=1 fwd-only", dataclasses.replace(bf, n_experts=1, capacity_factor=1.0))
    run("f32 adam", BASE, optimizer="adam")
    pp_row(1)
    pp_row(4)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
