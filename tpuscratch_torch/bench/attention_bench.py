"""Flash-attention throughput (BASELINE config 6).

The twin of ``tpuscratch.bench.attention_bench``: attention TFLOP/s at
(S, H, D), counting the standard 4*S*T*H*D FLOPs (halved for causal,
whose masked half the kernel skips). There, ``rounds`` calls are one
compiled scan with a loop-carried zero perturbing q so the compiler
cannot hoist them; here the calls run eagerly (nothing can hoist them),
``rounds`` a timed iteration bracketed by CUDA events on the card (host
clock on the CPU). The ``max_tflops`` plausibility bound stays: a rate
above the card's peak means the timing is broken.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpuscratch_torch.bench.timing import BenchResult
from tpuscratch_torch.ops.attention import flash_attention
from tpuscratch_torch.runtime.mesh import resolve_device

#: the H100 SXM's dense peaks (NVIDIA data sheet): f32 outside the tensor
#: cores, bf16 on them, TFLOP/s
PEAK_TFLOPS = {torch.float32: 67.0, torch.bfloat16: 989.0}


def attention_flops(S: int, T: int, H: int, D: int, causal: bool, batch: int = 1) -> float:
    """4*S*T*H*D a call, halved when causal (the JAX package's accounting)."""
    return 4.0 * batch * S * T * H * D * (0.5 if causal else 1.0)


def timed_rounds(fn, rounds: int, iters: int, device: torch.device) -> tuple[float, ...]:
    """Seconds of each of ``iters`` runs of ``rounds`` calls of ``fn``:
    CUDA events around the calls on the card, the host clock on the CPU."""
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(rounds):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(rounds):
                fn()
            times.append(time.perf_counter() - t0)
    return tuple(times)


def bench_attention(S: int = 4096, H: int = 8, D: int = 128, causal: bool = True,
                    rounds: int = 50, iters: int = 3, dtype=torch.float32, block_q: int = 1024,
                    block_k: int | None = None, max_tflops: float | None = None,
                    device=None) -> BenchResult:
    """``flash_attention`` on q, k, v ``(S, H, D)`` standard normals (seed
    0): ``iters`` timed runs of ``rounds`` calls after one warm-up call;
    items = FLOPs. Raises when the rate passes ``max_tflops`` (default: the
    card's peak for ``dtype``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, H, D)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))

    def call():
        return flash_attention(q, k, v, causal=causal, block_q=block_q, block_k=block_k)

    call()
    times = timed_rounds(call, rounds, iters, dev)
    flops = attention_flops(S, S, H, D, causal)
    res = BenchResult(name=f"flash S={S} H={H} D={D} causal={causal} "
                           f"{str(dtype).removeprefix('torch.')} x{rounds}",
                      times_s=times, items=int(flops) * rounds)
    bound = max_tflops if max_tflops is not None else PEAK_TFLOPS[dtype]
    if dev.type == "cuda" and res.items_per_s / 1e12 > bound:
        raise AssertionError(f"implausible {res.items_per_s / 1e12:.0f} TFLOP/s "
                             f"(> {bound:.0f}): the timing is broken")
    return res
