"""Flash-attention backward timing, dense and compact (config 6's shape).

The twin of ``tpuscratch.bench.attn_bwd_bench``: the full backward call
(delta, the dq kernel and the dk/dv kernel) at S = T = 4096, H = 8,
D = 128, f32 and bf16, causal and full, through ``_flash_bwd_call``
(dense) and, causal, ``_flash_bwd_compact``. TFLOP/s uses the standard
2.5x-forward accounting (5 backward products against the forward's 2),
causal credited at half. The TPU block retunes it raced have no CUDA
counterpart: the kernels' tile follows D and the card's shared memory.

Usage: python -m tpuscratch_torch.bench.attn_bwd_bench [rounds] [D]
(D, the head width, 128 unless given)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpuscratch_torch.bench.attention_bench import attention_flops, timed_rounds
from tpuscratch_torch.ops import attention as A
from tpuscratch_torch.runtime.mesh import resolve_device

S = T = 4096
H = 8
D = 128


def bwd_once(q, k, v, do, lse, delta, causal: bool, compact: bool):
    """One backward call: dq, dk, dv."""
    if compact:
        return A._flash_bwd_compact(q, k, v, do, lse, delta, 0, 0)
    return A._flash_bwd_call(q, k, v, do, lse, delta, 0, 0, causal)


def backward_inputs(S: int, T: int, H: int, D: int, dtype, causal: bool, device, seed: int = 11):
    """(q, k, v, do, o, lse) with the forward state from one kernel call."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
                   for shape in ((S, H, D), (T, H, D), (T, H, D), (S, H, D)))
    acc, m, l = A._flash_fwd_call(q, k, v, 0, 0, causal, return_state=True)
    o, lse = A._normalize(acc, m, l, dtype)
    return q, k, v, do, o, lse


def time_backward(S: int = S, T: int = T, H: int = H, D: int = D, dtype=torch.float32,
                  causal: bool = True, compact: bool = False, rounds: int = 20, iters: int = 3,
                  device=None) -> dict:
    """Seconds a backward call (the median of ``iters`` runs of ``rounds``)
    and its TFLOP/s."""
    dev = resolve_device(device)
    q, k, v, do, o, lse = backward_inputs(S, T, H, D, dtype, causal, dev)

    def call():
        return bwd_once(q, k, v, do, lse, A._delta(do, o), causal, compact)

    call()
    times = sorted(timed_rounds(call, rounds, iters, dev))
    s = times[len(times) // 2] / rounds
    flops = 2.5 * attention_flops(S, T, H, D, causal)
    return {"s": s, "tflops": flops / s / 1e12, "dtype": str(dtype).removeprefix("torch."),
            "causal": causal, "compact": compact}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 20
    d = int(argv[1]) if len(argv) > 1 else D
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for compact in ((False, True) if causal else (False,)):
                r = time_backward(D=d, dtype=dtype, causal=causal, compact=compact,
                                  rounds=rounds)
                print(f"# D={d} {r['dtype']} causal={int(causal)} "
                      f"{'compact' if compact else 'dense'}: {r['s'] * 1e3:.3f} ms/bwd = "
                      f"{r['tflops']:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
