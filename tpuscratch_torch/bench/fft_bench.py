"""Pair-FFT throughput: the matrix-form DFT of ``parallel.fft`` on the card.

The twin of ``tpuscratch.bench.fft_bench``. Each round is a forward and
an inverse 2D pair transform (the carry's magnitude stays put across any
number of rounds; the forward transform is held to complex128
``torch.fft`` under ``PAIR_FFT_TOL`` and the round trip checks itself,
before any timing), with the
JAX package's loop-carried ``mean(...) * 0.0`` term, which makes every
round depend on the last. FLOP accounting: one 2D pair-DFT direction is 4
real (N,N)@(N,N) products per axis x 2 axes = 16 N^3 FLOPs, so a round
trip counts 32 N^3; the four-step's own count is 32 N^2 (N1 + N2).

Usage: python -m tpuscratch_torch.bench.fft_bench   (on the card)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuscratch_torch.bench.timing import BenchResult, time_device
from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.parallel.fft import PAIR_FFT_TOL, fft2_sharded_pair
from tpuscratch_torch.runtime.mesh import StackedMesh, make_mesh_1d


def dft_roundtrip_program(mesh: StackedMesh, axis: str, rounds: int, method: str = "direct"):
    """fn(re, im) running ``rounds`` fwd+inv pair FFTs, the row blocks of
    ``(n, n)`` planes split over ``axis``."""

    def body(re, im):
        for _ in range(rounds):
            fr, fi = fft2_sharded_pair(re, im, axis, method=method)
            br, bi = fft2_sharded_pair(fr, fi, axis, inverse=True, method=method)
            # a loop-carried zero: each rank's mean difference from the
            # input (zero up to rounding) times 0.0
            eps = (br - re).mean(dim=(-2, -1), keepdim=True) * 0.0
            re, im = br + eps, bi + eps
        return re, im

    return run_spmd(mesh, body, (P(axis), P(axis)), (P(axis), P(axis)))


def forward_error(got, re: torch.Tensor, im: torch.Tensor) -> float:
    """max|got - want| / max|want| of a forward pair transform ``got`` of
    the world ``(re, im)`` against complex128 ``torch.fft.fft2``."""
    want = torch.fft.fft2(torch.complex(re.double(), im.double()))
    err = max(float((got[0].double() - want.real).abs().max()),
              float((got[1].double() - want.imag).abs().max()))
    return err / float(want.abs().max())


def pair_fft_flops(n: int, method: str, rounds: int) -> int:
    """FLOPs of ``rounds`` fwd+inv 2D pair transforms at the method's OWN
    cost: direct = 32 n^3, four-step = 32 n^2 (n1+n2) (the twiddle's
    elementwise O(n^2) is noise). Compare methods by seconds a round, not
    by these."""
    from tpuscratch_torch.parallel.fft import _split, resolve_method

    if resolve_method(n, method) == "four-step":
        n1, n2 = _split(n)
        return 32 * n * n * (n1 + n2) * rounds
    return 32 * n**3 * rounds


def bench_dft(
    n: Optional[int] = None,
    rounds: Optional[int] = None,
    iters: int = 3,
    mesh: Optional[StackedMesh] = None,
    fence: str = "readback",
    method: str = "direct",
    device=None,
) -> BenchResult:
    """Pair-FFT round-trip throughput on an n x n float32 pair (default
    mesh: one rank on ``device``, the card unless ``device='cpu'``).

    Defaults are the JAX package's chip sizes on the card — 1000 rounds
    at 1024^2, 3.4e13 FLOPs a call — and a few rounds at 64^2 on the CPU.
    ``items`` is the method's own FLOP count (:func:`pair_fft_flops`), so
    compare methods by ``p50``, not ``items_per_s``. Before any timing the
    forward transform is held to complex128 under ``PAIR_FFT_TOL`` (so a
    rate from TF32 products cannot be reported) and the round trip to 1e-2
    of max|input|.
    """
    mesh = mesh if mesh is not None else make_mesh_1d("x", 1, device=device)
    on_card = mesh.device.type == "cuda"
    n = n if n is not None else (1024 if on_card else 64)
    rounds = rounds if rounds is not None else (1000 if on_card else 3)
    (axis,) = mesh.axis_names
    rng = np.random.default_rng(0)
    re = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(mesh.device)
    im = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(mesh.device)
    fwd = run_spmd(mesh, lambda r, i: fft2_sharded_pair(r, i, axis, method=method),
                   (P(axis), P(axis)), (P(axis), P(axis)))
    err = forward_error(fwd(re, im), re, im)
    if not err <= PAIR_FFT_TOL:
        raise AssertionError(f"forward {method} transform at {n}^2: {err:.3e} of max|want| "
                             f"against complex128 (limit {PAIR_FFT_TOL:g})")
    prog = dft_roundtrip_program(mesh, axis, rounds, method)
    out = prog(re, im)
    err = float((out[0] - re).abs().max())
    if not err <= 1e-2 * float(re.abs().max()):
        raise AssertionError(f"round trip drifted: err {err}")
    return time_device(prog, re, im, iters=iters, warmup=1, fence=fence,
                       name=f"pair-FFT[{method}] fwd+inv {n}x{n} x{rounds}",
                       items=pair_fft_flops(n, method, rounds))


def main() -> int:
    r = bench_dft()
    print(f"{r.summary()} -> {r.items_per_s / 1e12:.1f} TFLOP/s (float32 products)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
