"""Device times of the paged-attention and ``dma_hbm_step`` kernels through
their wrappers, for an A/B of two checkouts on one card.

Cases (config 12's attention geometry: 8 heads, d_head 128, 16-token
pages, one query a sequence; config 4's and 10's stencil steps):

- ``paged warm``: 32 sequences of 128 cached tokens, f32, int8 and fp8
  pools, the same call back to back (its 33.5 MB of f32 pages stay in L2);
- ``paged cold``: the same through 8 tables over disjoint pages of a
  2048-page pool, rotated, so that a table's pages have left the 50 MB L2
  before it comes back;
- ``paged long``: 4 sequences of 4096 cached tokens;
- ``hbm``: one Jacobi step of 8192^2 stacked on 4x4 and of 1024^2 on 1x1.

Usage, from the root of a checkout, on a machine with a card:

    python tpuscratch_torch/bench/kernel_ab.py [--root DIR] [--label NAME]

``--sweep`` times the paged kernels under other plans than the host
rule's instead (chunk tokens, ring stages, split count). ``--root`` imports ``tpuscratch_torch`` from another checkout (for example
a parent commit unpacked with ``git archive`` into ``build/parent``), whose
kernels build into that checkout's own build directory; the wrappers'
signatures are the same on both sides. Prints the card's name and power
limit, then one JSON line a case: ``{"label", "case", "ms"}``. Run it as
parent, change, change, parent in one command to compare the two.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import subprocess
import sys

H, D, PAGE = 8, 128, 16
COLD_POOL, COLD_TABLES = 2048, 8


def device_ms(fn, n: int = 40) -> float:
    """Device time of one ``fn()``: CUDA events around ``n`` calls queued
    behind a sleep kernel (the host's launch cost hidden)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _pool(P: int, dtype, gen):
    import torch

    from tpuscratch_torch.serve.kvcache import quantize_pages

    kf = torch.randn((P, PAGE, H, D), generator=gen, device="cuda")
    vf = torch.randn((P, PAGE, H, D), generator=gen, device="cuda")
    if dtype == torch.float32:
        return kf, vf, None, None
    (k, ks), (v, vs) = quantize_pages(kf, dtype), quantize_pages(vf, dtype)
    return k, v, ks, vs


def paged_cases(gen):
    """(case, ms) of the paged kernel."""
    import numpy as np
    import torch

    from tpuscratch_torch.ops import attention as ta

    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.int8, torch.float8_e4m3fn):
        name = str(dtype).removeprefix("torch.")
        for B, T, what in ((32, 128, "warm"), (32, 128, "cold"), (4, 4096, "long")):
            per = B * T // PAGE
            P = COLD_POOL if what != "warm" else 512
            k, v, ks, vs = _pool(P, dtype, gen)
            perm = rng.permutation(P)
            n_tab = min(COLD_TABLES, P // per) if what == "cold" else 1
            tables = [torch.from_numpy(perm[j * per:(j + 1) * per].reshape(B, -1)
                                       .astype(np.int32)).cuda() for j in range(n_tab)]
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
            lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
            calls = [lambda t=t: ta.paged_attention(q, k, v, t, lens, ks, vs) for t in tables]
            for t, call in zip(tables, calls):
                want = ta._verify_attention_dense(q, k, v, t, lens, ks, vs)
                err = float((call() - want).abs().max())
                if err > 1e-5:
                    raise AssertionError(f"paged {what} {name}: max_abs_err {err}")
            it = itertools.cycle(calls)
            yield f"paged {what} B{B} T{T} {name}", device_ms(lambda: next(it)())
            del k, v, ks, vs, tables, calls


def plan_sweep(gen):
    """(case, ms) of the paged kernels under other plans than the host
    rule's (chunk tokens, ring stages, split count), on this checkout only:
    how the rule's choices were checked."""
    import dataclasses

    import numpy as np
    import torch

    from tpuscratch_torch.ops import attention as ta

    rng = np.random.default_rng(1)
    sms, optin = ta._paged_device(torch.cuda.current_device())
    for dtype in (torch.float32, torch.int8):
        name = str(dtype).removeprefix("torch.")
        for B, T in ((32, 128), (4, 4096)):
            per = B * T // PAGE
            k, v, ks, vs = _pool(2 * per, dtype, gen)
            table = torch.from_numpy(rng.permutation(2 * per)[:per].reshape(B, -1)
                                     .astype(np.int32)).cuda()
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
            lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
            ops = (q, k, v, table, lens, ks, vs)
            want = ta._verify_attention_dense(*ops)
            base = ta.paged_plan(B, 1, H, D, PAGE, T // PAGE, k.element_size(), 16, sms, optin)
            for tt in (8, 16, 32, 64):
                for stages in (2, 3, 4):
                    for n_split in (1, 2, 4, 8, 16, 32, 64):
                        if n_split > 1 and T // n_split < tt:
                            continue
                        split_len = -(-(-(-T // n_split)) // tt) * tt
                        smem = ta.paged_smem(k.element_size(), D, base.nj, base.wide, base.wq,
                                             tt, stages)
                        if smem > optin:
                            continue
                        plan = dataclasses.replace(base, tt=tt, stages=stages, smem=smem,
                                                   split_len=split_len,
                                                   n_split=-(-T // split_len))
                        err = float((ta._paged_launch(plan, *ops) - want).abs().max())
                        if err > 1e-5:
                            raise AssertionError(f"sweep {plan}: max_abs_err {err}")
                        mark = " (rule)" if plan == base else ""
                        yield (f"sweep B{B} T{T} {name} tt={tt} stages={stages} "
                               f"splits={plan.n_split}{mark}",
                               device_ms(lambda: ta._paged_launch(plan, *ops)))
            del k, v, ks, vs


def hbm_cases(gen):
    """(case, ms) of the stencil step."""
    import torch

    from tpuscratch_torch.ops import halo_dma as hd

    for lead, n in (((4, 4), 2048), ((1, 1), 1024)):
        cores = torch.randn(lead + (n, n), generator=gen, device="cuda")
        coeffs = (0.25, 0.25, 0.25, 0.25, 0.0)
        if not torch.equal(hd.dma_hbm_step(cores, coeffs), hd.dma_hbm_step_plain(cores, coeffs)):
            raise AssertionError(f"dma_hbm_step {lead} {n}^2 differs from its plain version")
        yield (f"hbm {lead[0] * n}^2 on {lead[0]}x{lead[1]}",
               device_ms(lambda: hd.dma_hbm_step(cores, coeffs)))
        del cores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import tpuscratch_torch from this checkout")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="time the paged kernels under other plans (this checkout only)")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root or pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path[0] = str(root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import tpuscratch_torch

    if pathlib.Path(tpuscratch_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tpuscratch_torch.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"# {args.label or root}: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = plan_sweep(gen) if args.sweep else itertools.chain(paged_cases(gen), hbm_cases(gen))
    for case, ms in cases:
        print(json.dumps({"label": args.label or str(root), "case": case, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
