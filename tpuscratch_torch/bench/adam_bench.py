"""Race of the Adam update forms over a synthetic 253,921,280-parameter tree.

The twin of ``tpuscratch.bench.adam_bench``. Forms:
  3-map        : the train step's form (``models.transformer._adam_update``:
                 a pass for mu, one for nu, one for w, each several torch ops)
  1-map        : one closure a leaf computing (w', m', v')
                 (``ops.adam.fused_adam_plain``); eager torch fuses nothing,
                 so it launches as many kernels as 3-map
  1-map-bf16m  : the same with bfloat16 moment storage
  kernel       : ``ops.adam.fused_adam_tree``, one ``csrc/adam.cu`` launch a
                 leaf, float32 moments (28 B an element)
  kernel-bf16m : the same kernel, bfloat16 moments (20 B an element)

ms/update is the device time of ``rounds`` chained updates (CUDA events)
over ``rounds``. The JAX package perturbs the gradients every round so that
its compiled scan cannot hoist them; an eager loop hoists nothing, so the
gradients stay as they are (a perturbation would add a pass of its own).
Before any timing, the kernel is held to 3-map after 3 updates (1e-5): a
wrong kernel must not win a race.

Usage: python -m tpuscratch_torch.bench.adam_bench [rounds]   (on the card)
"""

from __future__ import annotations

import math
import sys

import torch

from tpuscratch_torch.models.transformer import _adam_update
from tpuscratch_torch.ops.adam import fused_adam_plain, fused_adam_tree
from tpuscratch_torch.runtime.mesh import resolve_device

LEAVES = {
    "wq": (4, 1024, 1024), "wk": (4, 1024, 1024),
    "wv": (4, 1024, 1024), "wo": (4, 1024, 1024),
    "w1": (4, 4, 1024, 4096), "w2": (4, 4, 4096, 1024),
    "emb": (50257, 1024), "head": (1024, 50257),
}
FORMS = (("3-map", torch.float32), ("1-map", torch.float32), ("1-map-bf16m", torch.bfloat16),
         ("kernel", torch.float32), ("kernel-bf16m", torch.bfloat16))
B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-3


def n_params(leaves=LEAVES) -> int:
    return sum(math.prod(s) for s in leaves.values())


def make_tree(gen: torch.Generator, dtype=torch.float32, leaves=LEAVES, positive=False) -> dict:
    """Leaves of ``0.01 * N(0, 1)`` (their magnitudes with ``positive``, for a
    second moment), drawn on ``gen``'s device and stored in ``dtype``."""
    out = {}
    for k, s in leaves.items():
        x = 0.01 * torch.randn(s, generator=gen, device=gen.device)
        out[k] = (x.abs() if positive else x).to(dtype)
    return out


def update(form: str, params, grads, mu, nu, t: torch.Tensor):
    """One update of ``form`` at step ``t`` (0-dim int32, 1-based):
    (params, mu, nu). The kernel forms update in place."""
    if form == "3-map":
        params, opt = _adam_update(params, {"mu": mu, "nu": nu, "t": t - 1}, grads,
                                   LR, B1, B2, EPS)
        return params, opt["mu"], opt["nu"]
    tf = t.to(torch.float32)
    alpha = LR * torch.sqrt(1.0 - B2 ** tf) / (1.0 - B1 ** tf)
    if form.startswith("1-map"):
        out = {k: fused_adam_plain(params[k], grads[k], mu[k], nu[k], alpha, B1, B2, EPS)
               for k in params}
        return ({k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()},
                {k: o[2] for k, o in out.items()})
    return fused_adam_tree(params, grads, mu, nu, alpha, B1, B2, EPS, donate=True)


def run(form: str, params, grads, mu, nu, rounds: int):
    """``rounds`` chained updates from copies of the trees: (params, mu, nu)."""
    params, mu, nu = ({k: v.clone() for k, v in tree.items()} for tree in (params, mu, nu))
    t = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
    for _ in range(rounds):
        t = t + 1
        params, mu, nu = update(form, params, grads, mu, nu, t)
    return params, mu, nu


def time_form(form: str, params, grads, mu, nu, rounds: int) -> float:
    """Device ms an update: CUDA events around ``rounds`` chained updates,
    after one untimed round."""
    p, m, v = ({k: x.clone() for k, x in tree.items()} for tree in (params, mu, nu))
    t = torch.ones((), dtype=torch.int32, device=next(iter(p.values())).device)
    p, m, v = update(form, p, grads, m, v, t)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(rounds):
        t = t + 1
        p, m, v = update(form, p, grads, m, v, t)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def gate(params, grads, mu, nu, tol: float = 1e-5) -> float:
    """The kernel against 3-map after 3 updates: max |w_kernel - w_3map|
    over every leaf; raises above ``tol``."""
    w_a, _, _ = run("3-map", params, grads, mu, nu, 3)
    w_b, _, _ = run("kernel", params, grads, mu, nu, 3)
    err = max(float((w_a[k] - w_b[k]).abs().max()) for k in w_a)
    if not err <= tol:
        raise AssertionError(f"fused Adam kernel disagrees with 3-map: {err} > {tol}")
    return err


def race(rounds: int = 20, seed: int = 17, leaves=LEAVES, device=None) -> dict:
    """The gate, then each form's ms/update and effective GB/s (28 or 20 B
    an element over the ms) on the card: ``{"n", "gate_err", "forms": {form:
    {"ms", "gbps"}}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("adam_bench times device work: it needs the card")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = n_params(leaves)
    params, grads = make_tree(gen, leaves=leaves), make_tree(gen, leaves=leaves)
    err = gate(params, grads, make_tree(gen, leaves=leaves),
               make_tree(gen, leaves=leaves, positive=True))
    forms = {}
    for form, mdt in FORMS:
        mu = make_tree(gen, mdt, leaves)
        nu = make_tree(gen, mdt, leaves, positive=True)
        ms = time_form(form, params, grads, mu, nu, rounds)
        per = 28 if mdt == torch.float32 else 20
        forms[form] = {"ms": ms, "gbps": per * n / (ms * 1e-3) / 1e9}
        del mu, nu
        torch.cuda.empty_cache()
    return {"n": n, "gate_err": err, "forms": forms}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 20
    print(f"# {n_params():,} params, {rounds} chained updates, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    r = race(rounds)
    print(f"# kernel vs 3-map max |diff| after 3 updates: {r['gate_err']:.3e}", flush=True)
    for form, v in r["forms"].items():
        print(f"# {form}: {v['ms']:.3f} ms/update ({v['gbps']:.0f} GB/s effective)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
