"""ZeRO-sharded training step: reduce-scatter grad sync, dp-sharded fused
Adam, deferred-sync gradient accumulation.

The twin of ``tpuscratch.models.zero``'s dp x sp part (its plan and
pipeline steps wait for ROADMAP A13d). The replicated step
(``models.transformer.train_step_adam``) all-reduces every gradient and
every rank holds the params and both Adam moments whole. ZeRO (stage 1/2):

- the non-expert gradients are packed into one flat f32 vector
  (``transformer.pack_nonexpert``) and reduce-scattered over "dp": each
  rank keeps its ``1/|dp|`` shard, ``(n-1) * shard`` wire bytes where the
  all-reduce moved ``2(n-1)/n * full``; the shard is then summed over the
  "sp" copies;
- the Adam moments of those parameters live as flat per-rank shards (spec
  ``P(dp)``), so per-rank optimizer bytes divide by ``|dp|``; each rank's
  shard of (w, g, m, v) goes through one fused Adam launch
  (``ops.adam.fused_adam_tree``, ``csrc/adam.cu``), every rank of the
  stacked mesh in the same launch with its own step size. Expert leaves are
  already dp-split and keep the elementwise update and an "sp" sum;
- one trailing all-gather over "dp" rebuilds the replicated params;
- ``accum_steps=k`` takes ``(k, B, S, d)`` microbatches, sums local
  gradients over a loop with no collective inside, and syncs once;
- ``overlap_blocks=k`` cuts the reduce-scatter, the update and the
  all-gather into ``k`` independent block chains in a strided layout that
  keeps each rank's elements those of the serial schedule, so results are
  the same bit for bit (the JAX package lets its scheduler overlap the
  chains; here they run in order on one stream).

Inside ``run_spmd`` every value is stacked ``(*mesh, ...)``: a rank's pick
of its shard is an index over the dp dim from ``axis_index``, and every
per-rank op counts its dims from the end. ``guard=`` and ``counter=`` are
not ported (ROADMAP A10).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import all_gather, allreduce_sum, reduce_scatter
from tpuscratch_torch.comm.spmd import P, axis_index, axis_size, current_mesh, run_spmd
from tpuscratch_torch.models.transformer import (
    EXPERT_LEAVES,
    LAYER_LEAVES,
    TransformerConfig,
    _adam_apply,
    _is_expert_leaf,
    _jax_paths,
    _map,
    _no_levers,
    _validate_step_config,
    _value_and_grad,
    adam_alpha,
    expert_leaves,
    nonexpert_size,
    pack_nonexpert,
    param_spec,
    params_from_numpy,
    unpack_nonexpert,
)
from tpuscratch_torch.ops.adam import fused_adam_tree, writable_rows
from tpuscratch_torch.runtime.errors import CommError
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device

__all__ = [
    "init_zero_adam_state",
    "local_zero_state",
    "reshard_state",
    "train_step_zero",
    "train_step_zero_fn",
    "zero_flat_size",
    "zero_state_bytes_per_rank",
    "zero_state_from_numpy",
    "zero_state_spec",
]

#: pad quantum per rank, as in the JAX package (its shards stay multiples of
#: the f32 sublane, 8); kept so that a JAX ZeRO state crosses over unchanged
_SHARD_QUANTUM = 8


def zero_flat_size(n_elems: int, n_dp: int) -> int:
    """Padded length of the packed non-expert vector: the smallest multiple
    of ``n_dp * 8`` holding ``n_elems`` (every rank's shard equal-sized)."""
    q = n_dp * _SHARD_QUANTUM
    return -(-n_elems // q) * q


def init_zero_adam_state(params, n_dp: int) -> dict:
    """Fresh ZeRO Adam state for ``params`` on a ``|dp| = n_dp`` mesh:
    ``mu_flat``/``nu_flat`` the global flat f32 moment vectors of
    :func:`zero_flat_size` elements (spec ``P(dp)``: each rank holds its
    shard), ``mu_exp``/``nu_exp`` the expert-leaf moments (split over dp with
    their leaves), ``t`` the step count (0-dim int32)."""
    exp = expert_leaves(params)
    dev = _jax_paths(params)[0][1].device
    flat = zero_flat_size(nonexpert_size(params), n_dp)
    return {
        "mu_flat": torch.zeros(flat, dtype=torch.float32, device=dev),
        "nu_flat": torch.zeros(flat, dtype=torch.float32, device=dev),
        "mu_exp": [torch.zeros_like(x) for x in exp],
        "nu_exp": [torch.zeros_like(x) for x in exp],
        "t": torch.zeros((), dtype=torch.int32, device=dev),
    }


def zero_state_spec(cfg: TransformerConfig, dp: str = "dp") -> dict:
    """PartitionSpec tree for :func:`init_zero_adam_state`'s output."""
    n_exp = sum(1 for name in LAYER_LEAVES if name in EXPERT_LEAVES)
    exp = [P(dp)] * (n_exp * cfg.n_layers)
    return {"mu_flat": P(dp), "nu_flat": P(dp), "mu_exp": exp, "nu_exp": list(exp), "t": P()}


def zero_state_from_numpy(state, device=None) -> dict:
    """A ZeRO state (the JAX package's ``init_zero_adam_state`` output or a
    step's, as numpy arrays) on ``device`` (the card unless the caller asks
    for the CPU), bit for bit; ``t`` becomes a 0-dim int32 tensor."""
    out = params_from_numpy({k: state[k] for k in ("mu_flat", "nu_flat", "mu_exp", "nu_exp")},
                            device)
    out["t"] = torch.tensor(int(np.asarray(state["t"])), dtype=torch.int32,
                            device=resolve_device(device))
    return out


def zero_state_bytes_per_rank(cfg: TransformerConfig, params, n_dp: int) -> int:
    """Per-rank optimizer-state bytes of the ZeRO layout: both flat moment
    shards plus this rank's share of the expert-leaf moments."""
    shard = zero_flat_size(nonexpert_size(params), n_dp) // n_dp
    exp = sum(2 * x.numel() * x.element_size() // n_dp for x in expert_leaves(params))
    return 2 * shard * 4 + exp


def local_zero_state(params_local, n_dp: int) -> dict:
    """Fresh per-rank ZeRO state INSIDE a ``run_spmd`` body, from the
    stacked ``(*mesh, ...)`` local params: stacked flat moment shards
    ``(*mesh, flat/n_dp)``, expert moments like the local expert slices,
    and ``t`` ``(*mesh)``."""
    mesh = current_mesh()
    lead = len(mesh.shape)
    exp = expert_leaves(params_local)
    dev = mesh.device
    flat = zero_flat_size(nonexpert_size(params_local, lead), n_dp)
    return {
        "mu_flat": torch.zeros(*mesh.shape, flat // n_dp, dtype=torch.float32, device=dev),
        "nu_flat": torch.zeros(*mesh.shape, flat // n_dp, dtype=torch.float32, device=dev),
        "mu_exp": [torch.zeros_like(x) for x in exp],
        "nu_exp": [torch.zeros_like(x) for x in exp],
        "t": torch.zeros(mesh.shape, dtype=torch.int32, device=dev),
    }


def _plan_groups(plan: dict) -> tuple[int, int, bool]:
    """(pp, dp, pipelined-family?) of a plan identity ``{dp, sp, pp, n_micro}``."""
    pp = int(plan.get("pp", 1))
    n_micro = int(plan.get("n_micro", 1))
    return pp, int(plan["dp"]), (pp > 1 or n_micro > 1)


def reshard_state(opt, params, saved: dict, live: dict):
    """Regroup a ZeRO optimizer state from the plan identity ``saved`` onto
    the plan ``live`` (both ``{dp, sp, pp, n_micro}`` dicts): each of
    ``saved``'s pp stage groups is unpacked into per-leaf moments (padding
    dropped: padded slots carry zero moments), re-packed under ``live``'s
    stage grouping and re-padded to ``zero_flat_size`` of the live ``|dp|``.
    Expert moments and the step count pass through. Numpy-pure, a copy of
    the JAX package's; ``params`` may hold torch tensors or numpy arrays (only
    their shapes are read). A stage-stacked and a flat layout cannot be
    regrouped into each other: that raises ``CommError``."""
    pp_a, dp_a, fam_a = _plan_groups(saved)
    pp_b, dp_b, fam_b = _plan_groups(live)
    if fam_a != fam_b:
        raise CommError(
            "ckpt/reshard",
            f"checkpointed plan {saved} and live plan {live} are different state-layout "
            f"families (stage-stacked vs flat dp x sp) — reshard_state regroups shards, it "
            f"cannot migrate the params structure")
    if pp_a == pp_b and dp_a == dp_b:
        return opt
    shapes = [tuple(leaf.shape) for path, leaf in _jax_paths(params)
              if not _is_expert_leaf(path)]
    n = sum(math.prod(s) for s in shapes)
    for pp in {pp_a, pp_b}:
        if pp > 1 and any(s[0] % pp for s in shapes):
            raise CommError("ckpt/reshard",
                            f"a stacked leaf's layer axis is not divisible by pp={pp} "
                            f"(shapes {shapes})")
    flat_a = zero_flat_size(n // pp_a, dp_a)

    def gather(vec):
        """saved-layout flat vector -> per-leaf moment arrays."""
        vec = np.asarray(vec, np.float32)
        if vec.shape != (pp_a * flat_a,):
            raise CommError("ckpt/reshard",
                            f"flat moment vector has {vec.shape[0]} elements, plan {saved} "
                            f"implies {pp_a} stage(s) x {flat_a} — the checkpoint does not "
                            f"match its recorded plan")
        per = n // pp_a
        parts: list[list] = [[] for _ in shapes]
        for s in range(pp_a):
            seg = vec[s * flat_a: s * flat_a + per]
            off = 0
            for i, shape in enumerate(shapes):
                ln = math.prod(shape) // pp_a
                sub = ((shape[0] // pp_a,) + shape[1:]) if pp_a > 1 else shape
                parts[i].append(seg[off:off + ln].reshape(sub))
                off += ln
        return [np.concatenate(p, axis=0) if pp_a > 1 else p[0] for p in parts]

    def resplit(moments):
        """per-leaf moment arrays -> live-layout flat vector."""
        per = n // pp_b
        flat_b = zero_flat_size(per, dp_b)
        out = np.zeros((pp_b * flat_b,), np.float32)
        for s in range(pp_b):
            segs = []
            for m, shape in zip(moments, shapes):
                if pp_b > 1:
                    ls = shape[0] // pp_b
                    segs.append(np.ravel(m[s * ls:(s + 1) * ls]))
                else:
                    segs.append(np.ravel(m))
            out[s * flat_b: s * flat_b + per] = np.concatenate(segs)
        return out

    return {
        "mu_flat": resplit(gather(opt["mu_flat"])),
        "nu_flat": resplit(gather(opt["nu_flat"])),
        "mu_exp": [np.asarray(x) for x in opt["mu_exp"]],
        "nu_exp": [np.asarray(x) for x in opt["nu_exp"]],
        "t": np.asarray(opt["t"]),
    }


def _overlap_blocks(requested: int, shard_elems: int) -> int:
    """Block count of the decomposed sync legs: the largest ``k <=
    requested`` dividing the per-rank shard; ``requested <= 1`` is serial."""
    if requested <= 1 or shard_elems <= 1:
        return 1
    k = min(requested, shard_elems)
    while shard_elems % k:
        k -= 1
    return k


def _zero_grad_sync(grads, n: int, dp: str, sp: str, flat_size: int, blocks: int = 1):
    """The one deferred gradient sync on stacked per-copy gradients: pack the
    non-expert leaves flat, reduce-scatter over "dp", sum the shard over the
    "sp" copies, sum expert leaves over "sp" only, all divided by ``n``.
    Returns ``(g_shard (*mesh, shard), g_exp)``, or with ``blocks > 1`` a list
    of block shards whose concatenation is the serial shard: block c of a
    rank covers flat positions ``[me*shard + c*cs, ...)``."""
    lead = len(current_mesh().shape)
    g_flat = pack_nonexpert(grads, flat_size, lead)
    g_exp = [allreduce_sum(g, sp) / n for g in expert_leaves(grads)]
    if blocks > 1:
        n_dp = axis_size(dp)
        cs = flat_size // n_dp // blocks
        g3 = g_flat.reshape(*g_flat.shape[:-1], n_dp, blocks, cs)
        chunks = []
        for c in range(blocks):
            gc = g3[..., c, :].flatten(-2)
            s = reduce_scatter(gc, dp, scatter_dimension=0, tiled=True)
            chunks.append(allreduce_sum(s, sp) / n)
        return chunks, g_exp
    g_shard = reduce_scatter(g_flat, dp, scatter_dimension=0, tiled=True)
    return allreduce_sum(g_shard, sp) / n, g_exp


def _local_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-rank sum of squares of a stacked value: ``(*mesh)``."""
    lead = len(current_mesh().shape)
    return torch.sum(torch.square(x.float()), dim=tuple(range(lead, x.ndim)))


def _zero_grad_norm(g_shard, g_exp, axes):
    """Global L2 norm ``(*mesh)`` of the reduced gradient under the ZeRO
    layout: the shard square sums summed over ``axes`` (each rank holds a
    disjoint slice; padding is zero), the expert leaves' likewise."""
    chunks = g_shard if isinstance(g_shard, (list, tuple)) else [g_shard]
    s = allreduce_sum(sum(_local_sum(c) for c in chunks), axes)
    for g in g_exp:
        s = s + allreduce_sum(_local_sum(g), axes)
    return torch.sqrt(s)


def _pick(x: torch.Tensor, me: torch.Tensor, dim: int) -> torch.Tensor:
    """Each rank's own index ``me`` (``(*mesh)``) along local dim ``dim``
    (counted from the end, negative) of a stacked ``x``: drops that dim."""
    d = x.ndim + dim
    idx = me.reshape(*me.shape, *(1,) * (x.ndim - me.ndim)).expand(
        *x.shape[:d], 1, *x.shape[d + 1:])
    return torch.gather(x, d, idx).squeeze(d)


def _zero_flat_update(w_flat, g_shard, mu, nu, alpha, b1, b2, eps, dp: str, fused: bool,
                      donate: bool):
    """Update this rank's shard of the packed flat vector and rebuild the
    replicated vector with the trailing all-gather: ``(new_flat (*mesh,
    flat), new_mu, new_nu)``. ``g_shard`` a tensor: one fused launch over
    every rank's shard, one all-gather; a block list: a launch and an
    all-gather a block, each rank's elements those of the serial schedule.
    ``donate`` (with ``fused``) writes the moments into ``mu``/``nu`` where
    each rank's shard is its own memory."""
    lead = len(current_mesh().shape)
    n_dp = axis_size(dp)
    me = axis_index(dp)
    shard = w_flat.shape[-1] // n_dp
    in_place = fused and donate and writable_rows(mu, lead) and writable_rows(nu, lead)

    def apply(wc, gc, mc, vc):
        if fused:
            nw, nm, nv = fused_adam_tree([wc], [gc], [mc], [vc], alpha, b1, b2, eps,
                                         donate=in_place)
            return nw[0], nm[0], nv[0]
        return _adam_apply(wc, mc, vc, gc, alpha, b1, b2, eps)

    if not isinstance(g_shard, (list, tuple)):
        w_shard = _pick(w_flat.unflatten(-1, (n_dp, shard)), me, -2)
        w_shard, mu, nu = apply(w_shard, g_shard, mu, nu)
        return all_gather(w_shard, dp, tiled=True), mu, nu

    blocks = len(g_shard)
    cs = shard // blocks
    w_my = _pick(w_flat.unflatten(-1, (n_dp, blocks, cs)), me, -3)  # (*mesh, blocks, cs)
    mu2, nu2 = mu.unflatten(-1, (blocks, cs)), nu.unflatten(-1, (blocks, cs))
    gathered, new_mu, new_nu = [], [], []
    for c in range(blocks):
        wc, mc, vc = apply(w_my[..., c, :], g_shard[c], mu2[..., c, :], nu2[..., c, :])
        gathered.append(all_gather(wc, dp, tiled=True).unflatten(-1, (n_dp, cs)))
        new_mu.append(mc)
        new_nu.append(vc)
    # (*mesh, n_dp, blocks, cs) -> flat: position d*shard + c*cs + e, the
    # serial layout rebuilt from the block gathers
    full = torch.stack(gathered, dim=-2).flatten(-3)
    if in_place:  # the blocks were written into mu and nu
        return full, mu, nu
    return full, torch.cat(new_mu, dim=-1), torch.cat(new_nu, dim=-1)


def _zero_apply_update(params, opt, g_shard, g_exp, flat_size, lr, b1, b2, eps, dp: str,
                       fused: bool, donate: bool):
    """Flat-shard Adam with the trailing all-gather, elementwise Adam on the
    local expert leaves, repacked into a tree shaped like ``params``:
    ``(new_params, new_opt)``."""
    lead = len(current_mesh().shape)
    t = opt["t"] + 1
    alpha = adam_alpha(t, lr, b1, b2)
    w_flat = pack_nonexpert(params, flat_size, lead)
    new_flat, mu_flat, nu_flat = _zero_flat_update(
        w_flat, g_shard, opt["mu_flat"], opt["nu_flat"], alpha, b1, b2, eps, dp, fused, donate)
    exp_w, mu_exp, nu_exp = _adam_apply(expert_leaves(params), opt["mu_exp"], opt["nu_exp"],
                                        g_exp, alpha, b1, b2, eps)
    new_params = unpack_nonexpert(new_flat, exp_w, params, lead)
    return new_params, {"mu_flat": mu_flat, "nu_flat": nu_flat, "mu_exp": mu_exp,
                        "nu_exp": nu_exp, "t": t}


def train_step_zero_fn(cfg: TransformerConfig, lr: float = 1e-3, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8, sp: str = "sp", dp: str = "dp",
                       accum_steps: int = 1, with_grad_norm: bool = False, guard=None,
                       fused: bool = True, overlap_blocks: int = 0, donate: bool = False):
    """The ``run_spmd`` body: (params, opt, x, y) -> (params, opt, loss) (+
    grad_norm with ``with_grad_norm``), ``opt`` laid out by
    :func:`init_zero_adam_state`.

    ``accum_steps=k``: x and y are ``(k, B, S, d)``; local gradients are
    summed over the k microbatches and synced once. ``fused=False`` swaps
    the fused kernel for the same elementwise expression
    (``transformer._adam_apply``). ``overlap_blocks=k`` (0/1 = off) splits
    the sync legs and the update into ``k`` block chains, bit-identical to
    the serial schedule. ``donate`` lets the fused update write the flat
    moments in place (see :func:`train_step_zero`)."""
    _no_levers(guard, None)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def core(params, x, y):
        lead = len(current_mesh().shape)
        n_dp = axis_size(dp)
        n = n_dp * axis_size(sp)
        if accum_steps == 1:
            loss, grads = _value_and_grad(params, x, y, cfg, sp, dp)
        else:
            loss = torch.zeros(current_mesh().shape, dtype=torch.float32, device=x.device)
            grads = _map(lambda _p, w: torch.zeros_like(w), params)
            for i in range(accum_steps):
                loss_i, g_i = _value_and_grad(params, x.select(lead, i), y.select(lead, i),
                                              cfg, sp, dp)
                loss = loss + loss_i
                grads = _map(lambda _p, a, b: a + b, grads, g_i)
            loss = loss / accum_steps
            grads = _map(lambda _p, g: g / accum_steps, grads)
        flat_size = zero_flat_size(nonexpert_size(params, lead), n_dp)
        blocks = _overlap_blocks(overlap_blocks, flat_size // n_dp)
        g_shard, g_exp = _zero_grad_sync(grads, n, dp, sp, flat_size, blocks)
        return loss, g_shard, g_exp, flat_size

    def step(params, opt, x, y):
        loss, g_shard, g_exp, flat_size = core(params, x, y)
        new_params, new_opt = _zero_apply_update(params, opt, g_shard, g_exp, flat_size, lr,
                                                 b1, b2, eps, dp, fused, donate)
        if with_grad_norm:
            return new_params, new_opt, loss, _zero_grad_norm(g_shard, g_exp, dp)
        return new_params, new_opt, loss

    return step


def train_step_zero(mesh: StackedMesh, cfg: TransformerConfig, lr: float = 1e-3,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, dp: str = "dp",
                    sp: str = "sp", accum_steps: int = 1, with_grad_norm: bool = False,
                    counter=None, guard=None, fused: bool = True, donate: bool = True,
                    overlap_blocks: int = 0):
    """The ZeRO training step over ``mesh``: fn(params, opt, x, y) ->
    (params, opt, loss), ``opt`` from :func:`init_zero_adam_state` (split by
    :func:`zero_state_spec`), x and y ``(batch, seq, d)`` split P(dp, sp), or
    ``(k, batch, seq, d)`` split P(None, dp, sp) with ``accum_steps=k``.
    ``with_grad_norm`` appends the grad-norm scalar; ``overlap_blocks=k``
    selects the block schedule (see :func:`train_step_zero_fn`).

    ``donate=True`` (default, as in the JAX package) gives the optimizer
    state to the step: the fused kernel writes the flat moment shards in
    place where each rank's shard is its own memory (``|sp| = 1``; with
    ``|sp| > 1`` the sp copies share one buffer and the step writes new
    tensors), so the returned ``mu_flat``/``nu_flat`` are the passed ones
    and per-rank optimizer bytes stay one shard. Do not reuse a donated
    state. ``counter`` and ``guard`` are not ported (ROADMAP A10)."""
    _no_levers(guard, counter)
    _validate_step_config(mesh, cfg, dp, sp)
    pspec = param_spec(cfg, dp)
    ospec = zero_state_spec(cfg, dp)
    dspec = P(dp, sp) if accum_steps == 1 else P(None, dp, sp)
    body = train_step_zero_fn(cfg, lr, b1, b2, eps, sp=sp, dp=dp, accum_steps=accum_steps,
                              with_grad_norm=with_grad_norm, fused=fused,
                              overlap_blocks=overlap_blocks, donate=donate)
    out = (pspec, ospec, P(), P()) if with_grad_norm else (pspec, ospec, P())
    return run_spmd(mesh, body, (pspec, ospec, dspec, dspec), out)
