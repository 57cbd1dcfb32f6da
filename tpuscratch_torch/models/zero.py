"""ZeRO-sharded training step: reduce-scatter grad sync, dp-sharded fused
Adam, deferred-sync gradient accumulation.

The twin of ``tpuscratch.models.zero``. The replicated step
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

The plan step (``train_step_plan``) composes the pipelined loss of
``transformer._pp_loss_fn`` (dp x sp x pp) with either dp-sharded ZeRO
moments, each (stage, dp) rank holding its shard of its stage's flat vector
(``init_plan_zero_state``), or the stacked replicated Adam moments; the
overlap schedule comes from the ``ShardingPlan``.

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
    _adam_update,
    _is_expert_leaf,
    _jax_paths,
    _map,
    _no_levers,
    _pp_loss_and_grads,
    _pp_loss_fn,
    _validate_pp,
    _validate_step_config,
    _value_and_grad,
    _value_and_grad_of,
    adam_alpha,
    adam_state_spec_pp,
    expert_leaves,
    nonexpert_size,
    pack_nonexpert,
    param_spec,
    param_spec_pp,
    params_from_numpy,
    unpack_nonexpert,
)
from tpuscratch_torch.ops.adam import fused_adam_tree, writable_rows
from tpuscratch_torch.runtime.errors import CommError
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device

__all__ = [
    "init_plan_zero_state",
    "init_zero_adam_state",
    "local_zero_state",
    "plan_zero_state_spec",
    "put_plan_state",
    "reshard_state",
    "train_step_plan",
    "train_step_plan_fn",
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


# ---- the plan step: dp x sp x pp GPipe loss + dp-sharded ZeRO moments ----------------


def init_plan_zero_state(stacked, plan) -> dict:
    """Fresh ZeRO Adam state for a pipelined plan's stacked params
    (``transformer.stack_layers``): ``mu_flat``/``nu_flat`` ``(|pp| *
    flat_stage,)`` f32 vectors, spec ``P((pp, dp))``, each (stage, dp) rank
    holding its 1/|dp| shard of its stage's packed non-expert vector;
    ``mu_exp``/``nu_exp`` the stacked expert-leaf moments (split ``P(pp,
    ep)`` with their leaves); ``t`` the step count. With ``|pp| = 1`` this is
    :func:`init_zero_adam_state` of the stacked tree."""
    n_pp, n_dp = plan.pp_size, plan.dp_size
    flat = zero_flat_size(nonexpert_size(stacked) // n_pp, n_dp)
    exp = expert_leaves(stacked)
    dev = _jax_paths(stacked)[0][1].device
    return {
        "mu_flat": torch.zeros(n_pp * flat, dtype=torch.float32, device=dev),
        "nu_flat": torch.zeros(n_pp * flat, dtype=torch.float32, device=dev),
        "mu_exp": [torch.zeros_like(x) for x in exp],
        "nu_exp": [torch.zeros_like(x) for x in exp],
        "t": torch.zeros((), dtype=torch.int32, device=dev),
    }


def plan_zero_state_spec(cfg: TransformerConfig, plan) -> dict:
    """PartitionSpec tree for :func:`init_plan_zero_state`'s output, built
    through the plan's logical-axis resolver."""
    n_exp = sum(1 for name in LAYER_LEAVES if name in EXPERT_LEAVES)
    flat = plan.spec(("pp", "dp"))
    exp = [plan.spec("pp", "ep")] * n_exp
    return {"mu_flat": flat, "nu_flat": flat, "mu_exp": exp, "nu_exp": list(exp), "t": P()}


def put_plan_state(state, plan, cfg: TransformerConfig) -> dict:
    """A plan-ZeRO state (numpy arrays, e.g. the JAX package's, or tensors on
    the CPU) on the plan's device, bit for bit, in the layout
    :func:`plan_zero_state_spec` gives: every dim a spec names must split
    evenly over its axes, or this raises. ``t`` becomes a 0-dim int32."""
    mesh = plan.mesh
    spec = plan_zero_state_spec(cfg, plan)

    def put(x, s):
        t = (x.detach().to(mesh.device, copy=True) if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x, copy=True)).to(mesh.device))
        for i, entry in enumerate(s):
            n = axis_size(entry, mesh) if entry is not None else 1
            if t.ndim <= i or t.shape[i] % n:
                raise ValueError(f"a plan state leaf {tuple(t.shape)} does not split as "
                                 f"{s} over the mesh {mesh.shape}")
        return t

    out = {k: put(state[k], spec[k]) for k in ("mu_flat", "nu_flat")}
    for k in ("mu_exp", "nu_exp"):
        out[k] = [put(x, s) for x, s in zip(state[k], spec[k], strict=True)]
    out["t"] = torch.tensor(int(state["t"]), dtype=torch.int32, device=mesh.device)
    return out


def _pp_grad_norm(grads, dp: str, stage: str) -> torch.Tensor:
    """Global L2 norm ``(*mesh)`` of the reduced gradient under the stacked
    (non-ZeRO) pp layout: every leaf is stage-split (different layers a
    stage), so local square sums are summed over the stage axis; expert
    leaves also over dp (different experts a rank). Leaves in the JAX
    package's flatten order."""
    total = 0.0
    for path, g in _jax_paths(grads):
        axes = (dp, stage) if _is_expert_leaf(path) else (stage,)
        total = total + allreduce_sum(_local_sum(g), axes)
    return torch.sqrt(total)


def train_step_plan_fn(cfg: TransformerConfig, n_micro: int = 2, lr: float = 1e-3,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, sp: str = "sp",
                       dp: str = "dp", stage: str = "pp", zero: bool = True,
                       overlap_blocks: int = 0, with_grad_norm: bool = False, guard=None,
                       fused: bool = True, donate: bool = False):
    """The 3-axis ``run_spmd`` body a ShardingPlan selects: (stacked, opt, x,
    y) -> (stacked, opt, loss) (+ grad_norm with ``with_grad_norm``), the
    GPipe loss of ``transformer._pp_loss_fn`` composed with either

    - ``zero=True``: dp-sharded ZeRO moments. Each (stage, dp) rank packs its
      stage's non-expert gradients flat, reduce-scatters over dp, sums over
      the sp copies, divides by ``|dp|*|sp|*|pp|``, runs the fused Adam
      update on its shard and all-gathers within its stage (every stage's
      chain in the same calls). ``overlap_blocks=k`` cuts each into k block
      chains: the same wire bytes, bit-identical results;
    - ``zero=False``: the stacked Adam moments (``adam_state_spec_pp``) and
      ``_grad_reduce`` then ÷|pp|.

    ``donate`` (with ``zero``) lets the fused update write the flat moments
    in place where each rank's shard is its own memory."""
    _no_levers(guard, None)
    loss_fn = _pp_loss_fn(cfg, n_micro, sp, dp, stage)

    def core(params, x, y):
        if not zero:
            return _pp_loss_and_grads(loss_fn, params, x, y, dp, sp, stage)
        lead = len(current_mesh().shape)
        n_dp = axis_size(dp)
        n = n_dp * axis_size(sp) * axis_size(stage)
        loss, grads = _value_and_grad_of(loss_fn, params, x, y)
        flat_size = zero_flat_size(nonexpert_size(params, lead), n_dp)
        blocks = _overlap_blocks(overlap_blocks, flat_size // n_dp)
        g_shard, g_exp = _zero_grad_sync(grads, n, dp, sp, flat_size, blocks)
        return loss, (g_shard, g_exp, flat_size)

    def step(params, opt, x, y):
        loss, payload = core(params, x, y)
        if zero:
            g_shard, g_exp, flat_size = payload
            new_params, new_opt = _zero_apply_update(params, opt, g_shard, g_exp, flat_size, lr,
                                                     b1, b2, eps, dp, fused, donate)
        else:
            new_params, new_opt = _adam_update(params, opt, payload, lr, b1, b2, eps)
        if not with_grad_norm:
            return new_params, new_opt, loss
        gnorm = (_zero_grad_norm(g_shard, g_exp, (dp, stage)) if zero
                 else _pp_grad_norm(payload, dp, stage))
        return new_params, new_opt, loss, gnorm

    return step


def train_step_plan(plan, cfg: TransformerConfig, lr: float = 1e-3, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8, zero: bool = True,
                    with_grad_norm: bool = False, counter=None, guard=None, fused: bool = True,
                    donate: bool = True):
    """The plan-composed training step over ``plan.mesh``: fn(stacked, opt,
    x, y) -> (stacked, opt, loss), the ``transformer.stack_layers`` layout
    split by ``param_spec_pp`` over the plan's pp/ep axes, ``opt`` from
    :func:`init_plan_zero_state` (``zero=True``; with ``donate`` the step
    writes its flat moments in place where it can, see
    :func:`train_step_zero`, so do not reuse a donated state) or
    ``init_adam_state`` of the stacked tree (``zero=False``). In place
    means where one stride walks every rank's flat shard: the ``(pp, dp)``
    layout of a plan with both axes past 1 takes two, and its step writes
    new tensors. The overlap schedule comes from the plan
    (``plan.overlap_blocks``). ``counter`` and ``guard`` are not ported
    (ROADMAP A10)."""
    mesh, dp, sp, stage = plan.mesh, plan.dp, plan.sp, plan.pp
    if stage is None:
        raise ValueError("train_step_plan needs a pipelined plan (pp=<axis name>); a dp x sp "
                         "plan trains through train_step_adam / train_step_zero")
    if plan.ep_axis != plan.dp:
        raise NotImplementedError("expert parallelism rides the dp axis (EP groups == DP "
                                  "groups); a distinct ep mesh axis is not supported")
    _no_levers(guard, counter)
    _validate_pp(mesh, cfg, dp, sp, stage)
    pspec = param_spec_pp(cfg, stage, dp)
    ospec = plan_zero_state_spec(cfg, plan) if zero else adam_state_spec_pp(cfg, stage, dp)
    dspec = plan.data_spec()
    body = train_step_plan_fn(cfg, plan.n_micro, lr, b1, b2, eps, sp=sp, dp=dp, stage=stage,
                              zero=zero, overlap_blocks=plan.overlap_blocks,
                              with_grad_norm=with_grad_norm, fused=fused, donate=donate)
    out = (pspec, ospec, P(), P()) if with_grad_norm else (pspec, ospec, P())
    return run_spmd(mesh, body, (pspec, ospec, dspec, dspec), out)
