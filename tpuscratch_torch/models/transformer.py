"""The mini MoE transformer: configuration, parameters, forward and training.

The twin of ``tpuscratch.models.transformer`` (its pipeline steps wait for
ROADMAP A13d, ZeRO for A13c). ``init_params`` makes the same numpy draws,
so a seed gives the same arrays as the JAX package; ``params_from_numpy``
and ``adam_state_from_numpy`` carry trees made elsewhere (the JAX
package's, as numpy arrays) onto a device.

One training step over a 2D stacked mesh ("dp", "sp"): batch split over
"dp", sequence over "sp"; attention is ring attention over "sp" (dense
"xla" hops or the flash kernels, "pallas") or Ulysses over "sp" with the
flash kernels ("ulysses-pallas"); the MoE FFN is expert-parallel over
"dp"; the loss is the mean over both axes. Inside ``run_spmd`` every
tensor is stacked ``(*mesh, ...)``: the step differentiates the stacked
loss with torch's autograd (the collectives are differentiable torch
ops), then ``_grad_reduce`` totals each leaf's per-copy gradients into the
logical one. A step returns new parameters (and optimizer state); nothing
is updated in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_sum
from tpuscratch_torch.comm.spmd import P, axis_size, current_mesh, run_spmd
from tpuscratch_torch.parallel.expert import expert_parallel_ffn
from tpuscratch_torch.parallel.ring_attention import ring_attention
from tpuscratch_torch.parallel.ulysses import ulysses_attention
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 32
    n_heads: int = 2
    n_experts: int = 4          # total; must divide by the dp axis size
    d_ff: int = 64
    n_layers: int = 1
    causal: bool = True
    capacity_factor: float = 2.0
    aux_coef: float = 0.01
    # 'xla': ring attention, dense hop blocks; 'pallas': ring attention,
    # flash-kernel hops (ring backward: a second KV rotation); 'ulysses-pallas':
    # Ulysses all_to_all + the differentiable flash kernels (n_heads % sp == 0)
    attn_impl: str = "xla"
    # forward/backward arithmetic dtype; master params, the loss and the
    # update stay float32 (the cast sits inside the loss)
    compute_dtype: str = "float32"

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads


EXPERT_LEAVES = ("w_in", "w_out")  # the leaves split over "dp"
#: every per-layer parameter name
LAYER_LEAVES = ("wq", "wk", "wv", "wo", "ln1", "ln2", "gate", "w_in", "w_out")


def params_from_numpy(tree, device=None):
    """A parameter tree (nested dicts and lists of arrays, e.g. the JAX
    package's ``init_params`` through ``np.asarray``) as torch tensors on
    ``device`` (the card unless the caller asks for the CPU), bit for bit."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)


def _init_numpy(seed: int, cfg: TransformerConfig) -> dict:
    # the JAX package's draws, in its order and arithmetic: a float32 draw
    # times a numpy float64 scale is float64, rounded to float32 once
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return np.asarray(rng.standard_normal(shape).astype(np.float32) * scale, np.float32)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense(d, d),
            "wk": dense(d, d),
            "wv": dense(d, d),
            "wo": dense(d, d),
            "ln1": np.ones((d,), np.float32),
            "ln2": np.ones((d,), np.float32),
            "gate": dense(d, e, scale=0.02),
            "w_in": dense(e, d, f, scale=1.0 / np.sqrt(d)),
            "w_out": dense(e, f, d, scale=1.0 / np.sqrt(f)),
        })
    return {"layers": layers}


def init_params(seed: int, cfg: TransformerConfig, device=None) -> dict:
    """Parameter tree for ``cfg`` on ``device``; expert leaves have a
    leading ``(n_experts,)`` axis, the dim split over "dp"."""
    return params_from_numpy(_init_numpy(seed, cfg), device)


def param_spec(cfg: TransformerConfig, dp: str = "dp") -> dict:
    """PartitionSpec tree: expert leaves split over ``dp`` on their expert
    axis, everything else replicated."""
    layer = {name: P(dp) if name in EXPERT_LEAVES else P() for name in LAYER_LEAVES}
    return {"layers": [dict(layer) for _ in range(cfg.n_layers)]}


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def adam_state_from_numpy(opt, device=None) -> dict:
    """An Adam state tree ``{"mu", "nu", "t"}`` (the JAX package's
    ``init_adam_state`` output, as numpy arrays) on ``device``, bit for bit;
    ``t`` becomes a 0-dim int32 tensor."""
    out = params_from_numpy({"mu": opt["mu"], "nu": opt["nu"]}, device)
    out["t"] = torch.tensor(int(np.asarray(opt["t"])), dtype=torch.int32,
                            device=resolve_device(device))
    return out


# ---- trees ---------------------------------------------------------------------------


def _is_expert_leaf(path) -> bool:
    return any(k in EXPERT_LEAVES for k in path)


def _map(f, tree, *rest, path=()):
    """``f(path, leaf, *rest_leaves)`` over nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(f, tree[k], *(r[k] for r in rest), path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(f, t, *(r[i] for r in rest), path=path + (i,))
                          for i, t in enumerate(tree))
    return f(path, tree, *rest)


def _paths(tree) -> list:
    """(path, leaf) pairs in flatten order."""
    out = []
    _map(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def _leaves(tree) -> list:
    return [leaf for _, leaf in _paths(tree)]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _map(lambda _p, _leaf: next(it), tree)


# ---- forward -------------------------------------------------------------------------


def _nmesh() -> int:
    return len(current_mesh().shape)


def _lead(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """A stacked weight ``(*mesh, ...)`` with unit dims after the mesh dims,
    so it broadcasts against a stacked ``ndim``-dim operand."""
    m = _nmesh()
    return w[(slice(None),) * m + (None,) * (ndim - w.ndim)]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` per rank: x ``(*mesh, ..., a)``, w ``(*mesh, a, b)``."""
    return x @ _lead(w, x.ndim)


def _block(p, x, cfg: TransformerConfig, sp: str, dp: str):
    """One attention + MoE block on a stacked local ``(*mesh, B, S, d)``
    shard. Returns (new_x, aux_loss ``(*mesh)``)."""
    H, Dh = cfg.n_heads, cfg.d_head
    h = _rms_norm(x, _lead(p["ln1"], x.ndim))
    q = _mm(h, p["wq"]).unflatten(-1, (H, Dh))
    k = _mm(h, p["wk"]).unflatten(-1, (H, Dh))
    v = _mm(h, p["wv"]).unflatten(-1, (H, Dh))
    if cfg.attn_impl == "ulysses-pallas":
        attn = ulysses_attention(q, k, v, sp, causal=cfg.causal, impl="pallas")
    else:
        attn = ring_attention(q, k, v, sp, causal=cfg.causal, impl=cfg.attn_impl)
    x = x + _mm(attn.flatten(-2), p["wo"])
    h = _rms_norm(x, _lead(p["ln2"], x.ndim))
    tokens = h.reshape(*h.shape[:-3], -1, h.shape[-1])
    moe, aux = expert_parallel_ffn(tokens, p["gate"], p["w_in"], p["w_out"], dp,
                                   capacity_factor=cfg.capacity_factor)
    return x + moe.reshape(x.shape), aux


def model_apply(params, x, cfg: TransformerConfig, sp: str = "sp", dp: str = "dp"):
    """Forward over a stacked local shard: x ``(*mesh, B, S, d)`` -> (out,
    aux ``(*mesh)``). Call inside ``run_spmd``."""
    aux_total = torch.zeros(current_mesh().shape, dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        x, aux = _block(p, x, cfg, sp, dp)
        aux_total = aux_total + aux
    return x, aux_total


def _pmean(x: torch.Tensor, axes) -> torch.Tensor:
    return allreduce_sum(x, axes) / axis_size(axes)


def _loss(params, x, y, cfg: TransformerConfig, sp: str, dp: str) -> torch.Tensor:
    """The global objective on every rank ``(*mesh)``: the MSE of the output
    against y plus ``aux_coef`` times the MoE load-balance loss, in f32
    whatever the compute dtype (params and x are cast to it here)."""
    cd = getattr(torch, cfg.compute_dtype)
    if cd != torch.float32:
        params = _map(lambda _p, w: w.to(cd), params)
        x = x.to(cd)
    out, aux = model_apply(params, x, cfg, sp, dp)
    m = _nmesh()
    mse = torch.mean(torch.square(out.float() - y.float()), dim=tuple(range(m, out.ndim)))
    return _pmean(mse + cfg.aux_coef * aux.float(), (dp, sp))


def _value_and_grad(params, x, y, cfg: TransformerConfig, sp: str, dp: str):
    """(loss ``(*mesh)``, per-copy gradients): every rank seeds its own copy
    of the loss with 1, as each JAX rank does under shard_map, and autograd
    routes the cross-rank terms back through the collectives."""
    leaves = [w.detach().requires_grad_() for w in _leaves(params)]
    with torch.enable_grad():
        loss = _loss(_unflatten(params, leaves), x, y, cfg, sp, dp)
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), _unflatten(params, grads)


def _grad_reduce(grads, dp: str, sp: str):
    """The logical gradient from the per-copy ones. Each of the n = |dp|*|sp|
    ranks seeded its own copy of the mean loss, so a leaf's gradients summed
    over the axes it is copied across count every seed once per copy set:
    n times the logical gradient. Expert leaves are copied across "sp" only
    (across "dp" they are different experts), the rest across both."""
    n = axis_size((dp, sp))

    def reduce_leaf(path, g):
        axes = (sp,) if _is_expert_leaf(path) else (dp, sp)
        return allreduce_sum(g, axes) / n

    return _map(reduce_leaf, grads)


def _grad_norm(grads, dp: str) -> torch.Tensor:
    """Global L2 norm ``(*mesh)`` of the reduced (logical) gradient: expert
    leaves are dp-split, so their square sums are summed over dp."""
    m = _nmesh()
    total = 0.0
    for path, g in _paths(grads):
        sq = torch.sum(torch.square(g.float()), dim=tuple(range(m, g.ndim)))
        total = total + (allreduce_sum(sq, dp) if _is_expert_leaf(path) else sq)
    return torch.sqrt(total)


def _no_levers(guard, counter) -> None:
    for name, value in (("guard", guard), ("counter", counter)):
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported to tpuscratch_torch yet (ROADMAP A10); the step "
                f"runs with {name}=None")


def train_step_fn(cfg: TransformerConfig, lr: float = 1e-2, sp: str = "sp", dp: str = "dp",
                  with_grad_norm: bool = False, guard=None):
    """The ``run_spmd`` body: (params, x, y) -> (new_params, loss), or
    (new_params, loss, grad_norm) with ``with_grad_norm``. SGD."""
    _no_levers(guard, None)

    def step(params, x, y):
        loss, grads = _value_and_grad(params, x, y, cfg, sp, dp)
        grads = _grad_reduce(grads, dp, sp)
        new_params = _map(lambda _p, w, g: w - lr * g, params, grads)
        if with_grad_norm:
            return new_params, loss, _grad_norm(grads, dp)
        return new_params, loss

    return step


def _validate_step_config(mesh: StackedMesh, cfg: TransformerConfig, dp: str, sp: str) -> None:
    n_dp = mesh.shape[mesh.axis_names.index(dp)]
    n_sp = mesh.shape[mesh.axis_names.index(sp)]
    if cfg.n_experts % n_dp:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by dp size {n_dp}")
    if cfg.attn_impl not in ("xla", "pallas", "ulysses-pallas"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}: "
                         "'xla' | 'pallas' | 'ulysses-pallas'")
    if cfg.attn_impl == "ulysses-pallas" and cfg.n_heads % n_sp:
        raise ValueError(f"ulysses-pallas needs n_heads {cfg.n_heads} divisible by "
                         f"sp size {n_sp}")


def train_step(mesh: StackedMesh, cfg: TransformerConfig, lr: float = 1e-2, dp: str = "dp",
               sp: str = "sp", with_grad_norm: bool = False, counter=None, guard=None):
    """The training step over ``mesh`` (axes ``dp`` x ``sp``): fn(params, x,
    y) -> (new_params, loss), x and y ``(batch, seq, d_model)`` split
    P(dp, sp), params laid out by ``param_spec``; ``with_grad_norm``
    appends the grad-norm scalar. ``counter`` and ``guard`` are not ported
    (ROADMAP A10)."""
    _no_levers(guard, counter)
    _validate_step_config(mesh, cfg, dp, sp)
    pspec = param_spec(cfg, dp)
    body = train_step_fn(cfg, lr, sp=sp, dp=dp, with_grad_norm=with_grad_norm)
    out = (pspec, P(), P()) if with_grad_norm else (pspec, P())
    return run_spmd(mesh, body, (pspec, P(dp, sp), P(dp, sp)), out)


# ---- Adam ----------------------------------------------------------------------------


def init_adam_state(params) -> dict:
    """Fresh Adam moments laid out like the params (expert-leaf moments
    carry the expert axis and split over dp with their leaves) and the
    step count ``t`` (0-dim int32)."""
    leaf = _leaves(params)[0]
    return {"mu": _map(lambda _p, w: torch.zeros_like(w), params),
            "nu": _map(lambda _p, w: torch.zeros_like(w), params),
            "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adam_state_spec(cfg: TransformerConfig, dp: str = "dp") -> dict:
    """PartitionSpec tree for :func:`init_adam_state`'s output."""
    return {"mu": param_spec(cfg, dp), "nu": param_spec(cfg, dp), "t": P()}


def adam_alpha(t: torch.Tensor, lr: float, b1: float, b2: float) -> torch.Tensor:
    """Bias-corrected Adam step size at (1-based) step ``t``, f32."""
    tf = t.to(torch.float32)
    return lr * torch.sqrt(1.0 - b2 ** tf) / (1.0 - b1 ** tf)


def _adam_apply(params, mu, nu, grads, alpha, b1: float, b2: float, eps: float):
    """One elementwise Adam application with the bias-corrected step size
    ``alpha`` (stacked, ``(*mesh)``): (new_params, new_mu, new_nu), new
    tensors."""
    mu = _map(lambda _p, m, g: b1 * m + (1.0 - b1) * g, mu, grads)
    nu = _map(lambda _p, v, g: b2 * v + (1.0 - b2) * g * g, nu, grads)
    new_params = _map(lambda _p, w, m, v: w - _lead(alpha, w.ndim) * m / (torch.sqrt(v) + eps),
                      params, mu, nu)
    return new_params, mu, nu


def _adam_update(params, opt, grads, lr: float, b1: float, b2: float, eps: float):
    """The shared Adam math: (new_params, new_opt)."""
    t = opt["t"] + 1
    new_params, mu, nu = _adam_apply(params, opt["mu"], opt["nu"], grads,
                                     adam_alpha(t, lr, b1, b2), b1, b2, eps)
    return new_params, {"mu": mu, "nu": nu, "t": t}


def train_step_adam_fn(cfg: TransformerConfig, lr: float = 1e-3, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8, sp: str = "sp", dp: str = "dp",
                       with_grad_norm: bool = False, guard=None):
    """The ``run_spmd`` body: (params, opt, x, y) -> (params, opt, loss)
    (+ grad_norm with ``with_grad_norm``)."""
    _no_levers(guard, None)

    def step(params, opt, x, y):
        loss, grads = _value_and_grad(params, x, y, cfg, sp, dp)
        grads = _grad_reduce(grads, dp, sp)
        new_params, new_opt = _adam_update(params, opt, grads, lr, b1, b2, eps)
        if with_grad_norm:
            return new_params, new_opt, loss, _grad_norm(grads, dp)
        return new_params, new_opt, loss

    return step


def train_step_adam(mesh: StackedMesh, cfg: TransformerConfig, lr: float = 1e-3,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, dp: str = "dp",
                    sp: str = "sp", with_grad_norm: bool = False, counter=None, guard=None):
    """:func:`train_step` with Adam: fn(params, opt_state, x, y) -> (params,
    opt_state, loss); ``opt_state`` from :func:`init_adam_state`, moments
    split like their params."""
    _no_levers(guard, counter)
    _validate_step_config(mesh, cfg, dp, sp)
    pspec, ospec = param_spec(cfg, dp), adam_state_spec(cfg, dp)
    body = train_step_adam_fn(cfg, lr, b1, b2, eps, sp=sp, dp=dp, with_grad_norm=with_grad_norm)
    out = (pspec, ospec, P(), P()) if with_grad_norm else (pspec, ospec, P())
    return run_spmd(mesh, body, (pspec, ospec, P(dp, sp), P(dp, sp)), out)
