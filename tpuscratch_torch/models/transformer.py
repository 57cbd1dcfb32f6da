"""The mini MoE transformer: configuration, parameters, forward and training.

The twin of ``tpuscratch.models.transformer`` (the ZeRO steps are
``models.zero``). ``init_params`` makes the same numpy draws, so a seed
gives the same arrays as the JAX package; ``params_from_numpy`` and
``adam_state_from_numpy`` carry trees made elsewhere (the JAX package's, as
numpy arrays) onto a device.

One training step over a 2D stacked mesh ("dp", "sp"): batch split over
"dp", sequence over "sp"; attention is ring attention over "sp" (dense
"xla" hops or the flash kernels, "pallas") or Ulysses over "sp" with the
flash kernels ("ulysses-pallas"); the MoE FFN is expert-parallel over
"dp"; the loss is the mean over both axes. Inside ``run_spmd`` every
tensor is stacked ``(*mesh, ...)``: the step differentiates the stacked
loss with torch's autograd (the collectives are differentiable torch
ops), then ``_grad_reduce`` totals each leaf's per-copy gradients into the
logical one. A step returns new parameters (and optimizer state); nothing
is updated in place. ``guard=`` folds the device-side health guard of
``ft.guards`` into a step (its status stays on the device), and
``counter=`` (an ``obs.CompileCounter``) counts the step's builds.

The pipelined steps (``train_step_pp``, ``train_step_pp_adam``) add a third
axis, "stage": the layers are stacked (``stack_layers``) and split over it,
and the local batch streams through the GPipe schedule
(``parallel.pipeline.gpipe_scan``) in ``n_micro`` microbatches.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from tpuscratch_torch.comm.collectives import allreduce_min, allreduce_sum
from tpuscratch_torch.comm.spmd import P, axis_size, current_mesh, run_spmd
from tpuscratch_torch.parallel.expert import expert_parallel_ffn
from tpuscratch_torch.parallel.pipeline import gpipe_scan
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


@functools.lru_cache(maxsize=2)
def _init_numpy(seed: int, cfg: TransformerConfig) -> dict:
    # kept for the next call with the same (seed, cfg): a benchmark builds
    # one model many times, and the draws cost seconds on the host; only
    # init_params reads this, through params_from_numpy's copies.
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


def _jax_paths(tree, path=()) -> list:
    """(path, leaf) pairs in the JAX package's tree-flatten order: dict keys
    sorted, lists in order (the order its ZeRO flat vector is packed in,
    whatever order a torch dict was built in)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _jax_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in _jax_paths(t, path + (i,))]
    return [(path, tree)]


def nonexpert_size(tree, lead: int = 0) -> int:
    """Element count of the non-expert (replicated) leaves, each counted
    from dim ``lead`` on (``lead`` = the mesh dims of stacked leaves): the
    population the ZeRO path packs into one dp-sharded vector."""
    return sum(math.prod(leaf.shape[lead:]) for path, leaf in _jax_paths(tree)
               if not _is_expert_leaf(path))


def expert_leaves(tree) -> list:
    """The expert leaves in the JAX package's tree-flatten order (the order
    :func:`pack_nonexpert` and :func:`unpack_nonexpert` also walk)."""
    return [leaf for path, leaf in _jax_paths(tree) if _is_expert_leaf(path)]


def pack_nonexpert(tree, pad_to: int | None = None, lead: int = 0) -> torch.Tensor:
    """Every non-expert leaf flattened from dim ``lead`` on and joined, in
    the JAX package's tree-flatten order, into one ``(*lead_dims, n)``
    vector, zero-padded to ``pad_to`` elements: the layout the ZeRO path
    reduce-scatters over "dp" and the fused update runs on in shards. Zero
    padding is exact: padded slots carry zero gradients and moments."""
    flats = [leaf.flatten(lead) for path, leaf in _jax_paths(tree) if not _is_expert_leaf(path)]
    flat = torch.cat(flats, dim=-1)
    if pad_to is not None:
        if pad_to < flat.shape[-1]:
            raise ValueError(f"pad_to {pad_to} smaller than packed size {flat.shape[-1]}")
        flat = torch.nn.functional.pad(flat, (0, pad_to - flat.shape[-1]))
    return flat


def unpack_nonexpert(flat: torch.Tensor, experts: list, like, lead: int = 0):
    """The inverse of :func:`pack_nonexpert` and :func:`expert_leaves`: a
    tree shaped like ``like``, its non-expert leaves views of ``flat``'s
    last dim (the padding ignored), its expert leaves ``experts`` in order."""
    offset = 0
    exp_iter = iter(experts)
    parts = {}
    for path, leaf in _jax_paths(like):
        if _is_expert_leaf(path):
            parts[path] = next(exp_iter)
            continue
        local = leaf.shape[lead:]
        n = math.prod(local)
        parts[path] = flat[..., offset:offset + n].reshape(*flat.shape[:-1], *local)
        offset += n
    rest = list(exp_iter)
    if rest:
        raise ValueError(f"{len(rest)} expert leaves left over in unpack")
    return _map(lambda path, _leaf: parts[path], like)


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


def _value_and_grad_of(loss_fn, params, x, y):
    """(loss ``(*mesh)``, per-copy gradients) of ``loss_fn(params, x, y)``:
    every rank seeds its own copy of the loss with 1, as each JAX rank does
    under shard_map, and autograd routes the cross-rank terms back through
    the collectives."""
    leaves = [w.detach().requires_grad_() for w in _leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, leaves), x, y)
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), _unflatten(params, grads)


def _value_and_grad(params, x, y, cfg: TransformerConfig, sp: str, dp: str):
    """:func:`_value_and_grad_of` of the dp x sp loss."""
    return _value_and_grad_of(lambda p, xs, ys: _loss(p, xs, ys, cfg, sp, dp), params, x, y)


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


def _apply_guard(loss, gnorm, grads, ref_loss, clip_norm: float, spike_factor: float,
                 dp: str, sp: str, extra_axes: tuple = ()):
    """Device-side health guard (the device half of ``ft.guards``), on
    stacked ``(*mesh)`` values:

    - finiteness: each rank's ``isfinite(loss) & isfinite(gnorm)`` (a
      NaN/Inf in any gradient leaf reaches the global norm) reduced with
      a min over every mesh axis, so all ranks agree and the skip-select
      below cannot diverge the replicas;
    - loss spike: ``loss > spike_factor * ref_loss`` against the
      caller-fed reference loss (the previous chunk's; a non-finite or
      non-positive reference disables the check — the first chunk);
    - clip: gradients above ``clip_norm`` are rescaled on the device.

    Returns ``(ok, status, grads)``: ``ok`` ``(*mesh)`` gates the update
    (a skipped step passes params through unchanged), ``status`` is the
    int32 status (0 ok / 1 clipped / 2 skipped). ``extra_axes`` extends
    the agreement to further mesh axes (the pipeline plan's stage axis).
    ``grads`` is any tree whose leaves lead with the mesh dims."""
    finite = torch.isfinite(loss) & torch.isfinite(gnorm)
    finite = allreduce_min(finite.to(torch.int32), (dp, sp) + tuple(extra_axes)) > 0
    spiked = (torch.isfinite(ref_loss) & (ref_loss > 0)
              & (loss > torch.full_like(ref_loss, spike_factor) * ref_loss))
    ok = finite & ~spiked
    clip = finite & (gnorm > clip_norm)
    scale = torch.where(clip, torch.full_like(gnorm, clip_norm) / torch.clamp_min(gnorm, 1e-30),
                        torch.ones_like(gnorm))
    grads = _map(lambda _p, g: g * _under(scale, g.ndim), grads)
    status = torch.where(ok, clip.to(torch.int32), torch.full_like(clip, 2, dtype=torch.int32))
    return ok, status, grads


def _select(ok: torch.Tensor, new, cur):
    """``new`` where the guard let the step through, else ``cur``, leaf by
    leaf (``ok`` leads every leaf)."""
    return _map(lambda _p, a, b: torch.where(_under(ok, a.ndim), a, b), new, cur)


def _built(counter, build):
    """The step body ``build()`` makes. With a ``counter`` (an
    ``obs.CompileCounter``) the build counts one: a step function is built
    once and reused for every call, the JAX package's one trace a compile."""
    return counter.wrap(build)() if counter is not None else build()


def train_step_fn(cfg: TransformerConfig, lr: float = 1e-2, sp: str = "sp", dp: str = "dp",
                  with_grad_norm: bool = False, guard: tuple | None = None):
    """The ``run_spmd`` body: (params, x, y) -> (new_params, loss), or
    (new_params, loss, grad_norm) with ``with_grad_norm``. SGD.

    ``guard=(clip_norm, spike_factor)`` folds the device-side health guard
    in (:func:`_apply_guard`): the body becomes (params, x, y, ref_loss) ->
    (new_params, loss, grad_norm, status), a skipped step passing params
    through unchanged."""
    def step(params, x, y, ref_loss=None):
        loss, grads = _value_and_grad(params, x, y, cfg, sp, dp)
        grads = _grad_reduce(grads, dp, sp)
        gnorm = _grad_norm(grads, dp) if with_grad_norm or guard is not None else None
        if guard is not None:
            ok, status, grads = _apply_guard(loss, gnorm, grads, ref_loss, *guard, dp, sp)
        new_params = _map(lambda _p, w, g: w - lr * g, params, grads)
        if guard is not None:
            return _select(ok, new_params, params), loss, gnorm, status
        return (new_params, loss, gnorm) if with_grad_norm else (new_params, loss)

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
    appends the grad-norm scalar. ``counter`` (an ``obs.CompileCounter``)
    counts this build of the step body. ``guard=(clip_norm,
    spike_factor)`` builds the guarded variant: fn(params, x, y, ref_loss)
    -> (new_params, loss, grad_norm, status), ``ref_loss`` a 0-dim f32
    tensor on the mesh's device and ``status`` a 0-dim int32 one, left on
    the device for the caller to read when it chooses."""
    _validate_step_config(mesh, cfg, dp, sp)
    pspec = param_spec(cfg, dp)
    body = _built(counter, lambda: train_step_fn(cfg, lr, sp=sp, dp=dp,
                                                 with_grad_norm=with_grad_norm, guard=guard))
    if guard is not None:
        return run_spmd(mesh, body, (pspec, P(dp, sp), P(dp, sp), P()), (pspec, P(), P(), P()))
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


def _under(alpha: torch.Tensor, ndim: int) -> torch.Tensor:
    """``alpha`` with unit dims appended up to ``ndim`` dims, so that one
    value per leading index broadcasts over the rest."""
    return alpha.reshape(*alpha.shape, *(1,) * (ndim - alpha.ndim))


def _adam_apply(params, mu, nu, grads, alpha, b1: float, b2: float, eps: float):
    """One elementwise Adam application with the bias-corrected step size
    ``alpha`` (a tensor whose shape leads every leaf's: ``(*mesh)`` inside
    ``run_spmd``, 0-dim outside): (new_params, new_mu, new_nu), new
    tensors."""
    mu = _map(lambda _p, m, g: b1 * m + (1.0 - b1) * g, mu, grads)
    nu = _map(lambda _p, v, g: b2 * v + (1.0 - b2) * g * g, nu, grads)
    new_params = _map(lambda _p, w, m, v: w - _under(alpha, w.ndim) * m / (torch.sqrt(v) + eps),
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
                       with_grad_norm: bool = False, guard: tuple | None = None):
    """The ``run_spmd`` body: (params, opt, x, y) -> (params, opt, loss)
    (+ grad_norm with ``with_grad_norm``).

    ``guard=(clip_norm, spike_factor)``: as :func:`train_step_fn` —
    (params, opt, x, y, ref_loss) -> (params, opt, loss, grad_norm,
    status); a skipped step keeps the moments and the step count with
    the params (a half-applied state would corrupt the bias correction)."""
    def step(params, opt, x, y, ref_loss=None):
        loss, grads = _value_and_grad(params, x, y, cfg, sp, dp)
        grads = _grad_reduce(grads, dp, sp)
        gnorm = _grad_norm(grads, dp) if with_grad_norm or guard is not None else None
        if guard is not None:
            ok, status, grads = _apply_guard(loss, gnorm, grads, ref_loss, *guard, dp, sp)
        new_params, new_opt = _adam_update(params, opt, grads, lr, b1, b2, eps)
        if guard is not None:
            return (_select(ok, new_params, params), _select(ok, new_opt, opt), loss, gnorm,
                    status)
        if with_grad_norm:
            return new_params, new_opt, loss, gnorm
        return new_params, new_opt, loss

    return step


def train_step_adam(mesh: StackedMesh, cfg: TransformerConfig, lr: float = 1e-3,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, dp: str = "dp",
                    sp: str = "sp", with_grad_norm: bool = False, counter=None, guard=None):
    """:func:`train_step` with Adam: fn(params, opt_state, x, y) -> (params,
    opt_state, loss); ``opt_state`` from :func:`init_adam_state`, moments
    split like their params. ``counter`` and ``guard`` as in
    :func:`train_step`: the guarded variant is fn(params, opt, x, y,
    ref_loss) -> (params, opt, loss, grad_norm, status)."""
    _validate_step_config(mesh, cfg, dp, sp)
    pspec, ospec = param_spec(cfg, dp), adam_state_spec(cfg, dp)
    body = _built(counter, lambda: train_step_adam_fn(
        cfg, lr, b1, b2, eps, sp=sp, dp=dp, with_grad_norm=with_grad_norm, guard=guard))
    if guard is not None:
        return run_spmd(mesh, body, (pspec, ospec, P(dp, sp), P(dp, sp), P()),
                        (pspec, ospec, P(), P(), P()))
    out = (pspec, ospec, P(), P()) if with_grad_norm else (pspec, ospec, P())
    return run_spmd(mesh, body, (pspec, ospec, P(dp, sp), P(dp, sp)), out)


# ---- the pipelined steps (dp x sp x stage) -------------------------------------------


def stack_layers(params: dict) -> dict:
    """The per-layer dicts stacked into one dict of ``(n_layers, ...)``
    tensors: the layout the stage axis splits (leading dim = layer = stage
    ownership)."""
    layers = params["layers"]
    return {"layers": {k: torch.stack([p[k] for p in layers]) for k in layers[0]}}


def unstack_layers(stacked: dict) -> dict:
    """The inverse of :func:`stack_layers`."""
    sl = stacked["layers"]
    n = next(iter(sl.values())).shape[0]
    return {"layers": [{k: sl[k][i] for k in sl} for i in range(n)]}


def param_spec_pp(cfg: TransformerConfig, stage: str = "stage", dp: str = "dp") -> dict:
    """PartitionSpec tree for :func:`stack_layers`' output: every leaf split
    over ``stage`` on the layer dim, expert leaves also over ``dp`` on their
    expert dim."""
    return {"layers": {name: P(stage, dp) if name in EXPERT_LEAVES else P(stage)
                       for name in LAYER_LEAVES}}


def _pp_loss_fn(cfg: TransformerConfig, n_micro: int, sp: str, dp: str, stage: str):
    """The pipelined loss both pipelined step builders share: GPipe
    microbatching over ``stage`` around the dp x sp block (ring attention
    over sp, expert MoE over dp).

    Each stage rank owns ``n_layers / |stage|`` consecutive layers (stacked
    leaves, :func:`param_spec_pp`); the local batch splits into ``n_micro``
    microbatches that stream through the open ppermute chain, and every tick
    runs every stage's layers at once. The MoE aux loss accumulates per
    (tick, stage), masked by schedule validity, and is averaged over
    microbatches, so its scale matches the sequential step's."""

    def loss_fn(stacked, x, y):
        cd = getattr(torch, cfg.compute_dtype)
        if cd != torch.float32:
            stacked = _map(lambda _p, w: w.to(cd), stacked)
            x = x.to(cd)
        m = _nmesh()
        sl = stacked["layers"]
        ls = next(iter(sl.values())).shape[m]  # layers a stage
        B, S, d = x.shape[m:]
        if B % n_micro:
            raise ValueError(f"local batch {B} not divisible by {n_micro} microbatches")
        micro = x.reshape(*x.shape[:m], n_micro, B // n_micro, S, d)

        def stage_apply(act):
            aux = torch.zeros(current_mesh().shape, dtype=torch.float32, device=act.device)
            for i in range(ls):
                act, a = _block({k: sl[k].select(m, i) for k in sl}, act, cfg, sp, dp)
                aux = aux + a
            return act, aux

        out, aux_acc = gpipe_scan(stage_apply, micro, stage)
        out = out.reshape(*out.shape[:m], B, S, d)
        mse = torch.mean(torch.square(out.float() - y.float()), dim=tuple(range(m, out.ndim)))
        return _pmean(mse + cfg.aux_coef * (aux_acc / n_micro), (dp, sp))

    return loss_fn


def _validate_pp(mesh: StackedMesh, cfg: TransformerConfig, dp: str, sp: str,
                 stage: str) -> None:
    """The pipelined step builders' shared preconditions."""
    _validate_step_config(mesh, cfg, dp, sp)
    n_stage = mesh.shape[mesh.axis_names.index(stage)]
    if cfg.n_layers % n_stage:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by stage size {n_stage}")


def _pp_loss_and_grads(loss_fn, stacked, x, y, dp: str, sp: str, stage: str):
    """Loss and gradients with the 3-axis reduction: :func:`_grad_reduce`
    for the dp/sp copy axes, then ÷|stage|. Every stage rank seeds its own
    copy of the stage-replicated loss, and the backward of the stage sum and
    of the ppermute chain carries all |stage| seeds to every leaf, as the
    psum and ppermute transposes do in the JAX package."""
    loss, grads = _value_and_grad_of(loss_fn, stacked, x, y)
    grads = _grad_reduce(grads, dp, sp)
    n_stage = axis_size(stage)
    if n_stage > 1:
        grads = _map(lambda _p, g: g / n_stage, grads)
    return loss, grads


def train_step_pp_fn(cfg: TransformerConfig, lr: float = 1e-2, n_micro: int = 2,
                     sp: str = "sp", dp: str = "dp", stage: str = "stage"):
    """The 3-axis ``run_spmd`` body with SGD: (stacked, x, y) -> (stacked,
    loss). See :func:`_pp_loss_fn` for the pipeline."""
    loss_fn = _pp_loss_fn(cfg, n_micro, sp, dp, stage)

    def step(stacked, x, y):
        loss, grads = _pp_loss_and_grads(loss_fn, stacked, x, y, dp, sp, stage)
        return _map(lambda _p, w, g: w - lr * g, stacked, grads), loss

    return step


def train_step_pp(mesh: StackedMesh, cfg: TransformerConfig, lr: float = 1e-2,
                  n_micro: int = 2, dp: str = "dp", sp: str = "sp", stage: str = "stage"):
    """The 3-axis training step over ``mesh`` (dp x sp x stage): fn(stacked,
    x, y) -> (stacked, loss), the :func:`stack_layers` layout split by
    :func:`param_spec_pp`, x and y ``(batch, seq, d_model)`` split P(dp, sp).

    The MoE aux term is averaged over microbatches and is nonlinear in the
    routing group's size, so an ``n_micro > 1`` step is not the sequential
    (``n_micro == 1``) step: compare losses across schedules at one
    ``n_micro``."""
    _validate_pp(mesh, cfg, dp, sp, stage)
    pspec = param_spec_pp(cfg, stage, dp)
    return run_spmd(mesh, train_step_pp_fn(cfg, lr, n_micro, sp=sp, dp=dp, stage=stage),
                    (pspec, P(dp, sp), P(dp, sp)), (pspec, P()))


def adam_state_spec_pp(cfg: TransformerConfig, stage: str = "stage", dp: str = "dp") -> dict:
    """PartitionSpec tree for the stacked Adam moments."""
    return {"mu": param_spec_pp(cfg, stage, dp), "nu": param_spec_pp(cfg, stage, dp), "t": P()}


def train_step_pp_adam_fn(cfg: TransformerConfig, lr: float = 1e-3, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8, n_micro: int = 2,
                          sp: str = "sp", dp: str = "dp", stage: str = "stage"):
    """The 3-axis body with Adam: (stacked, opt, x, y) -> (stacked, opt,
    loss); the moments are stacked and split like the params."""
    loss_fn = _pp_loss_fn(cfg, n_micro, sp, dp, stage)

    def step(stacked, opt, x, y):
        loss, grads = _pp_loss_and_grads(loss_fn, stacked, x, y, dp, sp, stage)
        new_params, new_opt = _adam_update(stacked, opt, grads, lr, b1, b2, eps)
        return new_params, new_opt, loss

    return step


def train_step_pp_adam(mesh: StackedMesh, cfg: TransformerConfig, lr: float = 1e-3,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       n_micro: int = 2, dp: str = "dp", sp: str = "sp",
                       stage: str = "stage"):
    """:func:`train_step_pp` with Adam: fn(stacked, opt, x, y) -> (stacked,
    opt, loss), ``opt`` from :func:`init_adam_state` of the stacked params."""
    _validate_pp(mesh, cfg, dp, sp, stage)
    pspec, ospec = param_spec_pp(cfg, stage, dp), adam_state_spec_pp(cfg, stage, dp)
    return run_spmd(mesh, train_step_pp_adam_fn(cfg, lr, b1, b2, eps, n_micro, sp=sp, dp=dp,
                                                stage=stage),
                    (pspec, ospec, P(dp, sp), P(dp, sp)), (pspec, ospec, P()))
