"""Expert parallelism: the routed MoE feed-forward over a mesh axis.

The twin of ``tpuscratch.parallel.expert``. Switch-style: a linear gate scores every
local token, greedy iterated top-1 rounds with per-expert capacity ``C``
assign slots (tokens past capacity are dropped), the packed slots go to
their expert's rank by one ``all_to_all``, each rank runs its local
experts' FFN, and a reverse ``all_to_all`` brings the slots back to be
combined with their gate weights.

Inside ``run_spmd`` every tensor carries the stacked mesh's leading dims,
so each function here works on ``(*mesh, ...)`` tensors and counts its
own dims from the end. A JAX ``mode="drop"`` scatter is a scatter into
one extra slot that is then cut off.

The dispatch and combine gathers are ``torch.autograd.Function``s (the JAX
custom VJPs): the routing map is a bijection on filled slots, so both of
their backward passes are gathers through the inverse index, not the
scatter-adds autograd would run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuscratch_torch.comm.collectives import all_to_all
from tpuscratch_torch.comm.spmd import AxisName, axis_size


class Routing(NamedTuple):
    """One-hot routing plan: dispatch ``(..., T, E, C)`` 0/1, combine
    ``(..., T, E, C)`` gate-weighted, aux_loss ``(...)``."""

    dispatch: torch.Tensor
    combine: torch.Tensor
    aux_loss: torch.Tensor


class SparseRouting(NamedTuple):
    """Index-form routing plan: slot_token / slot_filled / slot_gate
    ``(..., E, C)``, tok_flat / tok_gate / tok_kept ``(..., T, k)``,
    aux_loss ``(...)``."""

    slot_token: torch.Tensor
    slot_filled: torch.Tensor
    tok_flat: torch.Tensor
    tok_gate: torch.Tensor
    tok_kept: torch.Tensor
    slot_gate: torch.Tensor
    aux_loss: torch.Tensor


def capacity(tokens: int, n_experts: int, factor: float = 1.25) -> int:
    """Per-expert capacity slots for ``tokens`` local tokens: the even
    share times ``factor``, at least 1."""
    return max(1, int(tokens * factor / n_experts))


def _routing_rounds(logits: torch.Tensor, cap: int, k: int):
    """Greedy iterated masked top-1 with per-expert capacity accounting
    across ``k`` rounds: per round ``(choice, gate, onehot, slot, kept)``
    over ``(..., T[, E])``, and the Switch load-balance aux loss."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    remaining = probs
    used = torch.zeros(logits.shape[:-2] + (E,), dtype=torch.int32, device=logits.device)
    rounds = []
    top1_frac = None
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)                           # (..., T)
        gate = torch.take_along_dim(remaining, choice[..., None], dim=-1)[..., 0]
        onehot = torch.nn.functional.one_hot(choice, E).to(torch.int32)   # (..., T, E)
        if top1_frac is None:
            top1_frac = onehot.float().mean(dim=-2)
        ahead = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
        slot = torch.sum((ahead + used[..., None, :]) * onehot, dim=-1, dtype=torch.int32)
        kept = slot < cap
        rounds.append((choice, gate, onehot, slot, kept))
        used = used + torch.sum(onehot * kept[..., None].to(torch.int32), dim=-2,
                                dtype=torch.int32)
        remaining = remaining * (1 - onehot)
    aux = E * torch.sum(top1_frac * probs.mean(dim=-2), dim=-1)
    return rounds, aux


def topk_routing(logits: torch.Tensor, cap: int, k: int = 1) -> Routing:
    """Top-k capacity routing from gate ``logits`` ``(..., T, E)``, one-hot form."""
    T, E = logits.shape[-2:]
    dispatch = torch.zeros(logits.shape[:-2] + (T, E, cap), device=logits.device)
    combine = torch.zeros_like(dispatch)
    rounds, aux = _routing_rounds(logits, cap, k)
    for choice, gate, onehot, slot, kept in rounds:
        slot_1h = torch.nn.functional.one_hot(slot.clamp(0, cap).long(), cap + 1)[..., :cap].float()
        sel = (kept[..., None] & (onehot == 1)).float()                   # (..., T, E)
        dispatch = dispatch + sel[..., None] * slot_1h[..., None, :]
        combine = combine + (gate[..., None] * sel)[..., None] * slot_1h[..., None, :]
    return Routing(dispatch, combine, aux)


def sparse_topk_routing(logits: torch.Tensor, cap: int, k: int = 1) -> SparseRouting:
    """:func:`topk_routing`'s assignment in index form; dropped choices
    scatter into the cut-off extra slot and carry zero gate weight."""
    T, E = logits.shape[-2:]
    lead = logits.shape[:-2]
    dev = logits.device
    slot_token = torch.zeros(lead + (E * cap + 1,), dtype=torch.int64, device=dev)
    slot_filled = torch.zeros(lead + (E * cap + 1,), device=dev)
    slot_gate = torch.zeros(lead + (E * cap + 1,), device=dev)
    tokens = torch.arange(T, device=dev).expand(lead + (T,))
    tok_flat, tok_gate, tok_kept = [], [], []
    rounds, aux = _routing_rounds(logits, cap, k)
    for choice, gate, _onehot, slot, kept in rounds:
        flat = choice * cap + slot
        oob = torch.where(kept, flat, E * cap)
        slot_token.scatter_(-1, oob, tokens)
        slot_filled.scatter_(-1, oob, torch.ones_like(gate))
        slot_gate.scatter_(-1, oob, gate.detach())  # feeds the combine's backward only
        tok_flat.append(torch.where(kept, flat, 0))
        tok_gate.append(torch.where(kept, gate, torch.zeros_like(gate)))
        tok_kept.append(kept.float())
    cut = lead + (E, cap)
    return SparseRouting(
        slot_token[..., :-1].reshape(cut), slot_filled[..., :-1].reshape(cut),
        torch.stack(tok_flat, dim=-1), torch.stack(tok_gate, dim=-1), torch.stack(tok_kept, dim=-1),
        slot_gate[..., :-1].reshape(cut), aux)


def _flat_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (..., N, D)`` rows at ``idx (..., *ishape)`` -> ``(..., *ishape, D)``."""
    g = torch.take_along_dim(x, idx.reshape(*x.shape[:-2], -1, 1), dim=-2)
    return g.reshape(*idx.shape, x.shape[-1])


class _SparseDispatch(torch.autograd.Function):
    """The JAX ``_sparse_dispatch``: ``(..., T, D)`` tokens -> ``(..., E, C,
    D)`` packed slots by gather; dx[t] = sum_j kept[t, j] *
    ct[tok_flat[t, j]] by gather, in place of autograd's (E*C, D)
    scatter-add into (T, D)."""

    @staticmethod
    def forward(ctx, x, slot_token, slot_filled, tok_flat, tok_kept):
        ctx.save_for_backward(tok_flat, tok_kept)
        return _flat_gather(x, slot_token) * slot_filled[..., None]

    @staticmethod
    def backward(ctx, ct):
        tok_flat, tok_kept = ctx.saved_tensors
        flat = ct.reshape(*ct.shape[:-3], -1, ct.shape[-1])
        dx = torch.sum(tok_kept[..., None] * _flat_gather(flat, tok_flat), dim=-2)
        return dx, None, None, None, None


class _SparseCombine(torch.autograd.Function):
    """The JAX ``_sparse_combine``: ``(..., E*C, D)`` slot outputs -> ``(...,
    T, D)``, each token reading its k slots back weighted by its gate.
    Backward: dflat[s] = slot_gate[s] * ct[slot_token[s]] (unclaimed slots
    have zero gate) and dgate recomputed from flat and ct, both gathers."""

    @staticmethod
    def forward(ctx, flat, tok_gate, tok_flat, slot_token, slot_gate):
        ctx.save_for_backward(flat, tok_flat, slot_token, slot_gate)
        return torch.sum(tok_gate[..., None] * _flat_gather(flat, tok_flat), dim=-2)

    @staticmethod
    def backward(ctx, ct):
        flat, tok_flat, slot_token, slot_gate = ctx.saved_tensors
        lead = slot_token.shape[:-2]
        dflat = (_flat_gather(ct, slot_token.reshape(*lead, -1))
                 * slot_gate.reshape(*lead, -1, 1)).to(flat.dtype)
        dgate = torch.einsum("...tkd,...td->...tk", _flat_gather(flat, tok_flat), ct)
        return dflat, dgate.float(), None, None, None


def expert_ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The per-expert MLP: ``(..., E, C', D) x (..., E, D, F) -> relu ->
    (..., E, C', D)``, one batched contraction per layer."""
    h = torch.relu(torch.einsum("...ecd,...edf->...ecf", x, w_in))
    return torch.einsum("...ecf,...efd->...ecd", h, w_out).to(x.dtype)


def expert_parallel_ffn(x: torch.Tensor, gate_w: torch.Tensor, w_in: torch.Tensor,
                        w_out: torch.Tensor, axis: AxisName, capacity_factor: float = 1.25,
                        k: int = 1, impl: str = "sparse") -> tuple[torch.Tensor, torch.Tensor]:
    """Routed MoE layer, experts split over mesh ``axis``; call inside
    ``run_spmd``. x ``(*mesh, T, D)`` local tokens, gate_w ``(*mesh, D,
    E_total)`` replicated, w_in/w_out ``(*mesh, E_local, D, F)`` /
    ``(*mesh, E_local, F, D)`` this rank's experts -> (out ``(*mesh, T,
    D)``, aux_loss ``(*mesh)``). ``impl`` "sparse" packs by gather,
    "einsum" by the one-hot contraction; both make the same assignment."""
    if impl not in ("sparse", "einsum"):
        raise ValueError(f"impl must be sparse|einsum, got {impl!r}")
    n = axis_size(axis)
    T, D = x.shape[-2:]
    e_local = w_in.shape[-3]
    e_total = n * e_local
    if tuple(gate_w.shape[-2:]) != (D, e_total):
        raise ValueError(f"gate_w {tuple(gate_w.shape[-2:])} != ({D}, {e_total}) for "
                         f"{e_local} local experts on a {n}-way axis")
    cap = capacity(T, e_total, capacity_factor)
    logits = x @ gate_w
    if impl == "einsum":
        route = topk_routing(logits, cap, k=k)
        packed = torch.einsum("...tec,...td->...ecd", route.dispatch, x.float())
    else:
        route = sparse_topk_routing(logits, cap, k=k)
        packed = _SparseDispatch.apply(x.float(), route.slot_token, route.slot_filled,
                                       route.tok_flat, route.tok_kept)
    routed = all_to_all(packed, axis, split_axis=0, concat_axis=1, tiled=True)
    y = expert_ffn(routed, w_in.float(), w_out.float())
    back = all_to_all(y, axis, split_axis=1, concat_axis=0, tiled=True)
    if impl == "einsum":
        out = torch.einsum("...tec,...ecd->...td", route.combine, back)
    else:
        flat = back.reshape(*back.shape[:-3], e_total * cap, D)
        out = _SparseCombine.apply(flat, route.tok_gate, route.tok_flat, route.slot_token,
                                   route.slot_gate)
    return out.to(x.dtype), route.aux_loss
