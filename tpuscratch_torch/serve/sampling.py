"""Token sampling: greedy, temperature, top-k, with per-request keys.

The twin of ``tpuscratch.serve.sampling``'s base sampler. The key for a
request's ``i``-th generated token is ``fold_in(fold_in(key(seed), rid),
i)``, so a replayed request draws the same tokens whichever slot it lands
in. The port keeps the JAX package's own key chain: threefry-2x32 written
in integer torch ops (``key``, ``fold_in``), and the categorical draw as
``jax.random.categorical`` builds it (Gumbel-max over ``uniform`` bits,
with ``jax_threefry_partitionable`` on). Key data therefore match the
JAX package's bit for bit, and a ``temperature > 0`` engine draws the
same tokens as the JAX engine on the same logits.

Keys are ``(..., 2)`` int64 tensors holding the two uint32 words (torch
has no full uint32 arithmetic). ``temperature == 0`` is exact greedy
(argmax, first index on ties, no key consumed).

Speculative acceptance (``accept_speculative`` on the host, ``accept_batch``
on the device for a whole slot bank) is the JAX package's rule: accept a
point-mass draft token ``d`` with probability ``p(d)`` under the target
distribution, and on rejection draw from ``p`` with ``d`` removed. Its
draws key off ``fold_in(request_key(seed, rid, position), sub)`` with
``sub`` 1 (the accept uniform) or 2 (the residual draw); the terminal
token after a full accept uses the plain ``request_key`` stream.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuscratch_torch.parallel.scores import NEG_INF
from tpuscratch_torch.runtime.mesh import resolve_device

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = 1.1754943508222875e-38  # float32's smallest normal, the uniform's floor
#: fold_in subkeys of the speculative accept/reject path (0 is the base
#: sampler's stream: request_key itself)
_SUB_ACCEPT = 1
_SUB_RESAMPLE = 2


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counts ``(x0, x1)`` under key
    ``(k0, k1)``: uint32 words in int64 tensors, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data: ``(0, seed)`` as two uint32 words,
    on ``device`` (the card unless another device is named)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``(..., 2)`` and uint32 ``data``
    (broadcast) -> ``(..., 2)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def request_key(seed: int, rid: int, position: int, device=None) -> torch.Tensor:
    """The key of request ``rid``'s ``position``-th generated token."""
    return fold_in(fold_in(key(seed, device), rid), position)


def request_keys(seed_key: torch.Tensor, rids: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """:func:`request_key` for a bank of slots: ``(B,)`` rids x ``(B,)``
    positions -> ``(B, 2)`` keys, the same chain as the scalar form."""
    return fold_in(fold_in(seed_key, rids), positions)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> float32 in [0, 1): their top 23 as a
    mantissa in [1, 2), minus 1 (``jax.random.uniform``'s construction)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _uniform_tiny(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1)`` per key
    row: 32 random bits per element from the partitionable threefry
    counts ``(0, i)``, their top 23 as a mantissa in [1, 2), minus 1."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(i), i)
    f = _unit_floats(b0 ^ b1)
    tiny = torch.full((), _TINY, dtype=torch.float32, device=keys.device)
    return torch.maximum(tiny, f * (1.0 - tiny) + tiny)


def _uniform(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` per key: ONE float32 in [0, 1) from the
    threefry count ``(0, 0)`` (a scalar draw, unlike the categorical's
    tiny-floored vector of :func:`_uniform_tiny`)."""
    zero = torch.zeros((), dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], zero, zero)
    return _unit_floats(b0 ^ b1)


def _categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` per row: argmax of Gumbel noise plus logits."""
    g = -torch.log(-torch.log(_uniform_tiny(keys, logits.shape[-1])))
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def _scaled(logits: torch.Tensor, temperature: float, top_k: int) -> torch.Tensor:
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    return scaled


def sample_logits(k: torch.Tensor, logits: torch.Tensor, temperature: float = 0.0,
                  top_k: int = 0) -> torch.Tensor:
    """One next-token draw from a ``(V,)`` logit row (int32 token id)."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return _categorical(k, _scaled(logits, temperature, top_k))


def sample_batch(keys: torch.Tensor, logits: torch.Tensor, temperature: float = 0.0,
                 top_k: int = 0) -> torch.Tensor:
    """Batched draw: keys ``(B, 2)``, logits ``(B, V)`` -> ``(B,)`` int32;
    each row uses its own key."""
    return sample_logits(keys, logits, temperature, top_k)


# ---- speculative acceptance ------------------------------------------------------


def accept_key(seed: int, rid: int, position: int, device=None) -> torch.Tensor:
    """The key of the accept/reject uniform at one draft position."""
    return fold_in(request_key(seed, rid, position, device), _SUB_ACCEPT)


def resample_key(seed: int, rid: int, position: int, device=None) -> torch.Tensor:
    """The key of the residual (post-rejection) categorical draw."""
    return fold_in(request_key(seed, rid, position, device), _SUB_RESAMPLE)


def _accept_uniforms(seed_key: torch.Tensor, rid, positions: torch.Tensor) -> torch.Tensor:
    """Every accept/reject uniform of one verify sweep: ``(n,)`` positions
    -> ``(n,)`` uniforms, each under :func:`accept_key`'s chain."""
    return _uniform(fold_in(request_keys(seed_key, rid, positions), _SUB_ACCEPT))


def target_probs(logits, temperature: float, top_k: int = 0) -> np.ndarray:
    """The distribution :func:`sample_logits` draws from, on the host in
    float32 (a copy of the JAX package's): softmax of ``logits /
    temperature`` over the top-k support (ties at the k-th kept)."""
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    scaled = np.asarray(logits, np.float32) / np.float32(temperature)
    if top_k:
        kth = np.sort(scaled)[-top_k]
        scaled = np.where(scaled >= kth, scaled, np.float32(NEG_INF))
    scaled = scaled - scaled.max()
    e = np.exp(scaled)
    return e / e.sum()


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` at ``idx`` along ``dim`` (idx has that dim dropped)."""
    return torch.take_along_dim(x, idx.unsqueeze(dim), dim=dim).squeeze(dim)


def accept_batch(seed_key: torch.Tensor, rids: torch.Tensor, pos0: torch.Tensor,
                 logits: torch.Tensor, drafts: torch.Tensor, draft_len: torch.Tensor,
                 temperature: float = 0.0, top_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The device-side :func:`accept_speculative` for a whole slot bank:
    ``logits`` ``(..., B, K, V)`` (row ``j`` scores the position after ``j``
    accepted drafts), ``drafts`` ``(..., B, K-1)`` with ``draft_len``
    ``(..., B)`` live tokens, ``pos0`` ``(..., B)`` each slot's
    generated-stream index of the round's first token, ``seed_key``
    ``(..., 2)`` broadcasting against the ``(..., B)`` dims ->
    ``(n_accepted, terminal)`` int32 ``(..., B)``. No host read.

    The draws key off the host rule's chains, position for position.
    Greedy is argmax equality, bit-equal to the host rule. At
    ``temperature > 0`` the accept thresholds come from a float32 softmax
    on the device where the host rule takes numpy's, so a uniform within
    an ulp or two of ``p(d)`` may decide the other way: the same
    distribution, an ulp-level tolerance on the thresholds (the JAX
    package states the same of its device rule)."""
    k = drafts.shape[-1]
    jk = torch.arange(k, device=logits.device)
    if temperature == 0.0:
        am = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = (am[..., :k] == drafts) & (jk < draft_len[..., None])
        n_acc = torch.cumprod(ok.to(torch.int32), dim=-1).sum(-1).to(torch.int32)
        return n_acc, _take(am, n_acc.long(), -1)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    e = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    slot_key = fold_in(seed_key, rids)                               # (..., B, 2)
    pos = pos0[..., None].long() + jk                                # (..., B, k)
    us = _uniform(fold_in(fold_in(slot_key[..., None, :], pos), _SUB_ACCEPT))
    pd = _take(probs[..., :k, :], drafts.long(), -1)                 # (..., B, k)
    ok = (us < pd) & (jk < draft_len[..., None])
    n_acc = torch.cumprod(ok.to(torch.int32), dim=-1).sum(-1)
    na = n_acc.long()
    # the rejection terminal: the residual distribution at position n_acc
    d_rej = _take(drafts, torch.clamp(na, 0, k - 1), -1)
    res = torch.take_along_dim(probs, na[..., None, None], dim=-2).squeeze(-2)
    res = res.scatter(-1, d_rej[..., None].long(), 0.0)
    tot = res.sum(-1)
    lg = torch.where(res > 0.0, torch.log(res), NEG_INF)
    base = fold_in(slot_key, pos0.long() + na)                       # (..., B, 2)
    tok_rej = torch.where(tot > 0.0, _categorical(fold_in(base, _SUB_RESAMPLE), lg),
                          d_rej.to(torch.int32))
    # the full-accept bonus: the base sampler's draw at pos0 + n_acc
    bonus_logits = torch.take_along_dim(scaled, na[..., None, None], dim=-2).squeeze(-2)
    tok_bonus = _categorical(base, bonus_logits)
    term = torch.where(na < draft_len, tok_rej, tok_bonus)
    return n_acc.to(torch.int32), term.to(torch.int32)


def accept_speculative(seed: int, rid: int, position0: int, logits, draft,
                       temperature: float = 0.0,
                       top_k: int = 0) -> tuple[int, tuple[int, ...]]:
    """One slot's verify sweep on the host (a copy of the JAX package's
    rule): ``logits`` ``(>= len(draft) + 1, V)``, row ``j`` scoring the
    position after ``j`` accepted drafts; ``position0`` the
    generated-stream index of the sweep's first emitted token. Returns
    ``(n_accepted, tokens)``, ``len(tokens) == n_accepted + 1``: the
    accepted draft prefix and the terminal token (the residual draw at
    the first rejection, or the base sampler's bonus draw after a full
    accept). Greedy is argmax at every position; an empty draft
    reproduces the non-speculative draw at any temperature."""
    logits = np.asarray(logits, np.float32)
    draft = tuple(int(t) for t in draft)
    if logits.ndim != 2 or logits.shape[0] < len(draft) + 1:
        raise ValueError(f"need {len(draft) + 1} logit rows, got {logits.shape}")
    if temperature == 0.0:
        am = np.argmax(logits, axis=-1)
        a = 0
        while a < len(draft) and int(am[a]) == draft[a]:
            a += 1
        return a, draft[:a] + (int(am[a]),)
    cpu = torch.device("cpu")
    us = (_accept_uniforms(key(seed, cpu), rid,
                           torch.arange(position0, position0 + len(draft))).numpy()
          if draft else ())
    a = 0
    for j, d in enumerate(draft):
        p = target_probs(logits[j], temperature, top_k)
        if us[j] < p[d]:
            a += 1
            continue
        # reject: the residual distribution is p with d removed
        res = p.copy()
        res[d] = 0.0
        if float(res.sum()) <= 0.0:
            # p was (numerically) a point mass at d: emitting d keeps the marginal
            return a, draft[:a] + (d,)
        r = torch.from_numpy(res)
        lg = torch.where(r > 0.0, torch.log(r), NEG_INF)
        tok = int(_categorical(resample_key(seed, rid, position0 + j, cpu), lg))
        return a, draft[:a] + (tok,)
    # every draft token accepted: the bonus draw is the base sampler's
    tok = int(sample_logits(request_key(seed, rid, position0 + a, cpu),
                            torch.from_numpy(logits[a]), temperature, top_k))
    return a, draft[:a] + (tok,)
