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
(argmax, first index on ties, no key consumed). The speculative
accept/resample functions wait for the speculation slice.
"""

from __future__ import annotations

import torch

from tpuscratch_torch.parallel.scores import NEG_INF
from tpuscratch_torch.runtime.mesh import resolve_device

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = 1.1754943508222875e-38  # float32's smallest normal, the uniform's floor


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


def _uniform_tiny(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1)`` per key
    row: 32 random bits per element from the partitionable threefry
    counts ``(0, i)``, their top 23 as a mantissa in [1, 2), minus 1."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(i), i)
    bits = b0 ^ b1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    return torch.maximum(tiny, f * (1.0 - tiny) + tiny)


def _categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` per row: argmax of Gumbel noise plus logits."""
    g = -torch.log(-torch.log(_uniform_tiny(keys, logits.shape[-1])))
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def _scaled(logits: torch.Tensor, temperature: float, top_k: int) -> torch.Tensor:
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, torch.tensor(NEG_INF, device=scaled.device))
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
