"""Split TF32 ("3xTF32") as an f32 flash kernel on Hopper's tensor cores
would compute, emulated in plain torch on the CPU, against the JAX
package's f32 ``flash_attention`` (its Pallas kernels in interpret mode, as
``tests/test_torch_flash.py`` runs them).

A TF32 tensor-core product reads 10 mantissa bits of each f32 operand. The
split keeps f32 accuracy with three of them: x = hi + lo, hi = tf32(x),
lo = tf32(x - hi), and a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b (the lo lo
term and lo's own rounding are below 2^-21 of the product). Each TF32
product is exact in f32 (11 x 11 significant bits), and the sums run in f32,
as they do in the tensor cores. The forward and the backward of a small
attention through these products must land within the f32 kernels' limit
on the card (``FLASH_TOL`` of max(1, max|want|), chip_smoke.py), and a
single TF32 product must miss it: that is why one TF32 pass is not an f32
kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.ops import attention as ja

FLASH_TOL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def attention(q, k, v, do, causal, mm):
    """(out, dq, dk, dv) of attention over (S, H, D) f32 operands with every
    product through ``mm``: the flash kernels' formulas, head-major."""
    S, H, D = q.shape
    T = k.shape[0]
    scale = 1.0 / math.sqrt(D)
    qs, kh, vh, dh = (x.transpose(0, 1) for x in (q * scale, k, v, do))   # (H, n, D)
    s = mm(qs, kh.transpose(1, 2))
    keep = torch.ones(S, T, dtype=torch.bool)
    if causal:
        keep = torch.arange(S)[:, None] >= torch.arange(T)
    s = torch.where(keep, s, torch.tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.tensor(0.0))
    l = p.sum(-1, keepdim=True)
    o = mm(p, vh) / l
    p = torch.where(keep, torch.exp(s - (m + torch.log(l))), torch.tensor(0.0))
    delta = (dh * o).sum(-1, keepdim=True)
    ds = p * (mm(dh, vh.transpose(1, 2)) - delta)
    dq = mm(ds, kh * scale)
    dk = mm(ds.transpose(1, 2), qs)
    dv = mm(p.transpose(1, 2), dh)
    return tuple(x.transpose(0, 1) for x in (o, dq, dk, dv))


def _jax_reference(q, k, v, do, causal):
    def loss(q, k, v):
        return jnp.sum(ja.flash_attention(q, k, v, causal=causal) * jnp.asarray(do))

    args = tuple(map(jnp.asarray, (q, k, v)))
    out = ja.flash_attention(*args, causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(x) for x in (out, *grads)]


def _share(got: torch.Tensor, want: np.ndarray) -> float:
    """The error over the f32 kernels' limit: FLASH_TOL of max(1, max|want|)."""
    err = float(np.abs(got.numpy().astype(np.float64) - want).max())
    return err / (FLASH_TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,T,D", [(96, 80, 64), (64, 96, 128)])
def test_split_tf32_holds_the_f32_limit(S, T, D, causal):
    q, k, v, do = rand((S, 2, D), D), rand((T, 2, D), D + 1), rand((T, 2, D), D + 2), \
        rand((S, 2, D), D + 3)
    want = _jax_reference(q, k, v, do, causal)
    args = [to_torch(x) for x in (q, k, v, do)]
    split = attention(*args, causal, mm_split)
    single = attention(*args, causal, mm_tf32)
    names = ("out", "dq", "dk", "dv")
    for name, g, w in zip(names, split, want):
        assert _share(g, w) <= 1.0, f"3xTF32 {name}: {_share(g, w):.3f} of the limit"
    # one TF32 pass keeps about three decimal digits: over the limit
    assert max(_share(g, w) for g, w in zip(single, want)) > 10.0


def test_tf32_rounds_to_nearest_even():
    ulp = 2.0 ** -10                                      # TF32's ulp at 1
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + 1.5 * ulp, 1.0 + ulp / 2 + 2.0 ** -20,
                      -(1.0 + 1.5 * ulp), 3.0e-3], dtype=torch.float32)
    want = [1.0, 1.0, 1.0 + 2 * ulp, 1.0 + ulp, -(1.0 + 2 * ulp)]
    assert tf32(x)[:5].tolist() == want
    # 10 mantissa bits left: the low 13 are zero, and the rounding error is
    # at most half a TF32 ulp
    bits = tf32(x).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert abs(float(tf32(x)[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
