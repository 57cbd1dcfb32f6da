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

The kernels (``csrc/flash_attention.cu``'s ``flash_*_tf32``) round hi with
ties away from zero (``cvt.rna``), compute the products whose natural B
operand would be MN-major transposed (dQ^T = K^T dS^T, scaled once at the
end; dV^T = dO^T P^T and dK^T = (q scale)^T dS^T, with p and ds as hi/lo
tiles and the dk/dv kernel's ds formed from p read back as hi + lo), and
add each key or query tile of 32 into a fresh tensor-core accumulator,
which goes into an f32 total by round-to-nearest adds. The tests below
hold that arithmetic to the JAX function, and a model of the tensor cores'
accumulation (exact products, each k8 step's sum added into the f32
accumulator with round toward zero) to the limit over a long key axis.
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


# ---- the kernels' arithmetic ------------------------------------------------------------

TILE = 32   # the kernels' key (forward, dq) or query (dk/dv) tile: a fresh accumulator each


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 to nearest, ties away from zero (``cvt.rna``)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (b + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' three passes, with f32 sums: hi_a lo_b, then
    lo_a hi_b, then hi_a hi_b."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mm_tc(a: torch.Tensor, b: torch.Tensor, tile=None, acc=None) -> torch.Tensor:
    """a @ b as the tensor cores add the three passes: each k8 step's exact
    sum (float64) into the f32 accumulator, rounded toward zero. ``tile``:
    a fresh accumulator every ``tile`` of the contracted axis, added into
    the f32 total to nearest (promotion); ``acc``: the accumulator to add
    into instead of zero (no promotion)."""
    (ah, al), (bh, bl) = split(a), split(b)
    K = a.shape[-1]
    tile = tile or K
    total = acc
    for t0 in range(0, K, tile):
        part = acc if (acc is not None and tile == K) else torch.zeros(
            a.shape[:-1] + b.shape[-1:])
        for k0 in range(t0, min(t0 + tile, K), 8):
            k1 = min(k0 + 8, K)
            for x, y in ((ah, bl), (al, bh), (ah, bh)):
                part = _rz(part.double() + x[..., k0:k1].double() @ y[..., k0:k1, :].double())
        total = part if (total is None or tile == K) else total + part
    return total


def kernel_attention(q, k, v, do, causal, mm):
    """(out, dq, dk, dv) over (S, H, D) f32 operands in the kernels' forms:
    O = P V; dQ^T = K^T dS^T times scale; dV^T = dO^T P^T, dK^T =
    (q scale)^T dS^T with dS from p read back as hi + lo."""
    S, H, D = q.shape
    T = k.shape[0]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
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
    dp = mm(dh, vh.transpose(1, 2))
    ds = p * (dp - delta)
    dq = (mm(kh.transpose(1, 2), ds.transpose(1, 2)) * scale).transpose(1, 2)
    ph, pl = split(p)
    dk = mm(qs.transpose(1, 2), (ph + pl) * (dp - delta)).transpose(1, 2)
    dv = mm(dh.transpose(1, 2), p).transpose(1, 2)
    return tuple(x.transpose(0, 1) for x in (o, dq, dk, dv))


def test_tf32_rna_rounds_ties_away():
    """The kernels' hi: ties away from zero, where ``tf32`` ties to even."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + 1.5 * ulp, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -20,
                      3.0e-3], dtype=torch.float32)
    assert tf32_rna(x)[:4].tolist() == [1.0 + ulp, 1.0 + 2 * ulp, -(1.0 + ulp), 1.0]
    assert tf32(x)[:3].tolist() == [1.0, 1.0 + 2 * ulp, -1.0]
    bits = tf32_rna(x).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert abs(float(tf32_rna(x)[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    # hi + lo is x to 2^-22 of |x|
    g = torch.from_numpy(rand((4096,), 7))
    hi, lo = split(g)
    assert float(((hi + lo - g).abs() / g.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,T,D", [(96, 80, 64), (64, 96, 128)])
def test_kernel_forms_hold_the_f32_limit(S, T, D, causal):
    q, k, v, do = rand((S, 2, D), D), rand((T, 2, D), D + 1), rand((T, 2, D), D + 2), \
        rand((S, 2, D), D + 3)
    want = _jax_reference(q, k, v, do, causal)
    got = kernel_attention(*[to_torch(x) for x in (q, k, v, do)], causal, mm_kernel)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _share(g, w) <= 1.0, f"{name}: {_share(g, w):.3f} of the limit"


def _exact(q, k, v, do):
    """(acc, l, o, dq, lse, delta) of full attention over (S, D) operands in float64."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q * scale) @ k.T
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = p @ v
    lse = m + torch.log(l)
    p = torch.exp(s - lse)
    delta = (do * acc / l).sum(-1, keepdim=True)
    dq = (p * (do @ v.T - delta)) @ (k * scale)
    return acc, l, acc / l, dq, lse, delta


def _tc_forward_dq(q, k, v, do, lse, delta, promote: bool):
    """(acc, l, o, dq) of one head as the forward and dq kernels compute them
    under the accumulation model: the online softmax over key tiles of
    TILE, O a fresh accumulator a tile added by one rounding (the fmaf
    o * corr + tile), or without promotion O rescaled and accumulated into;
    dQ^T over the keys a tile at a time, or in one accumulator."""
    S, D = q.shape
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qs = q * scale
    m, l, o = torch.full((S, 1), -1e30), torch.zeros(S, 1), torch.zeros(S, D)
    for c0 in range(0, k.shape[0], TILE):
        s = mm_tc(qs, k[c0:c0 + TILE].T.contiguous())
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - mn)
        corr = torch.exp(m - mn)
        l, m = l * corr + p.sum(-1, keepdim=True), mn
        vt = v[c0:c0 + TILE]
        if promote:
            o = (o.double() * corr.double() + mm_tc(p, vt).double()).float()
        else:
            o = mm_tc(p, vt, acc=o * corr)
    s = mm_tc(qs, k.T.contiguous())
    p = torch.exp(s - lse)
    ds = p * (mm_tc(do, v.T.contiguous()) - delta)
    dqt = mm_tc(k.T.contiguous(), ds.T.contiguous(), tile=TILE if promote else None)
    return o, l, o / l, (dqt * scale).T


def test_tensor_core_accumulation_needs_promotion():
    """Over config 6's 4096 keys at D 128, truncating every k8 step into one
    accumulator biases the forward's state (acc) past the f32 limit; a fresh
    accumulator a key tile of TILE, promoted by round-to-nearest adds (what
    the kernels do), holds it for every output."""
    T, D = 4096, 128
    q, k, v, do = (torch.from_numpy(rand((n, D), D + i)) for i, n in enumerate((16, T, T, 16)))
    want = _exact(q, k, v, do)
    lse, delta = want[4].float(), want[5].float()
    names = ("acc", "l", "out", "dq")
    shares = {}
    for promote in (True, False):
        got = _tc_forward_dq(q, k, v, do, lse, delta, promote)
        shares[promote] = {n: float((g.double() - w).abs().max())
                           / (FLASH_TOL * max(1.0, float(w.abs().max())))
                           for n, g, w in zip(names, got, want)}
    assert max(shares[True].values()) <= 1.0, shares[True]
    assert max(shares[False].values()) > 1.0, shares[False]
