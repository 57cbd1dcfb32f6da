"""The port's cached attention (``tpuscratch_torch.ops.attention``) against
the JAX package's: the plain version against the dense oracle (1e-6) and
against the Pallas kernel run in interpret mode (the JAX tests'
FUSED_PAGED_ATOL, 1e-5), on f32, int8 and fp8 pools with ragged lengths,
sentinel table tails, an idle slot and K past page + 1. A float16 q
computes in f32 on both sides and rounds the output to f16 (F16_ATOL:
an f16 ulp at magnitudes under 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import to_torch
from tpuscratch.ops import attention as ja
from tpuscratch.serve.kvcache import quantize_pages
from tpuscratch_torch.ops import attention as ta

DENSE_ATOL = 1e-6   # f32 contractions summed in another order
FUSED_ATOL = 1e-5   # the JAX tests' FUSED_PAGED_ATOL (online softmax)
F16_ATOL = 2e-3
DTYPES = [None, jnp.int8, jnp.float8_e4m3fn]


def paged_case(seed, B, K, H=2, D=8, page=4, P=12, max_pages=5, dtype=None, lead=()):
    """numpy operands: q, pools (quantized on the JAX side, bit-equal to
    the port's), a shuffled table with sentinel tails, ragged lengths with
    an idle slot 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(lead + (B, K, H, D)).astype(np.float32)
    kf = rng.standard_normal(lead + (P, page, H, D)).astype(np.float32)
    vf = rng.standard_normal(lead + (P, page, H, D)).astype(np.float32)
    lens = rng.integers(1, max_pages * page - K + 2, lead + (B,)).astype(np.int32)
    lens[..., 0] = 0
    table = np.full(lead + (B, max_pages), P + 2, np.int32)
    for idx in np.ndindex(*lead, B):
        need = -(-(int(lens[idx]) + K - 1) // page)
        table[idx][:need] = rng.permutation(P)[:need]
    if dtype is None:
        return q, kf, vf, table, lens, None, None
    (k8, ks), (v8, vs) = quantize_pages(jnp.asarray(kf), dtype), quantize_pages(jnp.asarray(vf), dtype)
    return q, np.asarray(k8), np.asarray(v8), table, lens, np.asarray(ks), np.asarray(vs)


def _t(a):
    if a is None:
        return None
    if a.dtype == np.dtype(jnp.float8_e4m3fn):
        return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)
    return to_torch(np.array(a))


def _torch(ops):
    return [_t(a) for a in ops]


def _jax(ops):
    return [None if a is None else jnp.asarray(a) for a in ops]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 3, 6])
def test_plain_matches_dense_oracle(dtype, K):
    ops = paged_case(10 + K, 4, K, dtype=dtype)
    want = np.asarray(ja.verify_attention(*_jax(ops), fused=False))
    got = ta.verify_attention(*_torch(ops))     # fused=None on the CPU: plain
    np.testing.assert_allclose(got.numpy(), want, atol=DENSE_ATOL, rtol=0)
    assert not got[0].any()                     # the idle slot
    if K == 1:
        q1 = [o[:, 0] if i == 0 else o for i, o in enumerate(ops)]
        want1 = np.asarray(ja.decode_attention(*_jax(q1), fused=False))
        got1 = ta.decode_attention(*_torch(q1), fused=False)
        np.testing.assert_allclose(got1.numpy(), want1, atol=DENSE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype,K", [(None, 1), (jnp.int8, 6), (jnp.float8_e4m3fn, 3)])
def test_plain_matches_interpreted_pallas_kernel(dtype, K):
    # K = 6 > page + 1: the idle slot's frontier reaches past page 0
    ops = paged_case(20 + K, 3, K, dtype=dtype, max_pages=4)
    want = np.asarray(ja.verify_attention(*_jax(ops), fused=True))
    got = ta.paged_attention(*_torch(ops))      # the wrapper's CPU path
    np.testing.assert_allclose(got.numpy(), want, atol=FUSED_ATOL, rtol=0)


def test_stacked_ranks_equal_one_call_per_rank():
    ops = paged_case(30, 3, 2, dtype=jnp.int8, lead=(2, 3))
    t = _torch(ops)
    got = ta.verify_attention(*t)
    for r in np.ndindex(2, 3):
        one = ta.verify_attention(*[o[r] for o in t])
        assert torch.equal(got[r], one)


def test_fused_routing_on_the_cpu():
    t = _torch(paged_case(31, 2, 1))
    q1 = t[0][:, 0]
    with pytest.raises(ValueError, match="no CPU mode"):
        ta.decode_attention(q1, *t[1:], fused=True)
    assert torch.equal(ta.decode_attention(q1, *t[1:]), ta.decode_attention(q1, *t[1:], fused=False))
    with pytest.raises(ValueError, match="bad decode shapes"):
        ta.decode_attention(t[0], *t[1:])
    # the kernel takes any head count, d_head and page size; only the pool
    # dtype must be on the ladder
    assert set(ta.POOL_DTYPES) == {torch.float32, torch.int8, torch.float8_e4m3fn}


@pytest.mark.parametrize("dtype", DTYPES)
def test_f16_q(dtype):
    # a float16 q over every pool of the ladder: f16 out, f32 arithmetic
    ops = paged_case(40, 3, 2, dtype=dtype, max_pages=4)
    ops = (ops[0].astype(np.float16),) + tuple(ops[1:])
    want = ja.verify_attention(*_jax(ops), fused=True)
    assert want.dtype == jnp.float16
    got = ta.paged_attention(*_torch(ops))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=F16_ATOL, rtol=0)
    # on the card the wrapper widens it to the f32-q kernel
    assert torch.float16 in ta.PAGED_Q_WIDENED and torch.float16 not in ta.PAGED_Q_DTYPES
