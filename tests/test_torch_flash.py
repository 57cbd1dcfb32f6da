"""The port's flash attention (``tpuscratch_torch.ops.attention``, the
plain path on the CPU) against the JAX package's ``flash_attention``, whose
Pallas kernels run here in interpret mode as its own tests run them: the
forward, the state outputs, the gradients through the custom VJPs (the
port's ``torch.autograd.Function``s), fully masked rows, block-ragged
lengths, bf16 operands, leading batch dims with per-entry offsets, and the
backward entry point the ring calls.

Tolerances are the JAX package's own in ``tests/test_attention.py``: the
forward and state 1e-5 relative / 1e-6 absolute (f32 sums in other orders:
the JAX kernels online over blocks, the plain path the whole row at once),
gradients 1e-4 / 1e-5, bf16 0.05. Float16 operands compute in f32 on
both sides (the JAX ``_mm_dtype``; the port widens them to the f32 kernels)
and round the output and the gradients to f16: 2e-3, an f16 ulp at
magnitudes under 4, which the f32 results' different sum orders can flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.ops import attention as ja
from tpuscratch_torch.ops import attention as ta

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)
F16 = dict(rtol=2e-3, atol=2e-3)


def _qkv(S, T, H, D, seed):
    return rand((S, H, D), seed), rand((T, H, D), seed + 1), rand((T, H, D), seed + 2)


def _jax_flash(q, k, v, dtype=jnp.float32, **kw):
    return ja.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), **kw)


def _torch_flash(q, k, v, dtype=torch.float32, **kw):
    return ta.flash_attention(*(to_torch(x).to(dtype) for x in (q, k, v)), **kw)


@pytest.mark.parametrize("causal,S,T,qo,ko", [
    (False, 32, 32, 0, 0), (True, 32, 32, 0, 0), (True, 32, 48, 16, 0),
    (True, 24, 40, 0, 0), (False, 24, 40, 0, 0), (True, 16, 16, 0, 8),
])
def test_forward_and_state(causal, S, T, qo, ko):
    q, k, v = _qkv(S, T, 2, 16, S + T + qo)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    want = np.asarray(_jax_flash(q, k, v, **kw))
    np.testing.assert_allclose(_torch_flash(q, k, v, **kw).numpy(), want, **FWD)
    jstate = _jax_flash(q, k, v, return_state=True, **kw)
    tstate = _torch_flash(q, k, v, return_state=True, **kw)
    for a, b in zip(jstate, tstate):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **FWD)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("qo,ko", [(0, 0), (16, 0)])
def test_gradients(causal, qo, ko):
    q, k, v = _qkv(16, 24, 2, 8, 7)
    w = rand((16, 2, 8), 10)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)

    def jloss(q, k, v):
        return jnp.sum(ja.flash_attention(q, k, v, **kw) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
    (ta.flash_attention(*leaves, **kw) * to_torch(w)).sum().backward()
    for a, b, name in zip(want, leaves, "qkv"):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), **GRAD, err_msg=f"d{name}")


def test_fully_masked_rows_zero_with_zero_gradients():
    # keys 0..15 start at global 8: query rows 0..7 attend nothing
    q, k, v = _qkv(16, 16, 2, 8, 3)
    kw = dict(causal=True, q_offset=0, kv_offset=8)
    want = np.asarray(_jax_flash(q, k, v, **kw))
    leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = ta.flash_attention(*leaves, **kw)
    np.testing.assert_allclose(out.detach().numpy(), want, **FWD)
    assert torch.equal(out[:8], torch.zeros_like(out[:8]))
    (out ** 2).sum().backward()
    jg = jax.grad(lambda *a: jnp.sum(ja.flash_attention(*a, **kw) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for a, b in zip(jg, leaves):
        assert torch.isfinite(b.grad).all()
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), **GRAD)
    assert torch.equal(leaves[0].grad[:8], torch.zeros_like(leaves[0].grad[:8]))
    # kv entirely in the future: everything zero, nothing NaN
    leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = ta.flash_attention(*leaves, causal=True, q_offset=0, kv_offset=100)
    (out ** 2).sum().backward()
    for t in [out.detach()] + [x.grad for x in leaves]:
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.parametrize("causal", [False, True])
def test_bf16(causal):
    q, k, v = _qkv(16, 16, 2, 8, 4)
    w = rand((16, 2, 8), 11)
    got = _torch_flash(q, k, v, torch.bfloat16, causal=causal)
    assert got.dtype == torch.bfloat16
    want = _jax_flash(q, k, v, jnp.bfloat16, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16)

    def jloss(q, k, v):
        out = ja.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    leaves = [to_torch(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    (ta.flash_attention(*leaves, causal=causal).float() * to_torch(w)).sum().backward()
    for a, b in zip(jg, leaves):
        np.testing.assert_allclose(b.grad.float().numpy(), np.asarray(a.astype(jnp.float32)),
                                   **BF16)


@pytest.mark.parametrize("causal,S,T", [(False, 16, 16), (True, 16, 16), (True, 24, 40)])
def test_f16(causal, S, T):
    q, k, v = _qkv(S, T, 2, 8, 5 + S + T)
    w = rand((S, 2, 8), 12)
    got = _torch_flash(q, k, v, torch.float16, causal=causal)
    assert got.dtype == torch.float16
    want = _jax_flash(q, k, v, jnp.float16, causal=causal)
    assert want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **F16)

    def jloss(q, k, v):
        out = ja.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    leaves = [to_torch(x).to(torch.float16).requires_grad_() for x in (q, k, v)]
    (ta.flash_attention(*leaves, causal=causal).float() * to_torch(w)).sum().backward()
    for a, b in zip(jg, leaves):
        assert b.grad.dtype == torch.float16
        np.testing.assert_allclose(b.grad.float().numpy(), np.asarray(a.astype(jnp.float32)),
                                   **F16)


def test_f16_operands_take_the_f32_kernels():
    # on the card float16 operands reach the f32 kernels, widened
    ops = ta._flash_operands("flash", [torch.ones(4, 2, 8, dtype=torch.float16)] * 3)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in ops)
    with pytest.raises(TypeError, match="one dtype"):
        ta._flash_operands("flash", [torch.ones(4, 2, 8, dtype=torch.float16),
                                     torch.ones(4, 2, 8)])


def test_leading_dims_with_per_entry_offsets():
    # a (2, 3) batch of entries, each with its own offsets (one entry fully
    # masked), against one JAX call an entry
    S, T, H, D = 16, 24, 2, 8
    q, k, v = rand((2, 3, S, H, D), 20), rand((2, 3, T, H, D), 21), rand((2, 3, T, H, D), 22)
    qo = np.array([[0, 8, 16], [0, 0, 24]])
    ko = np.array([[0, 0, 0], [40, 8, 0]])
    got = ta.flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=True,
                             q_offset=torch.from_numpy(qo), kv_offset=torch.from_numpy(ko))
    for i, j in np.ndindex(2, 3):
        want = _jax_flash(q[i, j], k[i, j], v[i, j], causal=True, q_offset=int(qo[i, j]),
                          kv_offset=int(ko[i, j]))
        np.testing.assert_allclose(got[i, j].numpy(), np.asarray(want), **FWD)
    assert torch.equal(got[1, 0], torch.zeros_like(got[1, 0]))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_entry_point_f32_partials(causal):
    # the ring's direct call: head-major in the JAX package, (S, H, D) here
    S, T, H, D = 16, 16, 2, 8
    q, k, v = _qkv(S, T, H, D, 30)
    do = rand((S, H, D), 33)
    acc, m, l = _torch_flash(q, k, v, causal=causal, q_offset=16, kv_offset=0,
                             return_state=True)
    o, lse = ta._normalize(acc, m, l, torch.float32)
    delta = ta._delta(to_torch(do), o)
    got = ta._flash_bwd_call(to_torch(q), to_torch(k), to_torch(v), to_torch(do), lse, delta,
                             torch.tensor(16), torch.tensor(0), causal, out_dtype=torch.float32)

    def hm(x):
        return jnp.swapaxes(jnp.asarray(x), 0, 1)

    want = ja._flash_bwd_call(hm(q), hm(k), hm(v), hm(do), jnp.asarray(lse.numpy()),
                              jnp.asarray(delta.numpy()), jnp.asarray([16], jnp.int32),
                              jnp.asarray([0], jnp.int32), causal, 8, 8, out_dtype=jnp.float32)
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(jnp.swapaxes(a, 0, 1)), **GRAD)


def test_block_hints_refuse_nothing():
    assert ta._pick_block(24, 1024) == 8
    assert ta._pick_block(17, 1024) == 1  # the JAX package refuses this length
    q, k, v = _qkv(17, 13, 2, 8, 40)
    want = ta._flash_fwd_plain(*map(to_torch, (q, k, v)), 0, 0, True, False)
    got = ta.flash_attention(*map(to_torch, (q, k, v)), causal=True, block_q=4, block_k=3)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="bad attention shapes"):
        ta.flash_attention(torch.ones(8, 2, 4), torch.ones(8, 2, 6), torch.ones(8, 2, 6))


def test_dispatch_and_no_card_launches():
    q, k, v = map(to_torch, _qkv(16, 16, 2, 8, 50))
    ta.reset_launches()
    ta.flash_attention(q, k, v, causal=True)
    ta.flash_attention(q, k, v, causal=True, q_offset=torch.tensor(0))
    ta._flash_bwd_compact(q, k, v, q, torch.zeros(2, 16), torch.zeros(2, 16), 0, 0)
    # CPU tensors take the plain versions: nothing is launched
    assert set(ta.launch_counts().values()) == {0}
    with pytest.raises(TypeError, match="int offsets"):
        ta._flash_fwd_compact(q, k, v, torch.tensor(0), 0)
