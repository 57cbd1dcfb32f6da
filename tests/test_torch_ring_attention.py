"""The port's sequence-parallel attention against the JAX package's:
``ring_attention`` ("xla" dense hops, "pallas" flash-kernel hops with the
ring backward) and ``ulysses_attention`` ("xla", "pallas"), forward and
gradients, on 1x2 and 2x2 stacked meshes (batch split over "dp", sequence
over "sp"), and the ring pipeline itself. The JAX functions run under
shard_map on the virtual CPU mesh, their Pallas kernels in interpret mode,
as the JAX package's own tests run them.

Tolerances are the JAX package's for flash attention (tests/test_attention.py):
forward 1e-5 relative / 1e-6 absolute, gradients 1e-4 / 1e-5 (f32 sums in
other orders and, across hops, another merge order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import rand, to_torch
from tpuscratch.comm import run_spmd as jax_run_spmd
from tpuscratch.parallel import ring as jring
from tpuscratch.parallel.ring_attention import ring_attention as jax_ring
from tpuscratch.parallel.ulysses import ulysses_attention as jax_ulysses
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.comm.spmd import axis_index
from tpuscratch_torch.ops import attention as ta
from tpuscratch_torch.parallel import ring as tring
from tpuscratch_torch.parallel.ring_attention import ring_attention as torch_ring
from tpuscratch_torch.parallel.ulysses import ulysses_attention as torch_ulysses
from tpuscratch_torch.runtime.mesh import make_mesh

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
B, S, H, D = 2, 16, 2, 8  # a local sequence block of 8 on sp = 2


def _jax_run(dims, attn, causal, impl, q, k, v, w):
    mesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:dims[0] * dims[1]])
    spec = JP("dp", "sp")

    def body(q, k, v):
        return jax.vmap(lambda a, b, c: attn(a, b, c, "sp", causal=causal, impl=impl))(q, k, v)

    f = jax_run_spmd(mesh, body, (spec, spec, spec), spec)
    out = f(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(dims, attn, causal, impl, q, k, v, w):
    mesh = make_mesh(dims, ("dp", "sp"), device="cpu")
    f = run_spmd(mesh, lambda q, k, v: attn(q, k, v, "sp", causal=causal, impl=impl),
                 (P("dp", "sp"),) * 3, P("dp", "sp"))
    leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = f(*leaves)
    (out * to_torch(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _inputs(seed):
    return [rand((B, S, H, D), seed + i) for i in range(4)]


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention(dims, impl, causal):
    q, k, v, w = _inputs(3 * dims[0] + (impl == "pallas") + 2 * causal)
    want, wgrads = _jax_run(dims, jax_ring, causal, impl, q, k, v, w)
    ta.reset_launches()
    got, grads = _torch_run(dims, torch_ring, causal, impl, q, k, v, w)
    np.testing.assert_allclose(got, want, **FWD)
    for a, b, name in zip(wgrads, grads, "qkv"):
        np.testing.assert_allclose(b, a, **GRAD, err_msg=f"d{name}")
    assert set(ta.launch_counts().values()) == {0}  # the CPU runs the plain versions


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ulysses_attention(dims, impl):
    q, k, v, w = _inputs(40 + dims[0])
    want, wgrads = _jax_run(dims, jax_ulysses, True, impl, q, k, v, w)
    got, grads = _torch_run(dims, torch_ulysses, True, impl, q, k, v, w)
    np.testing.assert_allclose(got, want, **FWD)
    for a, b, name in zip(wgrads, grads, "qkv"):
        np.testing.assert_allclose(b, a, **GRAD, err_msg=f"d{name}")


def test_ring_matches_unsplit_attention():
    # the ring over 4 ranks equals flash attention over the whole sequence
    q, k, v = (rand((4 * 8, H, D), 60 + i) for i in range(3))
    want = ta.flash_attention(*map(to_torch, (q, k, v)), causal=True)
    mesh = make_mesh((4,), ("sp",), device="cpu")
    for impl in ("xla", "pallas"):
        f = run_spmd(mesh, lambda q, k, v: torch_ring(q, k, v, "sp", causal=True, impl=impl),
                     (P("sp"),) * 3, P("sp"))
        np.testing.assert_allclose(f(*map(to_torch, (q, k, v))).numpy(), want.numpy(), **FWD)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("return_payload", [False, True])
def test_ring_scan(reverse, return_payload):
    # each rank sums, weighted by hop, the payloads that visit it
    n = 4
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1

    def jbody(xl):
        def combine(c, b, i):
            return c + (i + 1) * b
        c, p = jring.ring_scan(combine, jnp.zeros_like(xl), xl, "x", reverse, return_payload)
        return (c, p) if return_payload else (c, xl)

    def tbody(xl):
        def combine(c, b, i):
            return c + (i + 1) * b
        c, p = tring.ring_scan(combine, torch.zeros_like(xl), xl, "x", reverse, return_payload)
        return (c, p) if return_payload else (c, xl)

    jm = jax_mesh((n,), ("x",), jax.devices()[:n])
    want = jax_run_spmd(jm, jbody, JP("x"), (JP("x"), JP("x")))(jnp.asarray(x))
    got = run_spmd(make_mesh((n,), ("x",), device="cpu"), tbody, P("x"), (P("x"), P("x")))(
        to_torch(x))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ring_scan_rw_brings_contributions_home():
    # each visiting block collects the rank index of every rank it passes
    n = 3
    mesh = make_mesh((n,), ("x",), device="cpu")

    def body(xl):
        me = axis_index("x").to(xl.dtype).reshape(-1, 1, 1)
        return tring.ring_scan_rw(lambda c, b, i: (c + b, b + me), torch.zeros_like(xl), xl, "x")

    carry, home = run_spmd(mesh, body, P("x"), (P("x"), P("x")))(torch.zeros(n, 2))
    assert torch.equal(home, torch.full((n, 2), float(sum(range(n)))))
