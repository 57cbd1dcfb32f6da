"""The port's fused Adam (``tpuscratch_torch.ops.adam``) against the JAX
package's (``tpuscratch.ops.adam``, its Pallas kernel in the Mosaic
interpreter, as tests/test_ops.py runs it), on the same seeded numpy
inputs. Here the port takes its plain path (CPU tensors); the card-side
tests hold the CUDA kernel to that plain path bit for bit.

Tolerances: f32 moments rtol 1e-6, atol 1e-7 (XLA:CPU may contract the
interpreted kernel's multiply-adds into FMAs, and the TPU kernel forms (1 -
b2) (g g) where the port forms ((1 - b2) g) g, the tree-mapped update's
association); bf16 moments 1e-2 of the f32 result (the stored moments are
bfloat16). The port's plain form equals its tree-mapped Adam
(``models.transformer._adam_update``) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import to_torch
from tpuscratch.ops import adam as jadam
from tpuscratch_torch.bench import adam_bench
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.ops import adam as tadam

B1, B2, EPS = 0.9, 0.999, 1e-8


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    w, g, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(shape)).astype(np.float32)
    return w, g, m, v


def _jax_tree(leaves, alpha, mdt=jnp.float32):
    w, g, m, v = ({k: jnp.asarray(a[i], mdt if i >= 2 else jnp.float32)
                   for k, a in leaves.items()} for i in range(4))
    return [{k: np.asarray(t[k].astype(jnp.float32)) for k in t}
            for t in jadam.fused_adam_tree(w, g, m, v, alpha, B1, B2, EPS)]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


TREE = {"a": (64, 1024), "b": (3, 130, 7), "c": (1000,)}


@pytest.mark.parametrize("donate", [False, True])
def test_tree_matches_jax_f32(donate):
    leaves = {k: _arrays(s, 31 + i) for i, (k, s) in enumerate(TREE.items())}
    alpha = 1e-3 * np.sqrt(1.0 - B2) / (1.0 - B1)
    want = _jax_tree(leaves, alpha)
    trees = [{k: to_torch(a[i].copy()) for k, a in leaves.items()} for i in range(4)]
    got = tadam.fused_adam_tree(*trees, alpha, B1, B2, EPS, donate=donate)
    for g_tree, w_tree in zip(got, want):
        for k in TREE:
            _close(g_tree[k], w_tree[k], 1e-6, 1e-7)


def test_tree_matches_jax_bf16_moments():
    leaves = {k: _arrays(s, 41 + i) for i, (k, s) in enumerate(TREE.items())}
    want = _jax_tree(leaves, 1e-3)
    w, g, m, v = ({k: to_torch(a[i].copy()) for k, a in leaves.items()} for i in range(4))
    m16, v16 = ({k: x.to(torch.bfloat16) for k, x in t.items()} for t in (m, v))
    got = tadam.fused_adam_tree(w, g, m16, v16, 1e-3, B1, B2, EPS)
    for k in TREE:
        assert got[1][k].dtype == torch.bfloat16 and got[2][k].dtype == torch.bfloat16
        for g_t, w_t in zip(got, want):
            _close(g_t[k], w_t[k], 1e-2, 1e-2)


@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 3001])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_ragged_lengths_need_no_padding(n, mdt):
    # the JAX kernel pads each leaf to (rows, 1024); the port takes any length
    w, g, m, v = _arrays((n,), 50 + n)
    jdt = jnp.float32 if mdt == torch.float32 else jnp.bfloat16
    want = _jax_tree({"x": (w, g, m, v)}, 2e-3, jdt)
    got = tadam.fused_adam_flat(to_torch(w), to_torch(g), to_torch(m).to(mdt), to_torch(v).to(mdt),
                                2e-3, donate=False)
    tol = (1e-6, 1e-7) if mdt == torch.float32 else (1e-2, 1e-2)
    for g_t, w_t in zip(got, want):
        assert g_t.shape == (n,)
        _close(g_t, w_t["x"], *tol)


def test_flat_matches_jax_flat_layout():
    w, g, m, v = _arrays((64, 1024), 60)
    want = jadam.fused_adam_flat(*(jnp.asarray(a) for a in (w, g, m, v)), 1e-3, donate=False)
    got = tadam.fused_adam_flat(*(to_torch(a) for a in (w, g, m, v)), 1e-3, donate=False)
    for g_t, w_t in zip(got, want):
        _close(g_t, np.asarray(w_t), 1e-6, 1e-7)


def test_stacked_alpha_is_one_value_per_rank():
    # four stacked ranks, four step sizes, one launch; against four JAX calls
    w, g, m, v = _arrays((4, 3001), 61)
    alphas = np.array([1e-3, 2e-3, 5e-4, 3e-3], np.float32)
    got = tadam.fused_adam_flat(*(to_torch(a) for a in (w, g, m, v)), to_torch(alphas),
                                donate=False)
    for r in range(4):
        want = _jax_tree({"x": (w[r], g[r], m[r], v[r])}, float(alphas[r]))
        for g_t, w_t in zip(got, want):
            _close(g_t[r], w_t["x"], 1e-6, 1e-7)


def test_alpha_must_lead_the_operand():
    w = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="prefix"):
        tadam.fused_adam_flat(w, w, w, w, torch.ones(5))


def test_donate_aliases_and_no_donate_leaves_inputs():
    w, g, m, v = (to_torch(a) for a in _arrays((3, 77), 62))
    keep = [t.clone() for t in (w, g, m, v)]
    new = tadam.fused_adam_flat(w, g, m, v, 1e-3, donate=False)
    for t, k in zip((w, g, m, v), keep):
        assert torch.equal(t, k)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(new, (w, m, v)))
    out = tadam.fused_adam_flat(w, g, m, v, 1e-3, donate=True)
    assert [t.data_ptr() for t in out] == [w.data_ptr(), m.data_ptr(), v.data_ptr()]
    for a, b in zip(out, new):
        assert torch.equal(a, b)
    assert torch.equal(g, keep[1])


@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_plain_equals_tree_mapped_adam(mdt):
    # the kernel's arithmetic is the replicated step's Adam, bit for bit (the
    # moments rounded to bf16 only where they are stored)
    leaves = {k: _arrays(s, 70 + i) for i, (k, s) in enumerate(TREE.items())}
    p, g, m, v = ({k: to_torch(a[i].copy()) for k, a in leaves.items()} for i in range(4))
    m, v = ({k: x.to(mdt) for k, x in t.items()} for t in (m, v))
    t = torch.tensor(4, dtype=torch.int32)
    want_p, want_o = tt._adam_update(p, {"mu": {k: x.float() for k, x in m.items()},
                                         "nu": {k: x.float() for k, x in v.items()}, "t": t - 1},
                                     g, 1e-3, B1, B2, EPS)
    alpha = tt.adam_alpha(t, 1e-3, B1, B2)
    got = tadam.fused_adam_tree(p, g, m, v, alpha, B1, B2, EPS)
    for k in TREE:
        assert torch.equal(got[0][k], want_p[k])
        assert torch.equal(got[1][k], want_o["mu"][k].to(mdt))
        assert torch.equal(got[2][k], want_o["nu"][k].to(mdt))


def test_adam_bench_gate_and_forms_on_a_tiny_tree():
    gen = torch.Generator().manual_seed(3)
    leaves = {"a": (5, 7), "b": (130,)}
    trees = [adam_bench.make_tree(gen, leaves=leaves) for _ in range(3)]
    nu = adam_bench.make_tree(gen, leaves=leaves, positive=True)
    assert adam_bench.gate(*trees, nu) == 0.0
    assert adam_bench.n_params() == 253_921_280
    out = {}
    for form, mdt in adam_bench.FORMS:
        mu = {k: x.to(mdt) for k, x in trees[2].items()}
        out[form] = adam_bench.run(form, trees[0], trees[1], mu,
                                   {k: x.to(mdt) for k, x in nu.items()}, 2)[0]
    for form in ("1-map", "kernel"):
        for k in leaves:
            assert torch.equal(out[form][k], out["3-map"][k])
    for k in leaves:
        assert torch.equal(out["1-map-bf16m"][k], out["kernel-bf16m"][k])
