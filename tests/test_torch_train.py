"""The port's training step (``tpuscratch_torch.models.transformer``)
against the JAX package's: ``train_step`` (SGD) and ``train_step_adam`` on
1x1, 2x1, 1x2 and 2x2 stacked meshes with ``attn_impl`` "xla", "pallas"
and "ulysses-pallas", from the same numpy parameters, Adam state and
batch. Each compares the loss and the update (new - old parameters, over
the learning rate: the logical gradient for SGD), so a gradient off by the
mesh size n cannot hide; against JAX on every mesh, this is the twin of
``tests/test_models.py::test_sharding_invariance`` and
``test_flash_training_matches_xla``. The JAX steps run under shard_map on
the virtual CPU mesh, their Pallas kernels in interpret mode.

Tolerances: f32 loss 1e-5 relative and updates 1e-4 / 1e-5 (sums in other
orders through attention, routing and the gradient reduction). The bf16
compute dtype rounds at other places in the two frameworks: XLA:CPU rounds
bf16 once per fused region, torch once per op, so the bf16 forward differs
by a few bf16 ulps (2^-8 relative) in every activation: loss 1e-3
relative, updates 2e-2 of the largest update magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.models import transformer as jt
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.bench.train_bench import bench_train, train_flops_per_token
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.runtime.mesh import make_mesh

B, S, D = 4, 16, 32
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
IMPLS = ["xla", "pallas", "ulysses-pallas"]
LR = 1e-2


def _cfgs(**kw):
    # capacity_factor = n_experts: no token is dropped (JAX's test_models)
    kw = dict(d_model=D, n_heads=2, n_experts=2, d_ff=48, capacity_factor=2.0, **kw)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _data(seed):
    return rand((B, S, D), seed), rand((B, S, D), seed + 1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _compare_updates(p0, jnew, tnew, lr, rtol, atol, rel_to_max=False):
    """(new - old) / lr of both against each other, each element allowed
    two f32 spacings of its parameter over lr besides the tolerance: the
    new parameters are stored in f32, so that is how finely an update is
    seen."""
    for w, a, b in zip(_leaves(p0), _leaves(jnew), [t.numpy() for t in tt._leaves(tnew)]):
        ja, tb = (a - w) / lr, (b - w) / lr
        tol = atol * max(1.0, float(np.abs(ja).max())) if rel_to_max else atol
        seen = 2 * np.spacing(np.abs(w).astype(np.float32)) / lr
        bad = np.abs(tb - ja) > tol + rtol * np.abs(ja) + seen
        assert not bad.any(), (f"{bad.sum()} of {bad.size} updates differ, worst "
                               f"{np.abs(tb - ja).max():.3e}")


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_sgd(dims, impl):
    jc, tc = _cfgs(attn_impl=impl)
    params = _np_tree(jt.init_params(dims[0] + 1, jc))
    x, y = _data(2 * dims[1])
    jmesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:dims[0] * dims[1]])
    jp, jl = jt.train_step(jmesh, jc, lr=LR)(jax.tree_util.tree_map(jnp.asarray, params),
                                             jnp.asarray(x), jnp.asarray(y))
    tp, tl = tt.train_step(make_mesh(dims, ("dp", "sp"), device="cpu"), tc, lr=LR)(
        tt.params_from_numpy(params, "cpu"), to_torch(x), to_torch(y))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _compare_updates(params, jp, tp, LR, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_adam(dims, impl):
    jc, tc = _cfgs(attn_impl=impl)
    params = _np_tree(jt.init_params(dims[1] + 5, jc))
    # a state one step in, so the bias correction and both moments matter
    opt = jt.init_adam_state(params)
    opt = {"mu": jax.tree_util.tree_map(lambda w: 0.01 * np.sin(w), params),
           "nu": jax.tree_util.tree_map(lambda w: 1e-4 * np.cos(w) ** 2, params),
           "t": np.asarray(opt["t"]) + 1}
    x, y = _data(7 + dims[0])
    jmesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:dims[0] * dims[1]])
    jp, jo, jl = jt.train_step_adam(jmesh, jc, lr=1e-3)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, opt), jnp.asarray(x), jnp.asarray(y))
    tp, to, tl = tt.train_step_adam(make_mesh(dims, ("dp", "sp"), device="cpu"), tc, lr=1e-3)(
        tt.params_from_numpy(params, "cpu"), tt.adam_state_from_numpy(opt, "cpu"),
        to_torch(x), to_torch(y))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert int(to["t"]) == int(jo["t"]) == 2
    _compare_updates(params, jp, tp, 1e-3, rtol=1e-4, atol=1e-5)
    for key in ("mu", "nu"):
        for a, b in zip(_leaves(jo[key]), [t.numpy() for t in tt._leaves(to[key])]):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_step_bf16(dims, impl):
    jc, tc = _cfgs(attn_impl=impl, compute_dtype="bfloat16")
    params = _np_tree(jt.init_params(3, jc))
    x, y = _data(11)
    jmesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:dims[0] * dims[1]])
    jp, jl = jt.train_step(jmesh, jc, lr=LR)(jax.tree_util.tree_map(jnp.asarray, params),
                                             jnp.asarray(x), jnp.asarray(y))
    tp, tl = tt.train_step(make_mesh(dims, ("dp", "sp"), device="cpu"), tc, lr=LR)(
        tt.params_from_numpy(params, "cpu"), to_torch(x), to_torch(y))
    assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl))
    _compare_updates(params, jp, tp, LR, rtol=0.0, atol=2e-2, rel_to_max=True)
    assert all(t.dtype == torch.float32 for t in tt._leaves(tp))  # f32 masters


def test_grad_norm_and_sharding_invariance():
    # the port's own 1x1 and 2x2 steps agree, and so do their grad norms, at
    # the tolerances of the JAX package's test_sharding_invariance
    _, tc = _cfgs(attn_impl="pallas")
    params = _np_tree(jt.init_params(9, _cfgs()[0]))
    x, y = map(to_torch, _data(13))
    out = {}
    for dims in [(1, 1), (2, 2)]:
        step = tt.train_step(make_mesh(dims, ("dp", "sp"), device="cpu"), tc, lr=LR,
                             with_grad_norm=True)
        out[dims] = step(tt.params_from_numpy(params, "cpu"), x, y)
    (p1, l1, g1), (p4, l4, g4) = out[(1, 1)], out[(2, 2)]
    assert abs(float(l1) - float(l4)) < 1e-4 and abs(float(g1) - float(g4)) < 1e-3 * float(g1)
    for a, b in zip(tt._leaves(p1), tt._leaves(p4)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=2e-4)


def test_levers_not_ported_and_validation():
    _, tc = _cfgs()
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    for kw in (dict(guard=(1.0, 2.0)), dict(counter=object())):
        with pytest.raises(NotImplementedError, match="A10"):
            tt.train_step(mesh, tc, **kw)
        with pytest.raises(NotImplementedError, match="A10"):
            tt.train_step_adam(mesh, tc, **kw)
    with pytest.raises(ValueError, match="not divisible by dp"):
        tt.train_step(make_mesh((2, 1), ("dp", "sp"), device="cpu"),
                      dataclasses.replace(tc, n_experts=3))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tt.train_step(mesh, dataclasses.replace(tc, attn_impl="ring"))


def test_params_and_adam_state_carry_bit_for_bit():
    jc, _ = _cfgs()
    params = _np_tree(jt.init_params(4, jc))
    opt = _np_tree(jt.init_adam_state(jax.tree_util.tree_map(jnp.asarray, params)))
    topt = tt.adam_state_from_numpy(opt, "cpu")
    assert topt["t"].dtype == torch.int32 and int(topt["t"]) == 0
    for a, b in zip(_leaves(params), tt._leaves(tt.params_from_numpy(params, "cpu"))):
        assert np.array_equal(a, b.numpy())
    ours = tt.init_adam_state(tt.params_from_numpy(params, "cpu"))
    assert all(float(t.abs().sum()) == 0 for t in tt._leaves(ours["mu"]) + tt._leaves(ours["nu"]))


def test_bench_train_on_the_cpu():
    from tpuscratch.bench.train_bench import train_flops_per_token as jax_fpt

    jc, tc = _cfgs(attn_impl="pallas")
    assert train_flops_per_token(tc, 2048) == jax_fpt(jc, 2048)
    mesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    for opt in ("sgd", "adam"):
        r = bench_train(mesh, tc, iters=1, optimizer=opt, fence="block")
        assert r.items == 2 * 2 * 16 * 2 and r.items_per_s > 0
    # the ZeRO step and the plan-composed (pipelined) step run since they were ported
    r = bench_train(mesh, tc, iters=1, zero=True, optimizer="adam", fence="block")
    assert r.items == 2 * 2 * 16 * 2 and r.items_per_s > 0
    from tpuscratch_torch.parallel.plan import ShardingPlan

    plan = ShardingPlan(make_mesh((1, 1, 1), ("dp", "sp", "pp"), device="cpu"), pp="pp",
                        n_micro=2)
    r = bench_train(cfg=tc, iters=1, optimizer="adam", fence="block", plan=plan)
    assert r.items == 2 * 8 * 2 and r.items_per_s > 0 and "adam-pp1-M2-ov4" in r.name
