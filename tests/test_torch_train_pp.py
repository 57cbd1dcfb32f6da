"""The port's pipelined training steps (``train_step_pp``,
``train_step_pp_adam``) against the JAX package's on the dp x sp x stage
meshes (1,1,1), (1,1,2), (2,1,2) and (2,2,2) at ``n_micro`` 2, from the
same numpy parameters (stacked), Adam state and batch; twins of
tests/test_models.py's TestPipelineComposedStep and TestPipelineAdam on a
2-layer model (d_model 16, 2 heads, 2 experts, d_ff 32, seq 16).

Tolerances against JAX: loss 1e-5 relative, updates (new - old over the
learning rate) 1e-4 relative plus 1e-5, and, for Adam, moments 1e-4
relative plus 1e-7 (sums in other orders through attention, routing and
the reductions). Within the port, bit for bit: the pp=1, n_micro=1 step
equals ``train_step`` and ``train_step_adam``, and the stage axis is
invariant (1x1x2 equals 1x1x1 at n_micro 2), which checks that the
backward of the stage sum and the ppermute chain overcounts by exactly
|stage|, the factor ``_pp_loss_and_grads`` divides out.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch.models import transformer as jt
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.runtime.mesh import make_mesh

AXES = ("dp", "sp", "stage")
KW = dict(d_model=16, n_heads=2, n_experts=2, d_ff=32, n_layers=2, capacity_factor=2.0)
DIMS = [(1, 1, 1), (1, 1, 2), (2, 1, 2), (2, 2, 2)]


def _cfgs():
    return jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed=0):
    return rand((4, 16, 16), seed), rand((4, 16, 16), seed + 1)


@functools.lru_cache(maxsize=None)
def _stacked(seed):
    return _np(jt.stack_layers(jt.init_params(seed, _cfgs()[0])))


def _tmesh(dims):
    return make_mesh(dims, AXES, device="cpu")


def _jmesh(dims):
    return jax_mesh(dims, AXES, jax.devices()[:int(np.prod(dims))])


def _moments(params):
    return {"mu": jax.tree_util.tree_map(lambda w: 0.01 * np.sin(w), params),
            "nu": jax.tree_util.tree_map(lambda w: 1e-4 * np.cos(w) ** 2, params),
            "t": np.asarray(1, np.int32)}


def _updates_close(p0, jnew, tnew, lr):
    for w, a, (_, b) in zip(jax.tree_util.tree_leaves(p0), jax.tree_util.tree_leaves(jnew),
                            tt._jax_paths(tnew)):
        ja, tb = (np.asarray(a) - w) / lr, (b.numpy() - w) / lr
        seen = 2 * np.spacing(np.abs(w).astype(np.float32)) / lr
        np.testing.assert_array_less(np.abs(tb - ja), 1e-5 + 1e-4 * np.abs(ja) + seen)


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(tt._leaves(a), tt._leaves(b)))


@pytest.mark.parametrize("dims", DIMS)
def test_train_step_pp_matches_jax(dims):
    jc, tc = _cfgs()
    params = _stacked(6)
    x, y = _data(2)
    jp, jl = jt.train_step_pp(_jmesh(dims), jc, lr=0.05, n_micro=2)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    tp, tl = tt.train_step_pp(_tmesh(dims), tc, lr=0.05, n_micro=2)(
        tt.params_from_numpy(params, "cpu"), to_torch(x), to_torch(y))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _updates_close(params, jp, tp, 0.05)


@pytest.mark.parametrize("dims", DIMS)
def test_train_step_pp_adam_matches_jax(dims):
    jc, tc = _cfgs()
    params = _stacked(9)
    opt = _moments(params)
    x, y = _data(4)
    jp, jo, jl = jt.train_step_pp_adam(_jmesh(dims), jc, lr=1e-3, n_micro=2)(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, opt),
        jnp.asarray(x), jnp.asarray(y))
    tp, to, tl = tt.train_step_pp_adam(_tmesh(dims), tc, lr=1e-3, n_micro=2)(
        tt.params_from_numpy(params, "cpu"), tt.adam_state_from_numpy(opt, "cpu"),
        to_torch(x), to_torch(y))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert int(to["t"]) == int(jo["t"]) == 2
    _updates_close(params, jp, tp, 1e-3)
    for key in ("mu", "nu"):
        for a, (_, b) in zip(jax.tree_util.tree_leaves(jo[key]), tt._jax_paths(to[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-7)


def test_pp_stage1_micro1_equals_plain_steps_bitwise():
    _, tc = _cfgs()
    params = tt.init_params(5, tc, "cpu")
    x, y = (to_torch(a) for a in _data())
    mesh2, mesh3 = make_mesh((1, 1), ("dp", "sp"), device="cpu"), _tmesh((1, 1, 1))
    p1, l1 = tt.train_step(mesh2, tc)(params, x, y)
    ps, ls = tt.train_step_pp(mesh3, tc, n_micro=1)(tt.stack_layers(params), x, y)
    assert torch.equal(l1, ls) and _equal(p1, tt.unstack_layers(ps))
    opt = tt.init_adam_state(params)
    p1, o1, l1 = tt.train_step_adam(mesh2, tc)(params, opt, x, y)
    stacked = tt.stack_layers(params)
    ps, os_, ls = tt.train_step_pp_adam(mesh3, tc, n_micro=1)(stacked, tt.init_adam_state(stacked),
                                                              x, y)
    assert torch.equal(l1, ls) and _equal(p1, tt.unstack_layers(ps))
    assert _equal(o1["mu"], tt.unstack_layers({"layers": os_["mu"]["layers"]}))
    assert int(os_["t"]) == 1


@pytest.mark.parametrize("n_micro", [2, 4])
def test_stage_axis_is_bit_invariant(n_micro):
    _, tc = _cfgs()
    stacked = tt.stack_layers(tt.init_params(6, tc, "cpu"))
    x, y = (to_torch(a) for a in _data(2))
    a = tt.train_step_pp(_tmesh((1, 1, 1)), tc, n_micro=n_micro)(stacked, x, y)
    b = tt.train_step_pp(_tmesh((1, 1, 2)), tc, n_micro=n_micro)(stacked, x, y)
    assert torch.equal(a[1], b[1]) and _equal(a[0], b[0])


def test_pp_loss_decreases_3axis():
    _, tc = _cfgs()
    stacked = tt.stack_layers(tt.init_params(7, tc, "cpu"))
    opt = tt.init_adam_state(stacked)
    x, y = (to_torch(a) for a in _data(3))
    step = tt.train_step_pp_adam(_tmesh((2, 2, 2)), tc, lr=0.01, n_micro=2)
    losses = []
    for _ in range(4):
        stacked, opt, loss = step(stacked, opt, x, y)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_stack_unstack_and_specs_equal_jax():
    jc, tc = _cfgs()
    params = _np(jt.init_params(1, jc))
    stacked = tt.stack_layers(tt.params_from_numpy(params, "cpu"))
    want = _np(jt.stack_layers(params))
    for (_, a), b in zip(tt._jax_paths(stacked), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = tt.unstack_layers(stacked)
    assert _equal(back, tt.params_from_numpy(params, "cpu"))
    assert {k: tuple(v) for k, v in tt.param_spec_pp(tc)["layers"].items()} == \
        {k: tuple(v) for k, v in jt.param_spec_pp(jc)["layers"].items()}
    assert set(tt.adam_state_spec_pp(tc, "pp")) == {"mu", "nu", "t"}


def test_pp_rejects_indivisible_layers_and_batches():
    _, tc = _cfgs()
    odd = tt.TransformerConfig(**{**KW, "n_layers": 3})
    with pytest.raises(ValueError, match="n_layers"):
        tt.train_step_pp(_tmesh((1, 1, 2)), odd)
    x = torch.zeros(3, 16, 16)
    with pytest.raises(ValueError, match="microbatches"):
        tt.train_step_pp(_tmesh((1, 1, 1)), tc, n_micro=2)(
            tt.stack_layers(tt.init_params(0, tc, "cpu")), x, x)
