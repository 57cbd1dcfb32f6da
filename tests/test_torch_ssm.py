"""The port's sequence-parallel SSM scan and block
(``tpuscratch_torch.parallel.ssm``, ``tpuscratch_torch.models.ssm``)
against the JAX package's, on 1D "seq" meshes of 1, 2, 4 and 8 ranks;
twins of tests/test_ssm.py. The block's weights are the JAX package's
(``jax.random`` draws, carried with ``params_from_numpy``).

Tolerances: the local scan follows ``lax.associative_scan``'s pairing, so
against JAX it differs only where XLA:CPU contracts ``b2 + a2 * b1`` into
an FMA: 1e-6 relative plus 1e-6. The distributed scan, the block and their
gradients: 1e-5 relative plus 1e-5 against JAX (the block's matmuls sum in
another BLAS order); against the float64 sequential recurrence 1e-4
absolute, as the JAX tests hold theirs. Within the port the sharded block
equals the local oracle to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import to_torch
from tpuscratch.comm import run_spmd as jax_run_spmd
from tpuscratch.models import ssm as jm
from tpuscratch.parallel import ssm as jssm
from tpuscratch.runtime.mesh import make_mesh_1d as jax_mesh_1d
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.models import ssm as tm
from tpuscratch_torch.models.transformer import params_from_numpy
from tpuscratch_torch.parallel import ssm as tssm
from tpuscratch_torch.runtime.mesh import make_mesh_1d

CFG = dict(d_model=8, d_state=16)


def _ab(T, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 0.99, (T, D)).astype(np.float32),
            rng.standard_normal((T, D)).astype(np.float32))


def _recurrence(a, b):
    h, out = np.zeros(a.shape[1:]), []
    for t in range(a.shape[0]):
        h = a[t].astype(np.float64) * h + b[t]
        out.append(h)
    return np.stack(out)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree_util.tree_map(np.asarray, jm.init_params(0, jm.SSMConfig(**CFG)))


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
def test_local_scan_matches_jax(T):
    a, b = _ab(T, 5, seed=T)
    (ja, jb), (ga, gb) = jax.jit(jssm.local_scan)(jnp.asarray(a), jnp.asarray(b))
    (ta, tb), (sa, sb) = tssm.local_scan(to_torch(a), to_torch(b))
    for got, want in ((ta, ja), (tb, jb), (sa, ga), (sb, gb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), _recurrence(a, b), atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ssm_scan_matches_jax_and_the_recurrence(n):
    a, b = _ab(8 * n, 5)
    want = np.asarray(jax_run_spmd(jax_mesh_1d("seq", n), lambda x, y: jssm.ssm_scan(x, y, "seq"),
                                   (JP("seq"), JP("seq")), JP("seq"))(jnp.asarray(a),
                                                                      jnp.asarray(b)))
    got = run_spmd(make_mesh_1d("seq", n, device="cpu"), lambda x, y: tssm.ssm_scan(x, y, "seq"),
                   (P("seq"), P("seq")), P("seq"))(to_torch(a), to_torch(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _recurrence(a, b), atol=1e-4)
    with pytest.raises(ValueError, match="!="):
        run_spmd(make_mesh_1d("seq", n, device="cpu"), lambda x, y: tssm.ssm_scan(x, y, "seq"),
                 (P("seq"), P("seq")), P("seq"))(to_torch(a), to_torch(b[:, :4]))


def test_scan_gradient_matches_jax():
    a, b = _ab(16, 4, seed=1)
    sharded = jax.shard_map(lambda x, y: jssm.ssm_scan(x, y, "seq"), mesh=jax_mesh_1d("seq", 4),
                            in_specs=(JP("seq"), JP("seq")), out_specs=JP("seq"), check_vma=False)
    want = jax.jit(jax.grad(lambda x, y: (sharded(x, y) ** 2).sum(), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = to_torch(a).requires_grad_(), to_torch(b).requires_grad_()
    prog = run_spmd(make_mesh_1d("seq", 4, device="cpu"), lambda x, y: tssm.ssm_scan(x, y, "seq"),
                    (P("seq"), P("seq")), P("seq"))
    (prog(ta, tb) ** 2).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 8])
def test_block_matches_jax_and_the_local_oracle(n):
    params = _jax_params()
    x = np.random.default_rng(2).standard_normal((32, CFG["d_model"])).astype(np.float32)
    want = np.asarray(jax_run_spmd(jax_mesh_1d("seq", n), lambda xx: jm.ssm_block(
        jax.tree_util.tree_map(jnp.asarray, params), xx, "seq"), JP("seq"), JP("seq"))(
        jnp.asarray(x)))
    tp = params_from_numpy(params, "cpu")
    got = run_spmd(make_mesh_1d("seq", n, device="cpu"), lambda p, xx: tm.ssm_block(p, xx, "seq"),
                   (P(), P("seq")), P("seq"))(tp, to_torch(x))
    local = tm.ssm_block(tp, to_torch(x), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), local.numpy(), rtol=1e-5, atol=1e-5)


def test_block_gradients_match_jax():
    params = _jax_params()
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal((16, CFG["d_model"])).astype(np.float32) for _ in range(2))
    fwd = jax.shard_map(lambda p, xx: jm.ssm_block(p, xx, "seq"), mesh=jax_mesh_1d("seq", 4),
                        in_specs=(JP(), JP("seq")), out_specs=JP("seq"), check_vma=False)
    want = jax.jit(jax.grad(lambda p: ((fwd(p, jnp.asarray(x)) - y) ** 2).mean()))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(params, "cpu").items()}
    prog = run_spmd(make_mesh_1d("seq", 4, device="cpu"),
                    lambda p, xx: tm.ssm_block(p, xx, "seq"), (P(), P("seq")), P("seq"))
    loss = ((prog(tp, to_torch(x)) - to_torch(y)) ** 2).mean()
    loss.backward()
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    with torch.no_grad():
        stepped = {k: v - 0.1 * v.grad for k, v in tp.items()}
        assert float(((prog(stepped, to_torch(x)) - to_torch(y)) ** 2).mean()) < float(loss)


def test_init_params_layout_equals_jax():
    cfg = tm.SSMConfig(**CFG)
    ours = tm.init_params(0, cfg, "cpu")
    theirs = _jax_params()
    assert set(ours) == set(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape and ours[k].dtype == torch.float32
    assert torch.equal(ours["c_a"], torch.full((16,), 2.0))
    assert torch.equal(tm.init_params(0, cfg, "cpu")["w_a"], ours["w_a"])
    assert tm.SSMConfig() == tm.SSMConfig(**vars(jm.SSMConfig()))
