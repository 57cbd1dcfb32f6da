"""The port's routed MoE forward (``tpuscratch_torch.parallel.expert``)
against the JAX package's: the routing plans, and ``expert_parallel_ffn``
(sparse and einsum) on dp = 1 and dp = 2 meshes, with the capacity binding
in one case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import rand, to_torch
from tpuscratch.comm import run_spmd as jax_run_spmd
from tpuscratch.parallel import expert as je
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.parallel import expert as te
from tpuscratch_torch.runtime.mesh import make_mesh

ATOL = 1e-6  # f32 contractions summed in another order, on O(1) values


@pytest.mark.parametrize("cap,k", [(3, 1), (2, 2), (16, 1)])
def test_routing_plans_equal(cap, k):
    logits = rand((12, 4), 1)
    jd, td = je.topk_routing(jnp.asarray(logits), cap, k), te.topk_routing(to_torch(logits), cap, k)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
    js_, ts_ = (je.sparse_topk_routing(jnp.asarray(logits), cap, k),
                te.sparse_topk_routing(to_torch(logits), cap, k))
    for name in js_._fields:
        np.testing.assert_allclose(getattr(ts_, name).numpy(), np.asarray(getattr(js_, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("impl", ["sparse", "einsum"])
@pytest.mark.parametrize("factor", [4.0, 1.0])  # 1.0 < n_experts: capacity binds
def test_expert_parallel_ffn(dp, impl, factor):
    T, D, F, E = 8, 16, 24, 4
    x, gate = rand((dp * T, D), 2), rand((D, E), 3)
    w_in, w_out = rand((E, D, F), 4) / 4, rand((E, F, D), 5) / 5
    specs = (P("dp"), P(), P("dp"), P("dp"))

    def jfn(*a):
        return je.expert_parallel_ffn(*a, "dp", capacity_factor=factor, impl=impl)[0]

    def tfn(*a):
        return te.expert_parallel_ffn(*a, "dp", capacity_factor=factor, impl=impl)[0]

    mesh = jax_mesh((dp,), ("dp",), jax.devices()[:dp])
    want = jax_run_spmd(mesh, jfn, (JP("dp"), JP(), JP("dp"), JP("dp")), JP("dp"))(
        *map(jnp.asarray, (x, gate, w_in, w_out)))
    got = run_spmd(make_mesh((dp,), ("dp",), device="cpu"), tfn, specs, P("dp"))(
        *map(to_torch, (x, gate, w_in, w_out)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_expert_refusals():
    with pytest.raises(ValueError, match="impl"):
        te.expert_parallel_ffn(torch.zeros(1, 1, 4, 8), None, None, None, "dp", impl="dense")
    assert te.capacity(8, 4, 1.25) == 2 and te.capacity(1, 8) == 1
