"""The port's GPipe schedule (``tpuscratch_torch.parallel.pipeline``)
against the JAX package's (``tpuscratch.parallel.pipeline``): ``gpipe_scan``
and ``pipeline_apply`` on (1, 1, n) dp x sp x stage meshes, n = 1, 2, 4, for
M = 1, 3, 4 microbatches, the aux term's bubble masking, gradients through
the schedule, ``ShardingPlan.pipeline_program`` and ``bubble_fraction``;
twins of tests/test_parallel.py's TestPipeline and TestPipelineGrad.

The stage is tanh(x @ W_s + b_s) on 6 features (4 rows a microbatch),
stacked over the stage axis. Tolerances against JAX: outputs 1e-6
absolute, the aux sum 1e-6 relative, gradients 1e-5 (the same products,
summed by another BLAS). Against the sequential stage chain, as the JAX
tests hold theirs: 1e-5 relative plus 1e-6.
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
from tpuscratch.parallel import pipeline as jpipe
from tpuscratch.parallel.plan import ShardingPlan as JaxPlan
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.parallel import pipeline as tpipe
from tpuscratch_torch.parallel.plan import ShardingPlan
from tpuscratch_torch.runtime.mesh import make_mesh

F, ROWS = 6, 4
AXES = ("dp", "sp", "stage")


def _inputs(n, M, seed=7):
    rng = np.random.default_rng(seed)
    Ws = rng.standard_normal((n, F, F)).astype(np.float32) * 0.3
    bs = rng.standard_normal((n, F)).astype(np.float32) * 0.1
    micro = rng.standard_normal((M, ROWS, F)).astype(np.float32)
    return Ws, bs, micro


def _sequential(Ws, bs, micro):
    x = micro.astype(np.float64)
    for W, b in zip(Ws, bs):
        x = np.tanh(x @ W + b)
    return x


def _jstage(W, b, x):
    return jnp.tanh(x @ W[0] + b[0])


def _tstage(W, b, x):
    # stacked: W (*mesh, 1, F, F), b (*mesh, 1, F), x (*mesh, ROWS, F)
    return torch.tanh(x @ W[..., 0, :, :] + b[..., 0, None, :])


@functools.lru_cache(maxsize=None)
def _jax_out(n, M):
    """The JAX package's pipeline_apply and gpipe_scan (aux = the sum of a
    stage's input, nonzero on bubble ticks too) on a (1, 1, n) mesh."""
    Ws, bs, micro = _inputs(n, M)
    mesh = jax_mesh((1, 1, n), AXES, jax.devices()[:n])
    out = jax_run_spmd(mesh, lambda W, b, m: jpipe.pipeline_apply(
        lambda p, x: _jstage(*p, x), (W, b), m, "stage"), (JP("stage"), JP("stage"), JP()), JP())
    scan = jax_run_spmd(mesh, lambda W, b, m: jpipe.gpipe_scan(
        lambda x: (_jstage(W, b, x), jnp.sum(x)), m, "stage"),
        (JP("stage"), JP("stage"), JP()), (JP(), JP()))
    args = [jnp.asarray(a) for a in (Ws, bs, micro)]
    got_out = np.asarray(out(*args))
    scan_out, aux = scan(*args)
    return got_out, np.asarray(scan_out), float(aux)


def _port(n, M):
    Ws, bs, micro = _inputs(n, M)
    mesh = make_mesh((1, 1, n), AXES, device="cpu")
    out = run_spmd(mesh, lambda W, b, m: tpipe.pipeline_apply(
        lambda p, x: _tstage(*p, x), (W, b), m, "stage"), (P("stage"), P("stage"), P()), P())
    scan = run_spmd(mesh, lambda W, b, m: tpipe.gpipe_scan(
        lambda x: (_tstage(W, b, x), x.sum(dim=(-2, -1))), m, "stage"),
        (P("stage"), P("stage"), P()), (P(), P()))
    args = [to_torch(a) for a in (Ws, bs, micro)]
    scan_out, aux = scan(*args)
    return out(*args).numpy(), scan_out.numpy(), float(aux)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("M", [1, 3, 4])
def test_pipeline_matches_jax_and_the_sequential_chain(n, M):
    want_out, want_scan, want_aux = _jax_out(n, M)
    got_out, got_scan, got_aux = _port(n, M)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_scan, want_scan, rtol=0, atol=1e-6)
    assert abs(got_aux - want_aux) <= 1e-6 * max(1.0, abs(want_aux))
    Ws, bs, micro = _inputs(n, M)
    np.testing.assert_allclose(got_out, _sequential(Ws, bs, micro), rtol=1e-5, atol=1e-6)


def test_aux_masks_the_bubble_ticks():
    # a stage whose aux is 1 on every tick: only the n * M valid ones count
    n, M = 4, 3
    Ws, bs, micro = _inputs(n, M)
    mesh = make_mesh((1, 1, n), AXES, device="cpu")
    aux = run_spmd(mesh, lambda W, b, m: tpipe.gpipe_scan(
        lambda x: (_tstage(W, b, x), torch.ones(x.shape[:3])), m, "stage")[1],
        (P("stage"), P("stage"), P()), P())(*(to_torch(a) for a in (Ws, bs, micro)))
    assert float(aux) == n * M


def test_gradient_through_the_schedule_matches_jax():
    n, M = 4, 5
    Ws, bs, micro = _inputs(n, M, seed=23)
    mesh = jax_mesh((1, 1, n), AXES, jax.devices()[:n])
    pipe = jax.shard_map(lambda W, b, m: jpipe.pipeline_apply(
        lambda p, x: _jstage(*p, x), (W, b), m, "stage"), mesh=mesh,
        in_specs=(JP("stage"), JP("stage"), JP()), out_specs=JP(), check_vma=False)
    want = jax.jit(jax.grad(lambda W, b, m: (pipe(W, b, m) ** 2).sum(), argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (Ws, bs, micro)))
    tmesh = make_mesh((1, 1, n), AXES, device="cpu")
    prog = run_spmd(tmesh, lambda W, b, m: tpipe.pipeline_apply(
        lambda p, x: _tstage(*p, x), (W, b), m, "stage"), (P("stage"), P("stage"), P()), P())
    args = [to_torch(a).requires_grad_() for a in (Ws, bs, micro)]
    (prog(*args) ** 2).sum().backward()
    for a, w, name in zip(args, want, ("dW", "db", "dmicro")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_plan_pipeline_program_matches_jax():
    n, M = 2, 4
    Ws, bs, micro = _inputs(n, M)
    plan = JaxPlan(jax_mesh((1, 1, n), AXES, jax.devices()[:n]), pp="stage", n_micro=M)
    want = np.asarray(plan.pipeline_program(lambda W, x: jnp.tanh(x @ W[0]))(
        jnp.asarray(Ws), jnp.asarray(micro)))
    tplan = ShardingPlan(make_mesh((1, 1, n), AXES, device="cpu"), pp="stage", n_micro=M)
    got = tplan.pipeline_program(lambda W, x: torch.tanh(x @ W[..., 0, :, :]))(
        to_torch(Ws), to_torch(micro))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="pp axis"):
        ShardingPlan(make_mesh((1, 1, n), AXES, device="cpu")).pipeline_program(None)


def test_bubble_fraction_equals_jax():
    for n, M in ((1, 4), (4, 1), (8, 56), (2, 32)):
        assert tpipe.bubble_fraction(n, M) == jpipe.bubble_fraction(n, M)
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            tpipe.bubble_fraction(*bad)


def test_package_exports_the_jax_names():
    import tpuscratch.models as jmodels
    import tpuscratch.parallel as jparallel
    import tpuscratch_torch.models as tmodels
    import tpuscratch_torch.parallel as tparallel

    for name in ("bubble_fraction", "gpipe_scan", "pipeline_apply", "ShardingPlan", "ssm_scan"):
        assert hasattr(jparallel, name) and hasattr(tparallel, name), name
    for name in ("SSMConfig", "ssm_block", "init_ssm_params"):
        assert hasattr(jmodels, name) and hasattr(tmodels, name), name


def test_bubble_bench_and_ablation_rows_run_on_the_cpu(monkeypatch):
    from tpuscratch_torch.bench import train_ablation as ta
    from tpuscratch_torch.bench.pipeline_bench import bench_pipeline_bubble
    from tpuscratch_torch.models.transformer import TransformerConfig

    r = bench_pipeline_bubble(n_micro=4, feature=8, iters=2, device="cpu")
    assert r.proxy and r.n_stages == 4 and r.analytic_bubble == tpipe.bubble_fraction(4, 4)
    assert r.wall_s > 0 and "stacked-mesh proxy" in r.summary()
    # a 1-axis stage mesh gains the trivial dp and sp axes
    r = bench_pipeline_bubble(n_micro=2, feature=8, iters=1,
                              mesh=make_mesh((2,), ("stage",), device="cpu"))
    assert r.n_stages == 2
    monkeypatch.setattr(ta, "B", 2)
    monkeypatch.setattr(ta, "S", 8)
    monkeypatch.setattr(ta, "STEPS", 2)
    small = TransformerConfig(d_model=16, n_heads=2, n_experts=2, d_ff=32, n_layers=2)
    assert ta.fwd_only("fwd", small, device="cpu") > 0
    assert ta.run("sgd", small, device="cpu") > 0
    r = ta.pp_row_bench(small, batch=2, seq=8, steps=1, n_micro=2, iters=1, fence="block",
                        device="cpu")
    assert r.items == 2 * 8 and "M=2" in r.name
