"""The port's solver runner (``tpuscratch_torch.solvers.runner``) against the
JAX package's: ``checkpointed_mg3d_solve`` at 32^3 a rank on 1x1x1 and
2x1x1 (stacked here, the CPU mesh there), 3 levels (the JAX side's compile
halves against the default 5), 4 cycles a chunk: the same cycle count and
x within 1e-5 of max|x| (XLA:CPU contracts the smoothers' products and
sums into FMAs and divides by 6 as a product by 1/6, so level operations
are twins within rounding, not bit for bit, as in
``test_torch_multigrid3d.py``); a solve resumed from the JAX runner's
checkpoint stays within the same 1e-5 of the port's own. A preempted,
supervised solve continues bit-identically to the port's uninterrupted
one, with ``rbgs`` and with ``jacobi-stream`` (the streamed kernel's plain
version on the CPU), and async saves write the blocking saves' bytes."""

import shutil

import jax
import numpy as np
import pytest
import torch

from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.solvers.runner import checkpointed_mg3d_solve as jax_solve
from tpuscratch_torch.ft import ChaosPlan, Fault, RestartBudget
from tpuscratch_torch.obs import MetricsRegistry, Sink, goodput_report, load_events
from tpuscratch_torch.runtime import checkpoint
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.solvers.runner import (SolveReport, checkpointed_mg3d_solve,
                                             mg3d_solve_program, supervised_mg3d_solve)

torch.set_num_threads(1)

AXES = ("z", "row", "col")
KW = dict(levels=3, chunk_cycles=4, tol=1e-5)


def _b(dims, n=32):
    b = np.random.default_rng(7).standard_normal((n * dims[0], n * dims[1], n * dims[2]))
    b = b.astype(np.float32)
    return b - b.mean()


def _mesh(dims):
    return make_mesh(dims, AXES, device="cpu")


@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1)])
def test_against_the_jax_runner(dims, tmp_path):
    b = _b(dims)
    xj, rj = jax_solve(b, str(tmp_path / "j"), mesh=jax_mesh(dims, AXES, jax.devices()[:dims[0]]),
                       **KW)
    xt, rt = checkpointed_mg3d_solve(b, str(tmp_path / "t"), mesh=_mesh(dims), **KW)
    assert rt.cycles == rj.cycles and rt.chunks == rj.chunks and rt.converged and rj.converged
    assert float(np.abs(xt - xj).max()) <= 1e-5 * float(np.abs(xj).max())
    assert abs(rt.relres - rj.relres) <= 0.05 * rj.relres
    assert checkpoint.steps(tmp_path / "t") == checkpoint.steps(tmp_path / "j")
    if dims == (1, 1, 1):
        # the JAX runner's step-4 checkpoint resumes here as the port's own does
        shutil.rmtree(tmp_path / "j" / f"step_{rj.cycles:09d}")
        xr, rr = checkpointed_mg3d_solve(b, str(tmp_path / "j"), mesh=_mesh(dims), **KW)
        assert rr.resumed_at == 4 and rr.cycles == rt.cycles
        assert float(np.abs(xr - xt).max()) <= 1e-5 * float(np.abs(xt).max())


@pytest.mark.parametrize("smoother", ["rbgs", "jacobi-stream"])
def test_preempted_solve_is_bit_identical(smoother, tmp_path):
    b = _b((1, 1, 1))
    kw = dict(mesh=_mesh((1, 1, 1)), chunk_cycles=3, smoother=smoother)
    x, rep = checkpointed_mg3d_solve(b, str(tmp_path / "a"), **kw)
    assert rep.converged and rep.chunks == -(-rep.cycles // 3)
    metrics = MetricsRegistry()
    path = tmp_path / "obs.jsonl"
    plan = ChaosPlan(0, [Fault("solver/preempt", at=(6,), kind="preempt"),
                         Fault("comm/solver_chunk", at=(3,))])
    with Sink(str(path)) as sink:
        xs, rs = supervised_mg3d_solve(b, str(tmp_path / "s"), sink=sink, metrics=metrics,
                                       chaos=plan, budget=RestartBudget(max_restarts=3), **kw)
    assert np.array_equal(x, xs) and rs.cycles == rep.cycles and rs.resumed_at == 6
    assert metrics.counter("ft/restarts").value == 2
    events = load_events([str(path)])
    assert sum(e["event"] == "solver/chunk" for e in events) >= rep.chunks
    goodput_report(events).check()
    # async saves: the same answer and the same checkpoint bytes
    xa, _ = checkpointed_mg3d_solve(b, str(tmp_path / "async"), async_ckpt=True, **kw)
    assert np.array_equal(x, xa)
    last = f"step_{rep.cycles:09d}"
    for f in (tmp_path / "a" / last).iterdir():
        assert f.read_bytes() == (tmp_path / "async" / last / f.name).read_bytes()


def test_elastic_resume_and_refusals(tmp_path):
    b = _b((2, 1, 1))
    d = str(tmp_path / "ck")
    prog = mg3d_solve_program(b, d, mesh=_mesh((2, 1, 1)), max_cycles=4, **KW)
    prog.run()
    assert prog.pos == 4
    with pytest.raises(ValueError, match="structure drifted"):
        checkpointed_mg3d_solve(b, d, mesh=_mesh((1, 1, 1)), **KW)
    x, rep = checkpointed_mg3d_solve(b, d, mesh=_mesh((1, 1, 1)), reshard=True, **KW)
    assert isinstance(rep, SolveReport) and rep.resumed_at == 4 and rep.converged
    with pytest.raises(ValueError, match="beyond"):
        checkpointed_mg3d_solve(b, d, mesh=_mesh((1, 1, 1)), max_cycles=2, **KW)
    with pytest.raises(ValueError, match="chunk_cycles"):
        checkpointed_mg3d_solve(b, d, mesh=_mesh((1, 1, 1)), chunk_cycles=0, levels=3)
