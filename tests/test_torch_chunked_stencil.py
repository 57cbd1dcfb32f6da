"""The port's checkpointed halo driver (``halo.driver.checkpointed_stencil``
over ``runtime.chunked``) against the JAX package's, at 64^2 on a 2x2 mesh
(stacked here, the virtual CPU mesh there) with the ``xla`` impl and
Jacobi weights, whose products by 0.25 are exact: the two drivers agree
bit for bit, as the existing ``distributed_stencil`` twins do. A run ended
with ``os._exit`` after its second save, in a child process, resumes here
bit-identically; a checkpoint written by the JAX driver resumes here to
the JAX package's uninterrupted answer; async checkpoints are
byte-identical to blocking ones; an elastic resume goes from 2x2 to 1x2.
Every comparison is of bits (no tolerance)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_twins import rand
from tpuscratch.halo.driver import checkpointed_stencil as jax_ckpt_stencil
from tpuscratch.runtime.mesh import make_mesh_2d as jax_mesh_2d
from tpuscratch_torch.ft import ChaosPlan, Fault, Preempted, RestartBudget, supervise
from tpuscratch_torch.halo.driver import checkpointed_stencil, distributed_stencil
from tpuscratch_torch.obs import Sink, goodput_report, load_events
from tpuscratch_torch.runtime import checkpoint
from tpuscratch_torch.runtime.mesh import make_mesh_2d

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, STEPS, EVERY = 64, 20, 5

CHILD = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tpuscratch_torch.halo.driver import checkpointed_stencil
from tpuscratch_torch.runtime.mesh import make_mesh_2d

class ExitAfterSecondSave:
    enabled = True
    saves = 0
    def emit(self, event, **fields):
        if event == "ckpt/save":
            ExitAfterSecondSave.saves += 1
            if ExitAfterSecondSave.saves == 2:
                os._exit(17)
    def emit_metrics(self, *a, **k): pass
    def flush(self): pass
    def close(self): pass

world = np.load(sys.argv[1])
checkpointed_stencil(world, int(sys.argv[3]), sys.argv[2], save_every=int(sys.argv[4]),
                     mesh=make_mesh_2d((2, 2), device="cpu"), sink=ExitAfterSecondSave())
"""


def _mesh(dims=(2, 2)):
    return make_mesh_2d(dims, device="cpu")


@pytest.fixture(scope="module")
def world():
    return rand((N, N), 41)


@pytest.fixture(scope="module")
def jax_answer(world, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax")
    return jax_ckpt_stencil(world, STEPS, str(d / "ck"), save_every=EVERY,
                            mesh=jax_mesh_2d((2, 2))), d / "ck"


def test_matches_the_jax_driver_bit_for_bit(world, jax_answer, tmp_path):
    out = checkpointed_stencil(world, STEPS, str(tmp_path / "ck"), save_every=EVERY, mesh=_mesh())
    assert np.array_equal(out, jax_answer[0])
    assert np.array_equal(out, distributed_stencil(world, STEPS, mesh=_mesh()))
    # the same checkpoint files, byte for byte, as the JAX driver's
    for step in checkpoint.steps(tmp_path / "ck"):
        for f in sorted((tmp_path / "ck" / f"step_{step:09d}").iterdir()):
            assert f.read_bytes() == (jax_answer[1] / f"step_{step:09d}" / f.name).read_bytes()


def test_a_run_ended_after_its_second_save_resumes_bit_identically(world, jax_answer, tmp_path):
    np.save(tmp_path / "world.npy", world)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path / "world.npy"),
                        str(tmp_path / "ck"), str(STEPS), str(EVERY)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 17, p.stderr
    assert checkpoint.latest_step(tmp_path / "ck") == 2 * EVERY
    out = checkpointed_stencil(world, STEPS, str(tmp_path / "ck"), save_every=EVERY, mesh=_mesh())
    assert np.array_equal(out, jax_answer[0])


def test_a_jax_checkpoint_resumes_here_to_the_jax_answer(world, tmp_path):
    d = str(tmp_path / "ck")
    jax_ckpt_stencil(world, 2 * EVERY, d, save_every=EVERY, mesh=jax_mesh_2d((2, 2)))
    assert checkpoint.latest_step(d) == 2 * EVERY
    out = checkpointed_stencil(world, STEPS, d, save_every=EVERY, mesh=_mesh())
    want = jax_ckpt_stencil(world, STEPS, str(tmp_path / "whole"), save_every=EVERY,
                            mesh=jax_mesh_2d((2, 2)))
    assert np.array_equal(out, want)


def test_async_checkpoints_are_byte_identical_to_blocking(world, tmp_path):
    outs = {}
    for mode in ("blocking", "async"):
        outs[mode] = checkpointed_stencil(world, STEPS, str(tmp_path / mode), save_every=EVERY,
                                          mesh=_mesh(), keep=STEPS // EVERY,
                                          async_ckpt=mode == "async")
    assert np.array_equal(outs["blocking"], outs["async"])
    steps = checkpoint.steps(tmp_path / "blocking")
    assert steps == checkpoint.steps(tmp_path / "async") == [5, 10, 15, 20]
    for step in steps:
        a, b = (tmp_path / m / f"step_{step:09d}" for m in ("blocking", "async"))
        assert sorted(f.name for f in a.iterdir()) == sorted(f.name for f in b.iterdir())
        for f in a.iterdir():
            assert f.read_bytes() == (b / f.name).read_bytes()


def test_elastic_resume_from_2x2_to_1x2(world, jax_answer, tmp_path):
    d = str(tmp_path / "ck")
    checkpointed_stencil(world, 2 * EVERY, d, save_every=EVERY, mesh=_mesh())
    with pytest.raises(ValueError, match="structure drifted"):
        checkpointed_stencil(world, STEPS, d, save_every=EVERY, mesh=_mesh((1, 2)))
    out = checkpointed_stencil(world, STEPS, d, save_every=EVERY, mesh=_mesh((1, 2)),
                               reshard=True)
    assert np.array_equal(out, jax_answer[0])


def test_refuses_to_return_an_over_stepped_state(world, tmp_path):
    d = str(tmp_path / "ck")
    checkpointed_stencil(world, 2 * EVERY, d, save_every=EVERY, mesh=_mesh())
    with pytest.raises(ValueError, match="beyond the requested"):
        checkpointed_stencil(world, EVERY, d, save_every=EVERY, mesh=_mesh())
    with pytest.raises(ValueError, match="save_every"):
        checkpointed_stencil(world, EVERY, d, save_every=0, mesh=_mesh())


@pytest.mark.parametrize("impl,halo", [("deep-pallas:4", (4, 4)), ("deep:4", (4, 4)),
                                       ("resident:8", (1, 1))])
def test_impl_depths_and_unrolls_chunk_like_the_whole_run(world, impl, halo, tmp_path):
    """``deep*:k`` sets a k x k halo, ``resident:U`` the unroll; 16-step
    chunks (multiples of k) give the whole run's bits (the plain versions
    on the CPU; on the card the kernels, chip_smoke phase 28)."""
    base = impl.partition(":")[0]
    out = checkpointed_stencil(world, 32, str(tmp_path / "ck"), save_every=16, impl=impl,
                               mesh=_mesh((1, 1)))
    assert np.array_equal(out, distributed_stencil(world, 32, mesh=_mesh((1, 1)), halo=halo,
                                                   impl=base))
    with pytest.raises(ValueError, match="halo"):
        checkpointed_stencil(world, 32, str(tmp_path / "x"), impl="deep:4", halo=(2, 2),
                             mesh=_mesh((1, 1)))


def test_preempted_and_faulted_run_under_supervise(world, jax_answer, tmp_path):
    """A transient ``comm/halo_chunk`` fault and a preemption after the
    step-10 save, restarted by ``supervise``: the JAX answer, and a JSONL
    stream whose goodput buckets sum to its wall."""
    path = tmp_path / "obs.jsonl"
    plan = ChaosPlan(0, [Fault("comm/halo_chunk", at=(5,)),
                         Fault("halo/preempt", at=(10,), kind="preempt")])
    with Sink(str(path)) as sink:
        out = supervise(lambda: checkpointed_stencil(world, STEPS, str(tmp_path / "ck"),
                                                     save_every=EVERY, mesh=_mesh(),
                                                     sink=sink, chaos=plan),
                        budget=RestartBudget(max_restarts=3), sink=sink)
    assert np.array_equal(out, jax_answer[0])
    assert plan.stats() == {"comm/halo_chunk": 1, "halo/preempt": 1}
    events = load_events([str(path)])
    kinds = [e["event"] for e in events]
    assert kinds.count("ft/restart") == 2 and "halo/chunk" in kinds and "ckpt/save" in kinds
    rep = goodput_report(events)
    rep.check()
    assert rep.buckets["restart"] >= 0 and rep.wall_s > 0
    with pytest.raises(Preempted):
        checkpointed_stencil(world, STEPS, str(tmp_path / "p"), save_every=EVERY, mesh=_mesh(),
                             chaos=ChaosPlan(0, [Fault("halo/preempt", at=(5,),
                                                       kind="preempt")]))
