"""The port's checkpointed trainer (``tpuscratch_torch.models.trainer``)
against the JAX package's ``train``: d_model 64, 2 layers, 2 experts, 6
steps, a save every 3, on a 2x1 ("dp", "sp") mesh (stacked here, the CPU
mesh there), with SGD, Adam and ZeRO Adam, from the same seed (the same
numpy draws: parameters and the per-step batches).

Tolerances: the losses at the save points within 1e-5 relative (the train
twins' f32 loss tolerance); SGD parameters' movement over lr within the
train twins' update tolerance (1e-4 relative, 1e-5 absolute). Adam divides
each update by the root of its second moment, which magnifies the
one-step f32 differences (sums in other orders) where that moment is
small, and six steps compound them: its movement over lr is held within
1e-3 of the largest movement (the twins' ``rel_to_max`` form, at a
twentieth of its bf16 bound). The port's own replays — a NaN rolled back
by the guard, a preemption under ``supervise_train``, async saves, a
resume from the JAX trainer's checkpoint — are held to bits."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuscratch.models import transformer as jt
from tpuscratch.models.trainer import train as jax_train
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch.ft import (ChaosPlan, Fault, GuardFailure, GuardPolicy, RestartBudget,
                                 supervise_train, supervise_train_elastic)
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.models.trainer import TrainReport, synthetic_batch, train, train_program
from tpuscratch_torch.obs import MetricsRegistry, Sink, goodput_report, load_events
from tpuscratch_torch.parallel.plan import ShardingPlan
from tpuscratch_torch.runtime import checkpoint
from tpuscratch_torch.runtime.errors import CommError
from tpuscratch_torch.runtime.mesh import make_mesh

torch.set_num_threads(1)

KW = dict(d_model=64, n_heads=2, n_experts=2, d_ff=96, n_layers=2, capacity_factor=2.0)
STEPS, EVERY = 6, 3
OPTS = {"sgd": dict(optimizer="sgd", lr=0.05), "adam": dict(optimizer="adam", lr=1e-3),
        "zero": dict(optimizer="adam", zero=True, lr=1e-3)}


def _tcfg():
    return tt.TransformerConfig(**KW)


def _mesh(dims=(2, 1)):
    return make_mesh(dims, ("dp", "sp"), device="cpu")


def _compare_updates(p0, jnew, tnew, lr, rtol, atol, rel_to_max=False):
    """``test_torch_train``'s update check, with every tree flattened in
    the JAX package's order: (new - old) / lr of both against each other,
    each element allowed two f32 spacings of its parameter over lr."""
    flat = lambda t: [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)  # noqa: E731
                      for x in checkpoint.tree_flatten(t)[0]]
    for w, a, b in zip(flat(p0), flat(jnew), flat(tnew), strict=True):
        ja, tb = (a - w) / lr, (b - w) / lr
        tol = atol * max(1.0, float(np.abs(ja).max())) if rel_to_max else atol
        seen = 2 * np.spacing(np.abs(w).astype(np.float32)) / lr
        bad = np.abs(tb - ja) > tol + rtol * np.abs(ja) + seen
        assert not bad.any(), (f"{bad.sum()} of {bad.size} updates differ, worst "
                               f"{np.abs(tb - ja).max():.3e}")


def _same(a, b) -> bool:
    la, lb = tt._jax_paths(a), tt._jax_paths(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer's 6-step runs, one an optimizer, and its 3-step
    checkpoint directory for the SGD resume."""
    d = tmp_path_factory.mktemp("jax")
    mesh = jax_mesh((2, 1), ("dp", "sp"), jax.devices()[:2])
    runs = {name: jax_train(mesh, jt.TransformerConfig(**KW), STEPS, str(d / name),
                            save_every=EVERY, **kw) for name, kw in OPTS.items()}
    jax_train(mesh, jt.TransformerConfig(**KW), EVERY, str(d / "half"), save_every=EVERY,
              **OPTS["sgd"])
    return runs, d / "half"


@pytest.mark.parametrize("name", list(OPTS))
def test_train_against_jax(jax_runs, name, tmp_path):
    jp, jrep = jax_runs[0][name]
    tp, trep = train(_mesh(), _tcfg(), STEPS, str(tmp_path / "ck"), save_every=EVERY,
                     **OPTS[name])
    assert trep.steps_run == jrep.steps_run == STEPS and trep.final_step == STEPS
    assert len(trep.losses) == len(jrep.losses) == STEPS // EVERY
    for a, b in zip(trep.losses, jrep.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    p0 = jax.tree.map(np.asarray, jt.init_params(0, jt.TransformerConfig(**KW)))
    lr = OPTS[name]["lr"]
    if name == "sgd":
        _compare_updates(p0, jp, tp, lr, rtol=1e-4, atol=1e-5)
    else:
        _compare_updates(p0, jp, tp, lr, rtol=0.0, atol=1e-3, rel_to_max=True)


def test_a_jax_checkpoint_resumes_in_the_port(jax_runs, tmp_path):
    """The JAX trainer's step-3 checkpoint, resumed here for steps 4-6:
    bit-identical to the port's own resume of its own step-3 checkpoint
    (same files, same replay), within the twins' tolerance of the JAX run."""
    _, half = jax_runs
    jp, _ = jax_runs[0]["sgd"]
    import shutil

    shutil.copytree(half, tmp_path / "from_jax")
    tp, rep = train(_mesh(), _tcfg(), STEPS, str(tmp_path / "from_jax"), save_every=EVERY,
                    **OPTS["sgd"])
    assert rep.steps_run == EVERY and rep.final_step == STEPS
    p0 = jax.tree.map(np.asarray, jt.init_params(0, jt.TransformerConfig(**KW)))
    _compare_updates(p0, jp, tp, OPTS["sgd"]["lr"], rtol=1e-4, atol=1e-5)
    mine = str(tmp_path / "mine")
    train(_mesh(), _tcfg(), EVERY, mine, save_every=EVERY, **OPTS["sgd"])
    restored, _, _ = checkpoint.restore(mine, tt.init_params(0, _tcfg(), "cpu"))
    from_jax, _, _ = checkpoint.restore(half, tt.init_params(0, _tcfg(), "cpu"))
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(tt._jax_paths(restored), tt._jax_paths(from_jax))) < 1e-6


@pytest.mark.parametrize("name", ["sgd", "zero"])
def test_nan_rollback_and_preemption_are_bit_identical(name, tmp_path):
    mesh, cfg = _mesh(), _tcfg()
    kw = dict(save_every=EVERY, seed=3, **OPTS[name])
    clean, _ = train(mesh, cfg, STEPS, str(tmp_path / "clean"), **kw)
    path = tmp_path / "obs.jsonl"
    plan = ChaosPlan(0, [Fault("train/grad", at=(4,), kind="nan")])
    with Sink(str(path)) as sink:
        healed, rep = train(mesh, cfg, STEPS, str(tmp_path / "nan"), chaos=plan, obs=sink,
                            guard=GuardPolicy(max_skips=0, max_rollbacks=1), **kw)
    assert rep.skipped == 1 and rep.rollbacks == 1 and _same(healed, clean)
    events = load_events([str(path)])
    kinds = {e["event"] for e in events}
    assert {"ft/fault", "ft/rollback", "ft/guard", "train/chunk", "ckpt/save"} <= kinds
    # one step build a run, the rollback replay included (the JAX count is
    # its trace count, which its own CPU test finds at 2)
    assert [e["compiles"] for e in events if e["event"] == "train/run"] == [1]
    goodput_report(events).check()
    metrics = MetricsRegistry()
    plan2 = ChaosPlan(0, [Fault("train/preempt", at=(EVERY,), kind="preempt")])
    resumed, rep = supervise_train(mesh, cfg, STEPS, str(tmp_path / "pre"), chaos=plan2,
                                   metrics=metrics, **kw)
    assert metrics.counter("ft/restarts").value == 1 and rep.steps_run == EVERY
    assert _same(resumed, clean)
    with pytest.raises(GuardFailure):
        train(mesh, cfg, STEPS, str(tmp_path / "poison"),
              chaos=ChaosPlan(0, [Fault("train/grad", at=(4,), kind="nan", times=None)]),
              guard=GuardPolicy(max_skips=0, max_rollbacks=1), **kw)


def test_async_saves_are_bit_identical_to_blocking(tmp_path):
    mesh, cfg = _mesh(), _tcfg()
    outs = {}
    for mode in (False, True):
        outs[mode] = train(mesh, cfg, STEPS, str(tmp_path / str(mode)), save_every=EVERY,
                           keep=5, async_ckpt=mode, **OPTS["zero"])[0]
    assert _same(outs[False], outs[True])
    for step in (EVERY, STEPS):
        a, b = (tmp_path / str(m) / f"step_{step:09d}" for m in (False, True))
        for f in a.iterdir():
            assert f.read_bytes() == (b / f.name).read_bytes()


def test_resume_checks_and_elastic_zero_resume(tmp_path):
    mesh, cfg = _mesh(), _tcfg()
    d = str(tmp_path / "ck")
    train(mesh, cfg, EVERY, d, save_every=EVERY, **OPTS["zero"])
    for bad, match in ((dict(OPTS["zero"], lr=2e-3), "lr"),
                       (dict(OPTS["zero"], optimizer="sgd", zero=False), "optimizer")):
        with pytest.raises(ValueError, match=match):
            train(mesh, cfg, STEPS, d, save_every=EVERY, **bad)
    with pytest.raises(ValueError, match="cfg"):
        train(mesh, dataclasses.replace(cfg, d_ff=64), STEPS, d, save_every=EVERY,
              **OPTS["zero"])
    with pytest.raises(ValueError, match="beyond"):
        train(mesh, cfg, 1, d, save_every=EVERY, **OPTS["zero"])
    one = _mesh((1, 1))
    with pytest.raises(CommError, match="reshard=True"):
        train(one, cfg, STEPS, d, save_every=EVERY, batch=4, **OPTS["zero"])
    # elastic: 2 stacked dp ranks -> 1, the moments regrouped; the same
    # trajectory as the 1-rank run resumed from a 1-rank checkpoint of the
    # same state is not claimed (sums over other groupings), only that it
    # runs to the end from the regrouped state and replays bit for bit
    p1, rep = train(one, cfg, STEPS, d, save_every=EVERY, batch=4, reshard=True,
                    **OPTS["zero"])
    assert rep.final_step == STEPS and rep.steps_run == EVERY
    d2 = str(tmp_path / "ck2")
    train(mesh, cfg, EVERY, d2, save_every=EVERY, **OPTS["zero"])
    p2, _ = train(one, cfg, STEPS, d2, save_every=EVERY, batch=4, reshard=True, **OPTS["zero"])
    assert _same(p1, p2)


@pytest.mark.parametrize("key", ["plan", "optimizer", "accum_steps"])
def test_resume_refuses_a_checkpoint_without_a_metadata_key(key, tmp_path):
    """Both packages write every metadata key a resume checks; a checkpoint
    that lacks one is a mismatch, refused before any leaf is loaded."""
    import json

    d = tmp_path / "ck"
    train(_mesh((1, 1)), _tcfg(), EVERY, str(d), save_every=EVERY, batch=4, **OPTS["sgd"])
    (manifest,) = d.glob(f"*{EVERY}/manifest.json")
    doc = json.loads(manifest.read_text())
    del doc["metadata"][key]
    manifest.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match=f"lacks \\['{key}'\\]"):
        train(_mesh((1, 1)), _tcfg(), STEPS, str(d), save_every=EVERY, batch=4, **OPTS["sgd"])


def test_supervise_train_elastic_shrinks_the_stacked_mesh(tmp_path):
    """4 stacked dp ranks preempted after step 3, resumed on 2."""
    cfg = dataclasses.replace(_tcfg(), n_experts=4)
    sizes = iter([4, 4, 2])  # the batch pick, the first attempt, the restart
    plan = ChaosPlan(0, [Fault("train/preempt", at=(EVERY,), kind="preempt")])
    metrics = MetricsRegistry()
    params, rep = supervise_train_elastic(
        cfg, STEPS, str(tmp_path / "ck"), devices_fn=lambda: ["cpu"] * next(sizes),
        budget=RestartBudget(max_restarts=2), metrics=metrics, chaos=plan,
        save_every=EVERY, **OPTS["zero"])
    assert rep.final_step == STEPS and metrics.counter("ft/elastic_reshards").value == 1
    _, meta = checkpoint.peek_metadata(tmp_path / "ck")
    assert meta["mesh_shape"] == {"dp": 2, "sp": 1} and meta["batch"] == 8


def test_pipelined_plan_trains_and_resumes(tmp_path):
    mesh = make_mesh((1, 1, 2), ("dp", "sp", "pp"), device="cpu")
    plan = ShardingPlan(mesh, pp="pp", n_micro=2)
    cfg = _tcfg()
    kw = dict(save_every=EVERY, plan=plan, batch=4, seq=8, **OPTS["zero"])
    whole, rep = train(mesh, cfg, STEPS, str(tmp_path / "a"), **kw)
    assert all(np.isfinite(rep.losses))
    train(mesh, cfg, EVERY, str(tmp_path / "b"), **kw)
    resumed, rep2 = train(mesh, cfg, STEPS, str(tmp_path / "b"), **kw)
    assert rep2.steps_run == EVERY and _same(whole, resumed)
    with pytest.raises(CommError, match="plan"):
        train(make_mesh((1, 1, 1), ("dp", "sp", "pp"), device="cpu"), cfg, STEPS,
              str(tmp_path / "b"), **dict(kw, plan=ShardingPlan(
                  make_mesh((1, 1, 1), ("dp", "sp", "pp"), device="cpu"), pp="pp", n_micro=2)))


def test_program_form_and_synthetic_batch(tmp_path):
    x, y = synthetic_batch(0, 2, 2, 8, 64, "cpu")
    x2, y2 = synthetic_batch(0, 2, 2, 8, 64, "cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2) and x.shape == (2, 8, 64)
    prog = train_program(_mesh(), _tcfg(), STEPS, str(tmp_path / "p"), save_every=EVERY)
    assert prog.workload == "train" and prog.pos == 0
    while not prog.done:
        prog.tick()
    params, rep = prog.finish()
    assert isinstance(rep, TrainReport) and rep.final_step == STEPS
    for bad in (dict(save_every=0), dict(optimizer="lamb"), dict(zero=True),
                dict(accum_steps=2)):
        with pytest.raises(ValueError):
            train_program(_mesh(), _tcfg(), STEPS, str(tmp_path / "q"), **bad)
