"""The port's mesh co-scheduler (``tpuscratch_torch.runtime.scheduler``)
against the JAX package's:

- each policy's pick sequence over synthetic entries whose busy seconds
  grow by a fixed table (RoundRobin at quanta 1 and 3, Priority, and
  GoodputShare with targets and with per-entry shares): EQUAL;
- the ``sched/switch`` / ``sched/finish`` / ``sched/run`` stream and the
  workloads' own events of a run over stub chunked programs (a
  higher-priority job arriving mid-run through ``on_tick``): EQUAL, the
  time stamps and measured seconds aside;
- the per-entry restart (a preempted workload re-made from its factory
  while the other keeps ticking) and the exhausted budget: the same
  events and the same ``RestartsExhausted``;
- a co-scheduled trainer (d_model 32, Adam, 2 stacked dp ranks) and an
  8^3-a-rank MG3D solve on 2x1x1: bit-identical to the same two programs
  run solo in the port, both partition checks of ``by_workload`` holding,
  and within the trainer and runner twins' tolerances of the JAX package's co-scheduled
  run (losses 1e-5 relative, as tests/test_torch_trainer.py; the
  solution within 1e-5 of max|x| with the same cycle count, as
  tests/test_torch_runner.py; Adam parameters' movement within 1e-3 of
  the largest movement, the trainer twins' ``rel_to_max`` form)."""

import json

import jax
import numpy as np
import pytest
import torch

from tpuscratch.ft import chaos as jchaos
from tpuscratch.ft import supervisor as jsup
from tpuscratch.models.trainer import train_program as jax_train_program
from tpuscratch.models.transformer import TransformerConfig as JConfig
from tpuscratch.obs.sink import Sink as JSink
from tpuscratch.runtime import chunked as jchunked
from tpuscratch.runtime import scheduler as js
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.solvers.runner import mg3d_solve_program as jax_solve_program
from tpuscratch_torch.ft import chaos as tchaos
from tpuscratch_torch.ft import supervisor as tsup
from tpuscratch_torch.models.trainer import train_program
from tpuscratch_torch.models.transformer import TransformerConfig
from tpuscratch_torch.obs.goodput import by_workload
from tpuscratch_torch.obs.report import load_events
from tpuscratch_torch.obs.sink import Sink
from tpuscratch_torch.runtime import chunked as tchunked
from tpuscratch_torch.runtime import scheduler as ts
from tpuscratch_torch.runtime.checkpoint import tree_flatten
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.solvers.runner import mg3d_solve_program

torch.set_num_threads(1)

PKGS = {"jax": (js, jchunked, jsup, jchaos, JSink), "port": (ts, tchunked, tsup, tchaos, Sink)}

#: seconds each synthetic workload's tick adds to its busy total
BUSY = {"train": 0.30, "solver": 0.11, "burst": 0.05}


def _simulate(sched_mod, policy, specs, picks=40):
    entries = [sched_mod._Entry(name, None, None, prio, share, None, i)
               for i, (name, prio, share) in enumerate(specs)]
    current, run_len, out = None, 0, []
    for it in range(picks):
        name = policy.pick(entries, current, run_len)
        e = next(x for x in entries if x.name == name)
        if name != current:
            current, run_len = name, 0
        e.busy_s += BUSY[name]
        e.last_pick = it
        run_len += 1
        out.append(name)
    return out


POLICIES = [
    ("RoundRobin", (1,), [("train", 0, None), ("solver", 0, None), ("burst", 0, None)]),
    ("RoundRobin", (3,), [("train", 0, None), ("solver", 0, None)]),
    ("Priority", (2,), [("train", 0, None), ("solver", 1, None), ("burst", 1, None)]),
    ("GoodputShare", ({"train": 0.7, "solver": 0.3},), [("train", 0, None), ("solver", 0, None)]),
    ("GoodputShare", (None,), [("train", 0, 2.0), ("solver", 0, 1.0), ("burst", 0, None)]),
]


@pytest.mark.parametrize("case", range(len(POLICIES)))
def test_policy_pick_sequences_equal(case):
    name, args, specs = POLICIES[case]
    got = _simulate(ts, getattr(ts, name)(*args), specs)
    assert got == _simulate(js, getattr(js, name)(*args), specs)
    top = max(p for _, p, _ in specs)
    assert set(got) == {n for n, p, _ in specs if p == top}   # strict priority starves the rest
    with pytest.raises(ValueError):
        ts.RoundRobin(0)


def _stub(chunked_mod, name, total, start=0, fail_at=None, state=None):
    """A chunked program counting ``pos`` up to ``total``; ``fail_at``
    raises a preemption before that position's chunk, once."""
    state = state if state is not None else {"failed": False, "saved": start}
    chaos_mod = PKGS["jax" if chunked_mod is jchunked else "port"][3]

    def run_chunk(cp, pos):
        if pos == fail_at and not state["failed"]:
            state["failed"] = True
            raise chaos_mod.Preempted(f"{name} preempted at {pos}")
        return pos

    def make_event(cp, pos, payload, span):
        state["saved"] = pos + 1
        return chunked_mod.ChunkResult(pos + 1, event={"step": pos + 1}, save=False)

    def remake():
        return _stub(chunked_mod, name, total, start=state["saved"], fail_at=fail_at,
                     state=state)

    return chunked_mod.ChunkedProgram(workload=name, total=total, pos=start,
                                      run_chunk=run_chunk, make_event=make_event,
                                      epilogue=lambda cp: (name, cp.pos), remake=remake)


_TIMED = {"t", "busy_s", "wall_s", "overhead_s", "seconds", "max_s", "backoff_s", "scope"}


def _stream(path):
    return [{k: v for k, v in json.loads(ln).items() if k not in _TIMED}
            for ln in open(path)]


def _run_stub_schedule(pkg, tmp_path, fail=False, budget=2):
    sched_mod, chunked_mod, sup, _, sink_cls = PKGS[pkg]
    path = tmp_path / f"{pkg}.jsonl"
    slept = []
    with sink_cls(str(path)) as sink:
        def arrive(s):
            if s.ticks == 3 and "burst" not in s.entries:
                s.add(_stub(chunked_mod, "burst", 2), priority=1)

        sched = sched_mod.MeshScheduler(policy=sched_mod.Priority(quantum=2), sink=sink,
                                        on_tick=arrive, sleep=slept.append)
        for name, total in (("train", 5), ("solver", 4)):
            prog = _stub(chunked_mod, name, total, fail_at=2 if (fail and name == "train")
                         else None)
            prog.sink = chunked_mod.WorkloadSink(sink, name)
            sched.add(prog, restarts=sup.RestartBudget(max_restarts=budget, backoff_s=0.25))
        try:
            res = sched.run()
        except sup.RestartsExhausted as e:
            res = e
    return res, _stream(path), slept


@pytest.mark.parametrize("fail", [False, True])
def test_switch_stream_and_restart_equal(tmp_path, fail):
    rj, ej, sj = _run_stub_schedule("jax", tmp_path, fail)
    rt, et, st = _run_stub_schedule("port", tmp_path, fail)
    assert et == ej and rt == rj and st == sj
    assert rt == {"train": ("train", 5), "solver": ("solver", 4), "burst": ("burst", 2)}
    kinds = [e["event"] for e in et]
    assert kinds.count("sched/switch") >= 4 and kinds.count("sched/finish") == 3
    run = next(e for e in et if e["event"] == "sched/run")
    assert run["policy"] == "Priority" and run["workloads"] == 3 and "error" not in run
    assert ("ft/restart" in kinds) == fail and len(st) == (1 if fail else 0)


def test_restart_budget_exhausted_equal(tmp_path):
    rj, ej, _ = _run_stub_schedule("jax", tmp_path, fail=True, budget=0)
    rt, et, _ = _run_stub_schedule("port", tmp_path, fail=True, budget=0)
    assert isinstance(rt, tsup.RestartsExhausted) and isinstance(rj, jsup.RestartsExhausted)
    assert et == ej and any(e["event"] == "ft/give_up" for e in et)
    assert next(e for e in et if e["event"] == "sched/run")["error"] is True


# ---- real workloads: the trainer and the solver runner co-scheduled ---------------

TARGETS = {"train": 0.7, "solver": 0.3}
CFG = dict(d_model=32, n_heads=2, n_experts=2, d_ff=64, n_layers=1)
TRAIN = dict(save_every=2, batch=4, seq=16, optimizer="adam", lr=1e-3)
SOLVE = dict(tol=1e-5, max_cycles=12, chunk_cycles=2, levels=2)
STEPS, SDIMS, AXES = 4, (2, 1, 1), ("z", "row", "col")


def _b():
    b = np.random.default_rng(5).standard_normal(tuple(8 * d for d in SDIMS))
    return (b - b.mean()).astype(np.float32)


def _port_run(tmp_path, mode):
    mesh = make_mesh((2, 1), ("dp", "sp"), device="cpu")
    path = tmp_path / f"{mode}.jsonl"
    with Sink(str(path)) as sink:
        t = train_program(mesh, TransformerConfig(**CFG), STEPS, str(tmp_path / f"{mode}_t"),
                          obs=sink, **TRAIN)
        s = mg3d_solve_program(_b(), str(tmp_path / f"{mode}_s"),
                               mesh=make_mesh(SDIMS, AXES, device="cpu"), sink=sink, **SOLVE)
        if mode == "solo":
            res = {"train": t.run(), "solver": s.run()}
        else:
            sched = ts.MeshScheduler(policy=ts.GoodputShare(TARGETS), sink=sink)
            sched.add(t)
            sched.add(s)
            res = sched.run()
    wg = by_workload(load_events([str(path)]), targets=TARGETS)
    wg.check()
    return res, wg


def _jax_cosched(tmp_path):
    mesh = jax_mesh((2, 1), ("dp", "sp"), jax.devices()[:2])
    smesh = jax_mesh(SDIMS, AXES, jax.devices()[:2])
    t = jax_train_program(mesh, JConfig(**CFG), STEPS, str(tmp_path / "jt"), **TRAIN)
    s = jax_solve_program(_b(), str(tmp_path / "js"), mesh=smesh, **SOLVE)
    sched = js.MeshScheduler(policy=js.GoodputShare(TARGETS))
    sched.add(t)
    sched.add(s)
    return sched.run()


def test_cosched_trainer_and_solver(tmp_path):
    solo, _ = _port_run(tmp_path, "solo")
    co, wg = _port_run(tmp_path, "cosched")
    (ps, rs), (xs, ss) = solo["train"], solo["solver"]
    (pc, rc), (xc, sc) = co["train"], co["solver"]
    la, lb = tree_flatten(ps)[0], tree_flatten(pc)[0]
    assert all(torch.equal(a, b) for a, b in zip(la, lb)) and len(la) == len(lb)
    assert rs.losses == rc.losses and np.array_equal(xs, xc) and ss.cycles == sc.cycles
    assert set(wg.reports) == {"train", "solver"} and sc.converged
    assert abs(sum(wg.shares.values()) - 1.0) < 1e-9
    # the JAX package's co-scheduled run
    jres = _jax_cosched(tmp_path)
    (pj, rj), (xj, sj) = jres["train"], jres["solver"]
    assert sj.cycles == sc.cycles and len(rj.losses) == len(rc.losses)
    np.testing.assert_allclose(rc.losses, rj.losses, rtol=1e-5)
    assert float(np.abs(xc - np.asarray(xj)).max()) <= 1e-5 * float(np.abs(xj).max())
    # Adam parameters: (new - p0) / lr of both, each element within 1e-3 of
    # the largest JAX movement plus two f32 spacings of its parameter over lr
    p0, _ = train_program(make_mesh((2, 1), ("dp", "sp"), device="cpu"),
                          TransformerConfig(**CFG), 0, str(tmp_path / "p0"), **TRAIN).run()
    lr = TRAIN["lr"]
    flat = lambda t: [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)  # noqa: E731
                      for x in tree_flatten(t)[0]]
    for w, a, b in zip(flat(p0), flat(pj), flat(pc), strict=True):
        ja, tb = (a - w) / lr, (b - w) / lr
        seen = 2 * np.spacing(np.abs(w).astype(np.float32)) / lr
        assert not (np.abs(tb - ja) > 1e-3 * max(1.0, float(np.abs(ja).max())) + seen).any()
