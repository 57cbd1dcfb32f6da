"""The port's fault-tolerance package (``tpuscratch_torch.ft``) against the
JAX package's: ``jittered_backoff`` delays, ``RetryPolicy`` schedules and
``RestartBudget`` delays equal for the same seeds; ``ChaosPlan`` firing
sequences equal for the same plan (both draw from numpy and ``zlib``); the
``GuardState`` ladder equal on the same statuses; ``retry`` and
``supervise`` restart and exhaust as the JAX package's do; and the guarded
train step (``train_step(guard=...)``) against the JAX guarded step on a
small model, on 1x1 and 2x2: the statuses equal, the loss within 1e-5
relative and the update within ``test_torch_train.py``'s stated
tolerances (1e-4 relative, 1e-5 absolute of the update over lr; a skipped
step leaves the parameters bit for bit)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch import ft as jft
from tpuscratch.ft.retry import jittered_backoff as j_backoff
from tpuscratch.models import transformer as jt
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch_torch import ft as tft
from tpuscratch_torch.ft.retry import jittered_backoff as t_backoff
from tpuscratch_torch.models import transformer as tt
from tpuscratch_torch.obs import CompileCounter, MetricsRegistry
from tpuscratch_torch.runtime.errors import CommError
from tpuscratch_torch.runtime.mesh import make_mesh
from test_torch_train import _compare_updates, _np_tree

LR = 0.05


def test_backoff_delays_match():
    for seed in (0, 3, 99):
        for n in range(8):
            args = (seed, n, 0.01, 2.0, 0.5, 0.25)
            assert j_backoff(*args) == t_backoff(*args)
    jp, tp = jft.RetryPolicy(seed=7, jitter=0.3), tft.RetryPolicy(seed=7, jitter=0.3)
    assert [jp.delay(i) for i in range(6)] == [tp.delay(i) for i in range(6)]
    jb = jft.RestartBudget(backoff_s=0.1, seed=4)
    tb = tft.RestartBudget(backoff_s=0.1, seed=4)
    assert [jb.delay(i) for i in range(1, 6)] == [tb.delay(i) for i in range(1, 6)]


def _fire_all(mod):
    plan = mod.ChaosPlan(11, [
        mod.Fault("train/grad", p=0.3, times=None, kind="nan"),
        mod.Fault("ckpt/save", stage="leaf_1", at=(1, 3)),
        mod.Fault("serve/prefill", key=5, times=2),
        mod.Fault("comm/halo_chunk", p=0.5, times=3),
        mod.Fault("serve/replica", p=0.2, times=2, domain=(0, 1), kind="kill"),
    ])
    seq = []
    for i in range(40):
        f = plan.should_fire("train/grad", index=i)
        seq.append(("grad", i, f is not None))
        seq.append(("halo", i, plan.should_fire("comm/halo_chunk") is not None))
        for stage in ("begin", "leaf_0", "leaf_1"):
            seq.append(("ckpt", stage, plan.should_fire("ckpt/save", stage=stage) is not None))
        for key in (4, 5):
            seq.append(("prefill", key, plan.should_fire("serve/prefill", key=key) is not None))
        for key in (0, 1, 2):
            seq.append(("replica", i, key,
                        plan.should_fire("serve/replica", index=i, key=key) is not None))
    return seq, plan.stats()


def test_chaos_firing_sequences_match():
    (jseq, jstats), (tseq, tstats) = _fire_all(jft), _fire_all(tft)
    assert jseq == tseq and jstats == tstats and sum(jstats.values()) > 5


def test_chaos_hooks():
    plan = tft.ChaosPlan(0, [tft.Fault("train/grad", at=(2,), kind="inf"),
                             tft.Fault("comm/x", at=(0,)),
                             tft.Fault("train/preempt", at=(4,), kind="preempt")])
    x = torch.zeros(2, 3)
    assert plan.corrupt_batch(x, 1) is x
    bad = plan.corrupt_batch(x, 2)
    assert math.isinf(float(bad[0, 0])) and float(x[0, 0]) == 0.0
    with pytest.raises(tft.InjectedFault) as e:
        plan.wrap_collective(lambda: 1, "x")()
    assert isinstance(e.value, CommError) and e.value.op == "x"
    assert plan.wrap_collective(lambda: 1, "x")() == 1
    plan.maybe_preempt(index=3)
    with pytest.raises(tft.Preempted):
        plan.maybe_preempt(index=4)


def test_guard_ladder_matches():
    statuses = [[0, 2, 0], [2, 2], [1, 0, 2, 2, 2], [0], [2, 2, 2]]
    for policy in (dict(max_skips=0, max_rollbacks=3), dict(max_skips=2, max_rollbacks=1)):
        js, ts = jft.GuardState(jft.GuardPolicy(**policy)), tft.GuardState(tft.GuardPolicy(**policy))
        for chunk in statuses:
            rj, rt = js.observe(chunk), ts.observe(chunk)
            assert rj == rt
            if rj:
                outcomes = []
                for st, err in ((js, jft.GuardFailure), (ts, tft.GuardFailure)):
                    try:
                        st.rolled_back()
                        outcomes.append("ok")
                    except err:
                        outcomes.append("failed")
                assert outcomes[0] == outcomes[1]
                if outcomes[0] == "failed":
                    break
            assert (js.skips, js.clips, js.rollbacks, js.streak) == \
                (ts.skips, ts.clips, ts.rollbacks, ts.streak)
    assert tft.GuardPolicy(clip_norm=2.0).step_guard() == (2.0, math.inf)


def test_retry_recovers_and_exhausts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    slept = []
    policy = tft.RetryPolicy(max_attempts=4, base_s=0.01, seed=2)
    assert tft.retry(flaky, policy, sleep=slept.append) == "done"
    assert slept == [policy.delay(0), policy.delay(1)]
    with pytest.raises(OSError, match="always"):
        tft.retry(lambda: (_ for _ in ()).throw(OSError("always")),
                  tft.RetryPolicy(max_attempts=2, base_s=0.0), sleep=lambda s: None)


def test_supervise_restarts_then_returns_and_exhausts():
    attempts = []

    def fn():
        attempts.append(1)
        if len(attempts) == 1:
            raise tft.Preempted("train/preempt", 3)
        if len(attempts) == 2:
            raise CommError("halo_chunk", "transient")
        return "ok"

    metrics = MetricsRegistry()
    slept = []
    budget = tft.RestartBudget(max_restarts=3, backoff_s=0.1, seed=1)
    assert tft.supervise(fn, budget=budget, metrics=metrics, sleep=slept.append) == "ok"
    assert metrics.counter("ft/restarts").value == 2
    assert slept == [jft.RestartBudget(max_restarts=3, backoff_s=0.1, seed=1).delay(i)
                     for i in (1, 2)]

    def always():
        raise OSError("down")

    with pytest.raises(tft.RestartsExhausted) as e:
        tft.supervise(always, budget=tft.RestartBudget(max_restarts=2), sleep=lambda s: None)
    assert isinstance(e.value.__cause__, OSError)
    with pytest.raises(ValueError):  # not restartable: propagates at once
        tft.supervise(lambda: (_ for _ in ()).throw(ValueError("bug")), sleep=lambda s: None)


def _cfgs():
    kw = dict(d_model=32, n_heads=2, n_experts=2, d_ff=48, capacity_factor=2.0)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_guarded_step_against_jax(dims):
    jc, tc = _cfgs()
    p0 = _np_tree(jt.init_params(5, jc))
    x, y = rand((4, 16, 32), 30), rand((4, 16, 32), 31)
    jmesh = jax_mesh(dims, ("dp", "sp"), jax.devices()[:dims[0] * dims[1]])
    tmesh = make_mesh(dims, ("dp", "sp"), device="cpu")
    bad = x.copy()
    bad[0, 0, 0] = np.nan
    nan, tiny = np.float32(np.nan), np.float32(1e-9)
    cases = [((1e30, 4.0), x, nan, jft.STATUS_OK), ((1e30, 4.0), bad, nan, jft.STATUS_SKIPPED),
             ((1e30, 4.0), x, tiny, jft.STATUS_SKIPPED), ((1e-3, 1e30), x, nan, jft.STATUS_CLIPPED)]
    counter = CompileCounter()
    jsteps = {g: jt.train_step(jmesh, jc, lr=LR, guard=g) for g in {c[0] for c in cases}}
    for guard, xb, ref, want in cases:
        jnew, jl, jg, js = jsteps[guard](
            jax.tree.map(jnp.asarray, p0), jnp.asarray(xb), jnp.asarray(y), jnp.asarray(ref))
        tnew, tl, tg, ts = tt.train_step(tmesh, tc, lr=LR, guard=guard, counter=counter)(
            tt.params_from_numpy(p0, "cpu"), to_torch(xb), to_torch(y), torch.tensor(ref))
        assert int(js) == int(ts) == want and ts.dtype == torch.int32
        if want == jft.STATUS_SKIPPED and xb is bad:
            assert math.isnan(float(tl)) and math.isnan(float(jl))
        else:
            assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
            assert abs(float(tg) - float(jg)) <= 1e-4 * abs(float(jg))
        if want == jft.STATUS_SKIPPED:
            for a, b in zip(tt._leaves(tnew), tt._leaves(tt.params_from_numpy(p0, "cpu"))):
                assert torch.equal(a, b)
        else:
            _compare_updates(p0, jnew, tnew, LR, 1e-4, 1e-5)
    assert counter.count == len(cases)
