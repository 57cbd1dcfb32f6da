"""Prefix sharing, chunked prefill, in-engine retries and the engine's hooks
in the port (``serve.kvcache.PrefixCache`` and the page refcounts, the
engine's ``prefix_share``, ``chunk_prefill``, ``retry_budget``, ``sink``,
``chaos`` and ``recorder``) against the JAX package's on the CPU.

Tolerances: none. The trie and the allocator are host Python; the
engines' tokens and counters (prefilled, shared and sub-page tokens,
copy-on-write pages, quarantines) are held equal, as are the sink's
events other than their wall-clock fields."""

import pytest

from _torch_serve_twins import (CAPACITY, CFG, SCFG, assert_reports_equal, engines, requests,
                                run_both)
from tpuscratch.ft.chaos import ChaosPlan as JaxChaosPlan
from tpuscratch.ft.chaos import Fault as JaxFault
from tpuscratch.serve.kvcache import PrefixCache as JaxPrefixCache
from tpuscratch_torch.bench.decode_bench import bench_chunk_longmix, shared_prefix_prompts
from tpuscratch_torch.ft.chaos import ChaosPlan, Fault
from tpuscratch_torch.models.transformer import TransformerConfig
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.serve import ServeConfig, ServeEngine
from tpuscratch_torch.serve.kvcache import PageAllocator, PrefixCache

# ---- the page refcounts and the prefix trie ------------------------------------


def test_share_holds_a_page_until_its_last_holder_frees():
    a = PageAllocator(4)
    p = a.alloc(1)
    a.share(p)
    assert a.refcount(p[0]) == 2 and a.free(p) == [] and a.n_free == 3
    assert a.free(p) == p and a.n_free == 4
    with pytest.raises(ValueError):
        a.share(p)                  # a freed page cannot be shared
    with pytest.raises(ValueError):
        a.free(p)                   # nor freed twice


def test_watermark_counts_unique_pages_not_holders():
    a = PageAllocator(4)
    p = a.alloc(1)
    for _ in range(5):
        a.share(p)
    assert a.n_free == 3 and a.n_live == 1


def _both(fn):
    """``fn`` on the port's trie and the JAX package's: equal results."""
    got, want = fn(PrefixCache), fn(JaxPrefixCache)
    assert got == want
    return got


def test_match_walks_full_page_blocks():
    def fn(cls):
        t = cls(4)
        t.insert((1, 2, 3, 4, 5, 6, 7, 8, 9), [10, 11])
        return [t.match(p) for p in ((1, 2, 3, 4, 5, 6, 7, 8), (1, 2, 3, 4, 9, 9, 9, 9),
                                     (1, 2, 3), (2, 2, 3, 4))]
    assert _both(fn) == [[10, 11], [10], [], []]


def test_oldest_copy_wins_and_alternates_survive_drop():
    def fn(cls):
        t = cls(2)
        t.insert((1, 2), [5])
        t.insert((1, 2), [7])
        out = [t.match((1, 2))]
        t.drop([5])
        out.append(t.match((1, 2)))
        t.drop([7])
        return out + [t.match((1, 2)), t.n_blocks]
    assert _both(fn) == [[5], [7], [], 0]


def test_chain_extension_drop_and_clear():
    def fn(cls):
        t = cls(2)
        t.insert((1, 2), [3])
        t.insert((1, 2, 5, 6), [3, 9])
        out = [t.match((1, 2, 5, 6)), t.registered(9), t.registered(4)]
        t.drop([3])
        out += [t.match((1, 2, 5, 6)), t.registered(3)]
        t.insert((1, 2), [8])
        t.clear()
        return out + [t.n_blocks, t.match((1, 2))]
    assert _both(fn) == [[3, 9], True, False, [], False, 0, []]


def test_match_tail_sub_page_continuations():
    def fn(cls):
        t = cls(4)
        t.insert((1, 2, 3, 4, 5, 6, 7), [10, 11])      # a partial tail block on page 11
        t.insert((1, 2, 3, 4, 5, 6, 9, 9), [10, 12])
        return [t.match_tail((1, 2, 3, 4, 5, 6, 7, 8), 1),
                t.match_tail((1, 2, 3, 4, 5, 6, 9), 1),
                t.match_tail((1, 2, 3, 4, 5, 6, 9), 1, prefer=lambda p: p != 12),
                t.match_tail((7, 7, 7, 7, 7), 1)]
    assert _both(fn) == [(11, 3), (12, 3), (11, 2), (None, 0)]


# ---- the engines -----------------------------------------------------------------

# a two-page system prefix and private tails, one prompt fully page-aligned
SHARED = [(i, (1, 2, 3, 4, 5, 6, 7, 8) + ((9 + i % 4,) if i != 3 else ()), 3 + i % 3)
          for i in range(6)]


@pytest.mark.parametrize("kw", [dict(prefix_share=True), dict(chunk_prefill=3),
                                dict(prefix_share=True, chunk_prefill=4, kv_dtype="int8")],
                         ids=["share", "chunk", "share-chunk-int8"])
@pytest.mark.parametrize("dims", [(1, 1), (1, 2)])
@CAPACITY
def test_context_admission_engines_equal_jax(dims, kw, cfg):
    jeng, want, eng, got = run_both(SHARED, dims, cfg, **kw)
    assert_reports_equal(got, want)
    assert got.prefill_tokens + got.shared_tokens == sum(len(p) for _, p, _ in SHARED)
    assert eng.free_pages() == jeng.free_pages() == [32] * dims[0]
    if kw.get("prefix_share"):
        assert got.shared_tokens > 0
        assert got.cow_pages > 0 or kw.get("chunk_prefill")  # chunked: no prompt page-aligned yet
        assert all(t.n_blocks == 0 for t in eng._tries)


def test_shared_and_chunked_outputs_equal_monolithic():
    _, make = engines()
    mono = make().run(requests(SHARED))
    for kw in (dict(prefix_share=True), dict(chunk_prefill=3)):
        _, make_kw = engines(**kw)
        rep = make_kw().run(requests(SHARED))
        assert rep.outputs == mono.outputs
    assert rep.prefill_tokens == mono.prefill_tokens


@CAPACITY
def test_share_ratio_sweep_equals_jax(cfg):
    """The static sharing proof: prefilled tokens and fresh K/V bytes fall
    with the share ratio, the sub-page copies counted, all equal to JAX."""
    prefill = []
    for ratio in (0.0, 0.5, 0.9):
        traffic = [(i, p, 4) for i, p in enumerate(shared_prefix_prompts(6, 18, ratio, 16))]
        _, want, _, got = run_both(traffic, cfg=cfg, prefix_share=True, n_pages=48)
        assert_reports_equal(got, want)
        prefill.append((got.prefill_tokens, got.fresh_kv_bytes))
    assert prefill[0] > prefill[1] > prefill[2]


def test_longmix_plain_check_is_refused_where_the_kernel_is_off():
    """Holding the chunked long mix to the plain attention is only a check
    where the chunked run takes the paged kernel (on the card)."""
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    with pytest.raises(ValueError, match="needs the card"):
        bench_chunk_longmix(mesh, TransformerConfig(**CFG), ServeConfig(**SCFG), chunk=4,
                            against="plain")


def test_prefix_match_tokens_mid_flight_equals_jax():
    jeng, make = engines(prefix_share=True)
    eng = make()
    reqs = requests(SHARED[:2])
    for r, jr in zip(reqs, requests(SHARED[:2], jax_side=True)):
        eng.submit(r)
        jeng.submit(jr)
    eng.step()
    jeng.step()
    probe = (1, 2, 3, 4, 5, 6, 7, 8, 9, 4)
    assert eng.prefix_match_tokens(probe) == jeng.prefix_match_tokens(probe) > 0


def test_watermark_admission_is_refcount_aware():
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    scfg = ServeConfig(n_slots=2, n_pages=5, page_size=4, max_seq=16, vocab=16, prefix_share=True)
    peaks = []
    for share in (True, False):
        eng = ServeEngine(mesh, TransformerConfig(**CFG),
                          ServeConfig(**{**scfg.__dict__, "prefix_share": share}))
        for r in requests([(i, (1, 2, 3, 4, 5, 6, 7, 8), 4) for i in range(2)]):
            eng.submit(r)
        peak = 0
        while eng.n_queued or eng.n_active:
            eng.step()
            peak = max(peak, eng.n_active)
        peaks.append(peak)
    assert peaks == [2, 1]


# ---- retries, quarantine and the hooks -------------------------------------------------

RETRY = [(i, (1 + i, 2), 4) for i in range(4)]


class _Events:
    """A sink that keeps its events (duck-typed as the obs sinks are)."""

    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def emit_metrics(self, snapshot, event="metrics", scope=None):
        self.events.append((event, {"names": sorted(snapshot)}))

    def flush(self):
        pass


_WALL = {"tick_s", "prefill_s", "decode_s", "seconds", "max_s", "scope", "error"}


def _plain(events):
    return [(e, {k: v for k, v in f.items() if k not in _WALL}) for e, f in events]


@pytest.mark.parametrize("budget,fault", [
    (3, dict(key=1, at=(0, 1), times=2)),               # transient: heals
    (2, dict(key=1, p=1.0, at=None, times=None)),       # poison: quarantined
], ids=["transient", "poison"])
@CAPACITY
def test_retry_budget_with_chaos_equals_jax(budget, fault, cfg):
    _, make = engines(dims=(1, 2), cfg=cfg, n_pages=16)
    clean = make().run(requests(RETRY))
    jsink, tsink = _Events(), _Events()
    jplan, plan = JaxChaosPlan(0, [JaxFault("serve/prefill", **fault)]), \
        ChaosPlan(0, [Fault("serve/prefill", **fault)])
    jeng, make = engines(dims=(1, 2), cfg=cfg, n_pages=16, retry_budget=budget,
                         jax_kw=dict(chaos=jplan, sink=jsink))
    want = jeng.run(requests(RETRY, jax_side=True))
    eng = make(chaos=plan, sink=tsink)
    got = eng.run(requests(RETRY))
    assert_reports_equal(got, want)
    assert plan.fired == jplan.fired
    assert _plain(tsink.events) == _plain(jsink.events)
    quarantines = [f for e, f in tsink.events if e == "ft/quarantine"]
    if fault["times"] is None:
        assert got.quarantined == (1,) and eng.is_quarantined(1) and 1 in eng.quarantined
        assert got.outputs == tuple((r, t) for r, t in clean.outputs if r != 1)
        assert [(q["rid"], q["attempts"]) for q in quarantines] == [(1, 3)]
        assert "InjectedFault" in eng.quarantined[1]
    else:
        assert got.outputs == clean.outputs and not quarantines
    assert eng.free_pages() == [16] and not eng.n_queued and not eng.n_active
    assert eng.metrics.counter("serve/prefill_failures").value == plan.fired["serve/prefill"]


def test_raise_through_without_a_budget_requeues_and_names_the_poison():
    _, make = engines(n_pages=16)
    eng = make(chaos=ChaosPlan(0, [Fault("serve/prefill", key=2, at=(0,), times=1)]))
    for r in requests(RETRY):
        eng.submit(r)
    with pytest.raises(Exception, match="injected"):
        while eng.n_queued or eng.n_active:
            eng.step()
    assert eng.take_poison_rid() == 2 and eng.take_poison_rid() is None
    assert eng.free_pages() == [16] and eng.n_queued == 4    # every request requeued
    assert eng.drop_queued(2) and not eng.drop_queued(2)
    rep = eng.run()
    assert sorted(dict(rep.outputs)) == [0, 1, 3]


def test_sink_and_recorder_follow_the_jax_engine():
    """The engine event, a tick event a tick, the drain's report and the
    phase totals as the JAX engine emits them; the recorder's spans (a
    prefill span an admission, a decode span a dispatch)."""
    jsink, tsink = _Events(), _Events()
    jeng, make = engines(spec_k=2, macro_steps=2, jax_kw=dict(sink=jsink))
    want = jeng.run(requests(SHARED, jax_side=True))
    eng = make(sink=tsink)
    got = eng.run(requests(SHARED))
    assert got.outputs == want.outputs
    assert _plain(tsink.events) == _plain(jsink.events)
    assert tsink.events[0][0] == "serve/engine" and tsink.events[0][1]["macro_steps_effective"] == 2
    totals = eng.recorder.phase_totals()
    jtotals = jeng.recorder.phase_totals()
    assert {k: v.count for k, v in totals.items()} == {k: v.count for k, v in jtotals.items()}
    assert totals["serve/prefill"].count == got.prefills
    assert totals["serve/decode"].count == got.dispatches
    assert eng.metrics.gauge("serve/macro_steps").value == 2
    assert [rid for rid, _ in got.ttft_s] == [rid for rid, _ in want.ttft_s]


def test_a_tracer_still_raises():
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        ServeEngine(mesh, TransformerConfig(**CFG), ServeConfig(**SCFG), tracer=object())
