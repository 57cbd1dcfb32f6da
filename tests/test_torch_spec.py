"""Speculative decoding in the port (``serve.decode.propose_draft_batch``,
``serve.sampling``'s accept rule, the engine's ``spec_k``) against the JAX
package's on the CPU.

Tolerances: none. The draft proposer is integer work; the accept uniforms,
keys and categorical draws are threefry bits held bit for bit; the
greedy rule is argmax equality. At temperature 0.8 with top-k 4 the
device rule's thresholds come from a float32 softmax on each side (XLA's
and torch's may differ by an ulp), and the draws here are held equal: a
uniform within an ulp of its threshold would be needed to split them.
The engines' tokens and report counters are held equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve_twins import CAPACITY, assert_reports_equal, engines, requests, run_both
from tpuscratch.serve import decode as jdecode
from tpuscratch.serve import sampling as jsampling
from tpuscratch_torch.serve import decode as tdecode
from tpuscratch_torch.serve import sampling as tsampling

PROPOSER_CASES = [((1, 2, 3, 1, 2, 3, 1, 2), 3, 2, (3, 1, 2)),     # the full continuation wins
                  ((7, 7, 7), 4, 2, (7,)),                          # a partial one as fallback
                  ((1, 2, 3, 4, 5), 3, 2, ()), ((1, 2), 3, 2, ()), ((1, 2, 3), 0, 2, ()),
                  ((9, 1, 5, 5, 5, 9, 1, 8, 8, 8, 9, 1), 2, 2, (8, 8)),  # the latest full match
                  ((4, 1, 2, 9, 1, 2), 1, 2, (9,)), ((4, 1, 2, 9, 1, 2), 1, 3, ())]


@pytest.mark.parametrize("ctx,k,ngram,want", PROPOSER_CASES)
def test_propose_draft_cases(ctx, k, ngram, want):
    assert tdecode.propose_draft(ctx, k, ngram) == want == jdecode.propose_draft(ctx, k, ngram)


def _histories(seed, B=12, S=24, vocab=4):
    rng = np.random.default_rng(seed)
    hist = np.zeros((B, S), np.int32)
    lens = rng.integers(0, S + 1, B).astype(np.int32)
    for b in range(B):
        hist[b, :lens[b]] = rng.integers(0, vocab, lens[b])
    return hist, lens


@pytest.mark.parametrize("k,ngram", [(3, 2), (1, 2), (4, 3), (4, 1)])
def test_propose_draft_batch_equals_host_rule_and_jax(k, ngram):
    hist, lens = _histories(k * 10 + ngram)
    drafts, dlen = tdecode.propose_draft_batch(torch.from_numpy(hist), torch.from_numpy(lens),
                                               k, ngram)
    jd, jl = jdecode.propose_draft_batch(jnp.asarray(hist), jnp.asarray(lens), k, ngram)
    assert np.array_equal(drafts.numpy(), np.asarray(jd))
    assert np.array_equal(dlen.numpy(), np.asarray(jl))
    for b in range(hist.shape[0]):
        host = tdecode.propose_draft(hist[b, :lens[b]], k, ngram)
        assert tuple(drafts[b, :dlen[b]].tolist()) == host
        assert not drafts[b, dlen[b]:].any()


def test_accept_uniforms_and_keys_bit_equal_to_jax():
    pos = np.arange(5, 40, dtype=np.int32)
    want = np.asarray(jsampling._accept_uniforms(jax.random.key(7), jnp.int32(3),
                                                 jnp.asarray(pos)))
    got = tsampling._accept_uniforms(tsampling.key(7, "cpu"), 3, torch.from_numpy(pos)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()
    for fn in ("accept_key", "resample_key"):
        j = np.asarray(jax.random.key_data(getattr(jsampling, fn)(4, 9, 11)))
        t = getattr(tsampling, fn)(4, 9, 11, "cpu").numpy()
        assert np.array_equal(t.astype(np.uint32), j)


def test_target_probs_equals_jax():
    logits = np.random.default_rng(2).standard_normal((3, 32)).astype(np.float32) * 3
    for row in logits:
        for temp, tk in ((0.8, 4), (1.3, 0)):
            assert np.array_equal(tsampling.target_probs(row, temp, tk),
                                  jsampling.target_probs(row, temp, tk))
    with pytest.raises(ValueError):
        tsampling.target_probs(logits[0], 0.0)


def _bank(seed, B=10, K=4, V=16):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, K, V)) * 2).astype(np.float32)
    drafts = rng.integers(0, V, (B, K - 1)).astype(np.int32)
    drafts[:5] = logits.argmax(-1)[:5, :K - 1]           # drafts the target agrees with
    dlen = rng.integers(0, K, B).astype(np.int32)
    return (np.arange(B, dtype=np.int32) + 20, (np.arange(B) * 3).astype(np.int32), logits,
            drafts, dlen)


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 4)])
def test_accept_batch_and_host_rule_equal_jax(temperature, top_k):
    rids, pos0, logits, drafts, dlen = _bank(int(temperature * 10) + top_k)
    jn, jt = jsampling.accept_batch(jax.random.key(5), jnp.asarray(rids), jnp.asarray(pos0),
                                    jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(dlen),
                                    temperature=temperature, top_k=top_k)
    tn, tt = tsampling.accept_batch(tsampling.key(5, "cpu"), *(torch.from_numpy(a) for a in
                                    (rids, pos0, logits, drafts, dlen)),
                                    temperature=temperature, top_k=top_k)
    assert np.array_equal(tn.numpy(), np.asarray(jn)) and np.array_equal(tt.numpy(), np.asarray(jt))
    assert tn.dtype == tt.dtype == torch.int32
    for b in range(len(rids)):
        args = (5, int(rids[b]), int(pos0[b]), logits[b], tuple(drafts[b, :dlen[b]]),
                temperature, top_k)
        a, toks = tsampling.accept_speculative(*args)
        assert (a, toks) == jsampling.accept_speculative(*args)
        assert len(toks) == a + 1
        if temperature == 0.0:      # greedy: the device rule is the host rule
            assert (a, toks[-1]) == (int(tn[b]), int(tt[b]))


def test_accept_speculative_greedy_rules():
    logits = np.full((4, 8), -1.0, np.float32)
    logits[0, 3] = logits[1, 5] = logits[2, 2] = 1.0
    assert tsampling.accept_speculative(0, 0, 0, logits, (3, 5, 6)) == (2, (3, 5, 2))
    logits[2, 7] = 2.0
    assert tsampling.accept_speculative(0, 0, 0, logits[:3], (3, 5)) == (2, (3, 5, 7))
    assert tsampling.accept_speculative(0, 0, 0, logits[:1], ()) == (0, (3,))
    with pytest.raises(ValueError):
        tsampling.accept_speculative(0, 0, 0, np.zeros((2, 8), np.float32), (1, 2, 3))


def test_rejection_never_resamples_the_rejected_token():
    logits = np.zeros((2, 6), np.float32)
    logits[0, 2] = -20.0
    got = [tsampling.accept_speculative(t, 0, 0, logits, (2,), temperature=1.0)
           for t in range(20)]
    assert all(a == 0 and toks[0] != 2 for a, toks in got)
    assert got == [jsampling.accept_speculative(t, 0, 0, logits, (2,), temperature=1.0)
                   for t in range(20)]


def test_empty_draft_matches_the_base_sampler():
    logits = np.random.default_rng(5).standard_normal((1, 32)).astype(np.float32)
    for position in (0, 3, 17):
        a, toks = tsampling.accept_speculative(2, 9, position, logits, (), 0.7, 4)
        ref = int(tsampling.sample_logits(tsampling.request_key(2, 9, position, "cpu"),
                                          torch.from_numpy(logits[0]), 0.7, 4))
        assert (a, toks) == (0, (ref,))


# mixed traffic: periodic prompts (draftable) and arbitrary ones, one stop token
SPEC_TRAFFIC = [(i, (1 + i % 3, 2, 1 + i % 3, 2) * 2 if i % 2 == 0 else (5 + i % 4, 3, 7),
                 4 + (i * 3) % 5, (2,) if i == 2 else ()) for i in range(6)]


@CAPACITY
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 4)])
@pytest.mark.parametrize("dims", [(1, 1), (1, 2)])
def test_spec_engine_equals_jax(dims, temperature, top_k, cfg):
    _, want, eng, got = run_both(SPEC_TRAFFIC, dims, cfg, spec_k=3, temperature=temperature,
                                 top_k=top_k)
    assert_reports_equal(got, want)
    assert got.drafted > 0 and got.accepted > 0 and got.decode_compiles == 1
    assert got.tokens_generated == got.prefills + got.slot_steps + got.accepted
    assert eng.free_pages() == [32] * dims[0]
    assert eng.metrics.histogram("serve/accept_len").count == got.slot_steps


def test_greedy_spec_equals_plain_and_saves_sweeps():
    jeng, make = engines()
    plain = make().run(requests(SPEC_TRAFFIC))
    _, make_spec = engines(spec_k=3)
    spec = make_spec().run(requests(SPEC_TRAFFIC))
    assert spec.outputs == plain.outputs and spec.tokens_generated == plain.tokens_generated
    assert spec.decode_steps < plain.decode_steps
    assert spec.accept_len_mean == spec.accepted / spec.slot_steps
