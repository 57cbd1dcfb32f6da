"""The port's sampler (``tpuscratch_torch.serve.sampling``) against the JAX
package's: the threefry key chain bit for bit, and the same tokens at
temperature 0, at 0.8 and with top-k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuscratch.serve import sampling as js
from tpuscratch_torch.serve import sampling as ts

RIDS = np.array([0, 1, 7, 4095, 123456, 2**31 - 1], np.int32)
POS = np.array([0, 1, 2, 63, 9, 100000], np.int32)


def _keys(seed):
    jk = js.request_keys(jax.random.key(seed), jnp.asarray(RIDS), jnp.asarray(POS))
    tk = ts.request_keys(ts.key(seed, "cpu"), torch.from_numpy(RIDS).long(), torch.from_numpy(POS).long())
    return jk, tk


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_key_data_bit_equal(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                  np.asarray(jax.random.key_data(jk)))
    one = js.request_key(seed, 7, 2)
    np.testing.assert_array_equal(ts.request_key(seed, 7, 2, "cpu").numpy().astype(np.uint32),
                                  np.asarray(jax.random.key_data(one)))


def test_uniform_bits_equal():
    jk, tk = _keys(5)
    got = ts._uniform_tiny(tk, 257).numpy()
    for i in range(len(RIDS)):
        want = jax.random.uniform(jk[i], (257,), minval=np.finfo(np.float32).tiny, maxval=1.0)
        np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0), (0.8, 4), (1.5, 0)])
@pytest.mark.parametrize("vocab", [16, 1024])
def test_sample_batch_tokens_equal(temperature, top_k, vocab):
    jk, tk = _keys(11)
    logits = np.random.default_rng(vocab).standard_normal((len(RIDS), vocab)).astype(np.float32)
    logits[0, 3] = logits[0, 5] = logits[0].max() + 1.0  # a tie: the first index wins
    want = np.asarray(js.sample_batch(jk, jnp.asarray(logits), temperature, top_k))
    got = ts.sample_batch(tk, torch.from_numpy(logits), temperature, top_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_support_and_refusal():
    logits = torch.arange(16, dtype=torch.float32)
    keys = ts.request_keys(ts.key(0, "cpu"), torch.zeros(64, dtype=torch.int64), torch.arange(64))
    toks = ts.sample_batch(keys, logits.expand(64, 16), 1.0, 4)
    assert set(toks.tolist()) <= {12, 13, 14, 15}
    with pytest.raises(ValueError, match="temperature"):
        ts.sample_logits(keys[0], logits, -0.1)
