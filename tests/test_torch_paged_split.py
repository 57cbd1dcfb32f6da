"""The paged kernel's split-and-combine arithmetic and the host rules of the
two redesigned kernels (``csrc/paged_attention.cu``, ``dma_hbm_step`` of
``csrc/halo_dma.cu``), on the CPU.

``paged_split_plain`` / ``combine_splits_plain`` model what the split kernel
leaves in scratch and how the combine kernel merges it (in split order);
they are held to the JAX package's Pallas ``paged_attention`` run in
interpret mode and to the port's dense plain version, at ``PAGED_ATOL``
(1e-5, the card's limit of the kernel), on f32, int8 and fp8 pools with
ragged lengths, sentinel table tails and an idle slot, for split counts
whose splits hold no valid position too. The host rules (``paged_plan``,
``paged_load_width``, ``hbm_step_plan``) are plain Python and are checked
over edge shapes."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged_attention import _jax, _torch, paged_case
from tpuscratch.ops import attention as ja
from tpuscratch_torch.ops import attention as ta
from tpuscratch_torch.ops import halo_dma as th
from tpuscratch_torch.parallel.scores import NEG_INF

PAGED_ATOL = 1e-5
DTYPES = {"f32": None, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
# K = 3 queries, 4-token pages, 6 table entries: 24 positions
CASE = dict(B=4, K=3, max_pages=6)
# (split_len, n_split): one split; splits of a page; splits that end
# inside a page; one position a split; more splits than the table covers,
# so the last ones attend nothing for every sequence
SPLITS = [(24, 1), (4, 6), (7, 4), (1, 24), (5, 8)]
H100 = dict(n_sm=132, smem_optin=232448)


@functools.lru_cache(maxsize=None)
def _case(dtype: str):
    ops = paged_case(61, CASE["B"], CASE["K"], max_pages=CASE["max_pages"], dtype=DTYPES[dtype])
    want = np.asarray(ja.verify_attention(*_jax(ops), fused=True))   # interpreted Pallas
    return ops, want


@pytest.mark.parametrize("split_len,n_split", SPLITS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_and_combine_match_jax_kernel_and_dense(dtype, split_len, n_split):
    ops, want = _case(dtype)
    t = _torch(ops)
    m, l, acc = ta.paged_split_plain(*t, split_len=split_len, n_split=n_split)
    assert m.shape == (n_split, CASE["B"], CASE["K"], 2) and acc.shape == m.shape + (8,)
    got = ta.combine_splits_plain(m, l, acc)
    np.testing.assert_allclose(got.numpy(), want, atol=PAGED_ATOL, rtol=0)
    dense = ta._verify_attention_dense(*t)
    assert float((got - dense).abs().max()) <= PAGED_ATOL
    assert not got[0].any()                      # the idle slot


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_all_masked_split_is_neutral(dtype):
    ops, _ = _case(dtype)
    t = _torch(ops)
    m, l, acc = ta.paged_split_plain(*t, split_len=5, n_split=8)
    # positions 25..39 lie past the table's 24: splits 5, 6 and 7 attend
    # nothing, for every sequence and query
    for s in (5, 6, 7):
        assert torch.all(m[s] == NEG_INF) and torch.all(l[s] == 0) and not acc[s].any()
    # the idle slot's splits attend nothing either
    assert torch.all(m[:, 0] == NEG_INF) and torch.all(l[:, 0] == 0)
    assert torch.equal(ta.combine_splits_plain(m, l, acc),
                       ta.combine_splits_plain(m[:5], l[:5], acc[:5]))


@pytest.mark.parametrize("drop", [0, 2])
def test_dropped_rescale_factor_is_caught(drop):
    # the planted fault of chip_smoke.py's phase 14: one split's factor
    # exp(m_s - M) taken as 1; the unchanged limit must see it
    ops, want = _case("f32")
    m, l, acc = ta.paged_split_plain(*_torch(ops), split_len=4, n_split=6)
    bad = ta.combine_splits_plain(m, l, acc, drop_rescale=drop)
    assert float(np.abs(bad.numpy() - want).max()) > 100 * PAGED_ATOL


def test_split_model_on_stacked_ranks_and_bf16_out():
    ops = paged_case(62, 3, 2, lead=(2,), dtype=jnp.int8, max_pages=4)
    t = _torch(ops)
    m, l, acc = ta.paged_split_plain(*t, split_len=3, n_split=6)
    got = ta.combine_splits_plain(m, l, acc, torch.bfloat16)
    want = ta._verify_attention_dense(*t)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) <= 1e-2    # one bf16 ulp


# ---- host rules ----------------------------------------------------------------


@pytest.mark.parametrize("esize,D,strides,ptrs,want", [
    (4, 128, (16 * 8 * 128, 8 * 128, 128), (0, 4096), 16),   # config 12's f32 pool
    (1, 128, (16 * 8 * 128, 8 * 128, 128), (0, 4096), 16),   # int8 / fp8
    (4, 20, (4 * 3 * 20, 3 * 20, 20), (0, 256), 16),          # D 20 f32: 80-byte rows
    (1, 40, (4 * 3 * 40, 3 * 40, 40), (0, 256), 8),           # D 40 int8: 40-byte rows
    (1, 20, (4 * 3 * 20, 3 * 20, 20), (0, 256), 4),           # D 20 int8
    (1, 3, (4 * 2 * 3, 2 * 3, 3), (0, 256), 1),               # odd int8 rows: byte loads
    (4, 128, (16 * 4 * 129, 4 * 129, 129), (0, 4096), 4),     # a view of 129-column rows
    (4, 128, (16 * 8 * 128, 8 * 128, 128), (8, 4096), 8),     # an 8-byte aligned base
    (4, 2, (8, 4, 2), (0, 0), 8),
])
def test_paged_load_width(esize, D, strides, ptrs, want):
    assert ta.paged_load_width(esize, D, strides, ptrs) == want


@pytest.mark.parametrize("B,K,H,D,page,max_pages,esize", [
    (32, 1, 8, 128, 16, 9, 4),       # config 12's decode tick: no split
    (32, 1, 8, 128, 16, 9, 1),
    (4, 1, 8, 128, 16, 256, 4),      # B 4 x T 4096: split
    (2, 1, 8, 128, 16, 256, 1),
    (1, 1, 1, 128, 16, 4096, 4),     # one long sequence: the most splits
    (6, 20, 3, 40, 4, 12, 1),
    (6, 65, 8, 384, 16, 16, 4),
    (5, 128, 2, 200, 8, 28, 1),
    (1, 1, 1, 1, 1, 1, 1),
    (3, 2, 5, 20, 3, 7, 4),
    (2, 4, 2, 1000, 16, 8, 4),       # wide: 2 output tiles
    (1, 1, 1, 8192, 16, 4, 4),       # wide: the ring shrinks to fit
    (65535, 1, 1, 64, 16, 2, 4),
])
def test_paged_plan_fits_and_covers(B, K, H, D, page, max_pages, esize):
    p = ta.paged_plan(B, K, H, D, page, max_pages, esize, 4, **H100)
    tcap = max_pages * page
    assert p.smem == ta.paged_smem(esize, D, p.nj, p.wide, p.wq, p.tt, p.stages)
    assert p.smem <= H100["smem_optin"]
    assert ta.PAGED_THREADS % p.tt == 0 and 2 <= p.stages <= ta.PAGED_STAGES
    assert p.split_len % p.tt == 0
    assert p.split_len * p.n_split >= tcap > p.split_len * (p.n_split - 1)
    assert 1 <= p.n_split <= ta.PAGED_MAX_SPLITS
    d4 = -(-D // 4)
    assert p.wide == (D > ta.PAGED_TILE)
    assert (p.n_dt * 128 >= d4 and p.nj == 4) if p.wide else (32 * p.nj >= d4 and p.n_dt == 1)
    assert p.wq == {1: 1, 2: 2, 3: 4, 4: 4}.get(K, 8)
    assert -(-K // p.wq) * p.n_dt * p.n_split <= 65535
    base = B * H * -(-K // p.wq) * p.n_dt
    if base >= H100["n_sm"]:
        assert p.n_split == 1
    if p.n_split > 1:
        assert p.split_len >= ta.PAGED_MIN_SPLIT - p.tt + 1
        assert base * p.n_split <= ta.PAGED_WAVES * H100["n_sm"]


def test_paged_plan_splits_small_batches_only():
    full = ta.paged_plan(32, 1, 8, 128, 16, 256, 4, 16, **H100)
    small = ta.paged_plan(4, 1, 8, 128, 16, 256, 4, 16, **H100)
    assert full.n_split == 1 and small.n_split > 1
    # PAGED_WAVES blocks an SM, never more (a partial second wave), less
    # what rounding the split to whole chunks takes
    assert 4 * 8 * (small.n_split + 1) > ta.PAGED_WAVES * H100["n_sm"]
    assert 4 * 8 * small.n_split <= ta.PAGED_WAVES * H100["n_sm"]
    # a short cache is never split below PAGED_MIN_SPLIT positions
    assert ta.paged_plan(1, 1, 8, 128, 16, 8, 4, 16, **H100).n_split == 1
    # the chunk stays within the table's positions
    assert ta.paged_plan(2, 1, 2, 64, 2, 3, 4, 16, **H100).tt <= 8


# config 12's decode plans (B 32, T 128, H 8, D 128, 16-byte loads), which
# the wide heads' repair leaves as they were: (tt, stages, smem) by pool
# element size
NARROW_B32_T128 = {4: (32, 3, 99072), 1: (64, 4, 67584)}


@pytest.mark.parametrize("esize", [4, 1])   # f32 and int8 pools
@pytest.mark.parametrize("K", [1, 8])
def test_paged_plan_takes_a_head_no_whole_row_ring_fits(K, esize):
    # D 16384: two stages of one token's K and V rows (256 KB in f32) and,
    # at K 8, eight q rows (512 KB) exceed a block's shared memory; the
    # plan streams a chunk through the ring in 512-column units instead
    # and refuses no width
    p = ta.paged_plan(1, K, 1, 16384, 16, 4, esize, 16, **H100)
    assert p.wide and p.nj == 4 and p.n_dt == 16384 // 4 // 128
    assert p.smem == ta.paged_smem(esize, 16384, p.nj, p.wide, p.wq, p.tt, p.stages)
    assert p.smem <= H100["smem_optin"]
    assert p.wq == {1: 1, 8: 8}[K] and p.split_len * p.n_split >= 4 * 16
    # the narrow plans at config 12's decode shape are unchanged
    tt, stages, smem = NARROW_B32_T128[esize]
    assert ta.paged_plan(32, K, 8, 128, 16, 8, esize, 16, **H100) == ta.PagedPlan(
        vb=16, nj=1, wide=False, n_dt=1, wq=K, tt=tt, stages=stages, n_split=1, split_len=128,
        smem=smem)


@pytest.mark.parametrize("W,ptrs,want", [
    (2048, (0, 1 << 20), (4, 16, 128)),
    (1024, (256, 512), (4, 16, 128)),
    (53, (0, 256), (1, 16, 32)),       # W not a multiple of 4: one column a lane
    (4, (0, 256), (4, 16, 128)),
    (1, (0, 256), (1, 16, 32)),
    (2048, (4, 256), (1, 16, 32)),     # a base off 16-byte alignment
])
def test_hbm_step_plan(W, ptrs, want):
    assert th.hbm_step_plan(W, *ptrs) == want
