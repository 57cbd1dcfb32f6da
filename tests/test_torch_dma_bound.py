"""The copy-rate probes (``tpuscratch_torch.bench.dma_bound``) on the CPU:
every probe's plain path against ``x.clone()`` / ``x * c`` (the kernels
are held to the same on the card, ``tests/test_torch_cuda.py``), the
factories' argument checks, and the race's plumbing at a small array. The
module imports without nvcc or triton (``tests/test_torch_imports.py``)."""

import pytest
import torch

from _torch_twins import rand, to_torch
from tpuscratch_torch.bench import dma_bound as tb


@pytest.mark.parametrize("name", [n for n, _ in tb.probes()])
def test_plain_probes(name):
    step = dict(tb.probes())[name]
    x = to_torch(rand((8, 6, 4), 3))
    c = torch.full((1,), 1.0 + 2 ** -20)
    want = x * c if "touch" in name else x.clone()
    tb.reset_launches()
    got = step(x, c)
    assert torch.equal(got, want) and got.data_ptr() != x.data_ptr()
    assert sum(tb.launch_counts().values()) == 0  # the plain path launches nothing


def test_probe_lists_fit_the_card():
    # every ring of the card's lists fits 227 KB of shared memory a block
    for chunk, nbuf, mode in tb.MANUAL:
        assert 1024 + 2 * nbuf * chunk <= 232_448 and chunk % 16 == 0
    for chunk, nbuf, lanes in tb.LANES:
        assert 1024 + lanes * 2 * nbuf * chunk <= 232_448 and chunk % 16 == 0
    assert tb.BYTES == 256 * 2 ** 20
    assert sorted(w.__name__ for w in tb.WRAPPERS) == [
        "hbm2hbm", "kway_hbm2hbm", "lanes_stream", "manual_stream"]


def test_argument_checks():
    with pytest.raises(ValueError, match="nbuf"):
        tb.manual_stream(4096, 5, "copy")
    with pytest.raises(ValueError, match="mode"):
        tb.manual_stream(4096, 2, "direct")
    with pytest.raises(ValueError, match="lanes"):
        tb.lanes_stream(4096, 2, 16)


def test_race_plumbing_at_a_small_array(monkeypatch):
    for name, n in (("NZ", 4), ("CY", 8), ("CX", 8)):
        monkeypatch.setattr(tb, name, n)
    r = tb.race("copy", tb.copy_plain, steps_lo=2, steps_hi=6, iters=1, device="cpu")
    assert r["name"] == "copy" and set(r) == {"name", "ms", "gbps"}


# ---- the host's grid and ring models (csrc/copy_probes.cu) -------------------


@pytest.mark.parametrize("K", tb.KWAY)
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_kway_share_is_one_wave_in_all(K, per_sm):
    # each of the K slab launches gets at least one block, and the K
    # launches together at most one resident wave, so they run side by side
    n_sm = 132
    chunk = tb.HBM2HBM[0]
    blocks = [tb.probe_blocks(tb.BYTES // K, chunk, 1, n_sm, per_sm, share=K) for _ in range(K)]
    assert min(blocks) >= 1
    assert sum(blocks) <= n_sm * per_sm
    assert tb.probe_blocks(tb.BYTES, chunk, 1, n_sm, per_sm) == n_sm * per_sm  # one launch: a wave


@pytest.mark.parametrize("lanes", range(1, 16))
@pytest.mark.parametrize("nbytes,chunk", [(tb.BYTES, 32768), (8 * 37 * 12 * 4, 4096),
                                          (16 * 1000 + 16, 16384), (16, 16),
                                          (16 * 100_003, 2048)])
def test_ring_chunks_cover_every_chunk_once(lanes, nbytes, chunk):
    # static rings and rings drawing from the counter, every chunk once, each
    # ring in index order; the counter is back at 0 after the launch
    nchunks = -(-nbytes // chunk)
    rings = tb.probe_blocks(nbytes, chunk, lanes, 132, 1) * lanes
    static = tb.ring_chunks(nchunks, rings)
    assert len(static) == rings
    assert sorted(c for r in static for c in r) == list(range(nchunks))
    assert all(len(r) for r in static[:rings - lanes])  # every ring but the last block's
    for seed in range(3):
        drawn, counter = tb.drawn_chunks(nchunks, rings, chunk, seed)
        assert counter == 0
        assert sorted(c for r in drawn for c in r) == list(range(nchunks))
        assert all(r == sorted(r) for r in drawn)


def test_retuned_probe_lists_fit_the_card():
    # every ring of the card's lists, with the mbarriers ahead of the
    # stages, fits the H100's 232,448 B of opt-in shared memory a block
    assert tb.SMEM_OPTIN == 232_448
    rings = [("copy" if mode == "copy" else "touch", nbuf, chunk, 1)
             for chunk, nbuf, mode in tb.MANUAL]
    rings += [("touch", nbuf, chunk, lanes) for chunk, nbuf, lanes in tb.LANES]
    rings += [("direct", tb.HBM2HBM[1], tb.HBM2HBM[0], 1)]
    for mode, nbuf, chunk, lanes in rings:
        assert tb.probe_smem(mode, nbuf, chunk, lanes) <= tb.SMEM_OPTIN, (mode, nbuf, chunk)
        assert chunk % 16 == 0 and nbuf in (2, 3, 4) and 1 <= lanes <= 15
    assert tb.FLAGS & ~(tb.DYNAMIC | tb.EVICT_FIRST | tb.PDL) == 0


def test_flag_checks():
    with pytest.raises(ValueError, match="flags"):
        tb.hbm2hbm(flags=8)
    with pytest.raises(ValueError, match="flags"):
        tb.kway_hbm2hbm(2, flags=16)
    x, c = to_torch(rand((8, 6, 4), 4)), torch.full((1,), 3.0)
    for flags in range(8):  # the plain path ignores the design switches
        assert torch.equal(tb.lanes_stream(4096, 2, 3, flags=flags)(x, c), x * c)
        assert torch.equal(tb.kway_hbm2hbm(4, flags=flags)(x, c), x)
