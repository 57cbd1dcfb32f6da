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
