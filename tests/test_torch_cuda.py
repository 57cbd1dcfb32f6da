"""The hand-written CUDA kernels on the card, held to their plain torch
versions on the same inputs. The kernels round every product and sum on
its own in the plain versions' order, so the results must be equal bit
for bit — also against the plain path run on the CPU.

Imports no JAX, so it runs on a card host without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from tpuscratch_torch.halo.driver import distributed_stencil
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import rebuild
from tpuscratch_torch.ops import stencil_kernel as tk

pytestmark = pytest.mark.cuda

GENERAL = (0.3, 0.15, 0.2, 0.25, 0.1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(shape, seed, device):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("fn", [tk.five_point_pallas, tk.five_point_blocked])
@pytest.mark.parametrize("lead,lay", [((), (37, 53, 1, 1)), ((2, 3), (19, 23, 2, 3))])
def test_five_point(card, fn, lead, lay):
    lay = TileLayout(*lay)
    tile = _rand(lead + lay.padded_shape, 1, card)
    want = rebuild(tile, tk.five_point_plain(tile, lay, GENERAL), lay)
    assert torch.equal(fn(tile, lay, GENERAL), want)


@pytest.mark.parametrize("lead,lay,sub", [
    ((), (37, 53, 4, 4), 3), ((2, 4), (19, 23, 3, 3), 3),
    ((), (150, 130, 70, 70), 70),  # deeper than one launch holds
])
def test_deep_trapezoid(card, lead, lay, sub):
    lay = TileLayout(*lay)
    tile = _rand(lead + lay.padded_shape, 2, card)
    assert torch.equal(tk.deep_trapezoid_pallas(tile, lay, sub, GENERAL),
                       tk.deep_trapezoid_plain(tile, lay, sub, GENERAL))


@pytest.mark.parametrize("coeffs", [tk.JACOBI, GENERAL])
@pytest.mark.parametrize("shape,steps", [((37, 53), 17), ((1024, 1024), 8)])
def test_resident(card, coeffs, shape, steps):
    core = _rand(shape, 3, card)
    assert torch.equal(tk.resident_periodic_pallas(core, steps, coeffs),
                       tk.resident_periodic_plain(core, steps, coeffs))


@pytest.mark.parametrize("impl,halo", [("xla", 1), ("pallas", 1), ("blocked", 1),
                                       ("overlap", 1), ("deep", 4), ("deep-pallas", 4),
                                       ("resident", 1)])
def test_card_path_equals_cpu_path(card, impl, halo):
    world = np.random.default_rng(4).standard_normal((64, 96)).astype(np.float32)
    on_card = distributed_stencil(world, 8, halo=(halo, halo), impl=impl)
    on_cpu = distributed_stencil(world, 8, halo=(halo, halo), impl=impl, device="cpu")
    np.testing.assert_array_equal(on_card, on_cpu)


def test_explicit_cuda_device(card):
    world = np.random.default_rng(5).standard_normal((32, 32)).astype(np.float32)
    out = distributed_stencil(world, 2, impl="pallas", device="cuda")
    np.testing.assert_array_equal(out, distributed_stencil(world, 2, impl="pallas"))


def test_counts_launches(card):
    tk.reset_launches()
    lay = TileLayout(16, 16, 2, 2)
    tile = torch.zeros(lay.padded_shape, device=card)
    tk.five_point_pallas(tile, lay)
    tk.deep_trapezoid_pallas(tile, lay, 2)
    tk.resident_periodic_pallas(torch.zeros(16, 16, device=card), 3)
    assert tk.launch_counts() == {"five_point_pallas": 1, "five_point_blocked": 0,
                                  "deep_trapezoid_pallas": 1, "resident_periodic_pallas": 1}


def test_refusals(card):
    lay = TileLayout(8, 8, 1, 1)
    with pytest.raises(TypeError, match="float32"):
        tk.five_point_pallas(torch.zeros(lay.padded_shape, device=card, dtype=torch.float64), lay)
    wide = torch.zeros(lay.padded_shape[0], 2 * lay.padded_shape[1], device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tk.five_point_pallas(wide[:, ::2], lay)
