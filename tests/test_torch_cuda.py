"""The hand-written CUDA kernels on the card, held to their plain torch
versions on the same inputs. The stencil kernels (``stencil2d.cu``,
``stencil_stream2d.cu``, ``halo_dma.cu``) round every product and sum on
its own in the plain versions' order, so the results must be equal bit
for bit — also against the plain path run on the CPU. The dot kernels
sum in another order than their plain versions (tolerance below); fill
and iota2d are bit-equal.

Imports no JAX, so it runs on a card host without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips (the kernels have no CPU mode).
"""

import importlib

import numpy as np
import pytest
import torch

from tpuscratch_torch.bench.dot_bench import dot_program
from tpuscratch_torch.bench.pingpong import pinned_staging_roundtrip, verify_echo
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.halo.driver import distributed_stencil
from tpuscratch_torch.ops import halo_dma as th
from tpuscratch_torch.ops import stencil_stream as ts
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import rebuild
from tpuscratch_torch.ops import reduction as tr
from tpuscratch_torch.ops import stencil_kernel as tk
from tpuscratch_torch.runtime.mesh import make_mesh_1d, make_mesh_2d

# ``ops`` exports the function fill, which shadows the module's name there
tf = importlib.import_module("tpuscratch_torch.ops.fill")

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
                                       ("resident", 1), ("stream:4", 1), ("dma", 1),
                                       ("dma-deep:4", 1), ("dma-hbm", 1)])
def test_card_path_equals_cpu_path(card, impl, halo):
    world = np.random.default_rng(4).standard_normal((64, 96)).astype(np.float32)
    on_card = distributed_stencil(world, 8, halo=(halo, halo), impl=impl)
    on_cpu = distributed_stencil(world, 8, halo=(halo, halo), impl=impl, device="cpu")
    np.testing.assert_array_equal(on_card, on_cpu)


# the streamed and DMA-halo kernels: ragged stacked shapes, 5 and 9 points
C9 = (0.15, 0.15, 0.1, 0.1, 0.05, 0.05, 0.08, 0.07, 0.25)


@pytest.mark.parametrize("lead,hw,k,ghost,coeffs", [
    ((), (37, 53), 3, False, GENERAL), ((2, 3), (37, 53), 3, True, C9),
    ((2, 2), (64, 64), 8, True, tk.JACOBI), ((1, 1), (37, 53), 1, False, C9),
    ((2, 2), (40, 9), 9, True, GENERAL),  # ghost slabs as wide as the core
])
def test_stream2d(card, lead, hw, k, ghost, coeffs):
    H, W = hw
    core, top, bot = (_rand(lead + s, 14 + i, card) for i, s in
                      enumerate(((H, W), (k, W), (k, W))))
    gl = _rand(lead + (H + 2 * k, k), 17, card) if ghost else None
    gr = _rand(lead + (H + 2 * k, k), 18, card) if ghost else None
    flags = torch.from_numpy(np.random.default_rng(19).integers(0, 2, lead + (4,))).int().to(card)
    got = ts.nine_point_streamed_2d(core, top, bot, hw, coeffs, k, open_flags=flags, gl=gl, gr=gr)
    assert torch.equal(got, ts.nine_point_streamed_2d_plain(core, top, bot, coeffs, k, flags,
                                                            gl, gr))


@pytest.mark.parametrize("coeffs", [tk.JACOBI, GENERAL])
@pytest.mark.parametrize("dims", [(1, 1), (2, 3)])
def test_dma_ring(card, coeffs, dims):
    cores = _rand(dims + (37, 53), 20, card)
    assert torch.equal(th.dma_ring(cores, 7, coeffs), th.dma_ring_plain(cores, 7, coeffs))


@pytest.mark.parametrize("depth,steps,coeffs", [(1, 3, C9), (3, 7, C9), (8, 19, tk.JACOBI),
                                                (3, 5, GENERAL)])
def test_dma_deep(card, depth, steps, coeffs):
    cores = _rand((2, 3, 37, 53), 21, card)
    assert torch.equal(th.dma_deep(cores, steps, coeffs, depth),
                       th.dma_deep_plain(cores, steps, coeffs, depth))


@pytest.mark.parametrize("coeffs", [tk.JACOBI, GENERAL, C9])
def test_dma_hbm_step(card, coeffs):
    cores = _rand((2, 3, 37, 53), 22, card)
    assert torch.equal(th.dma_hbm_step(cores, coeffs), th.dma_hbm_step_plain(cores, coeffs))


@pytest.mark.parametrize("impl", ["stream:3", "dma", "dma-deep:3", "dma-hbm"])
@pytest.mark.parametrize("coeffs", [tk.JACOBI, C9])
def test_new_impls_card_equals_cpu_on_a_mesh(card, impl, coeffs):
    world = np.random.default_rng(23).standard_normal((74, 106)).astype(np.float32)
    periodic = (False, True) if impl.startswith("stream") else True
    on_card = distributed_stencil(world, 7, mesh=make_mesh_2d((2, 2)), impl=impl,
                                  coeffs=coeffs, periodic=periodic)
    on_cpu = distributed_stencil(world, 7, mesh=make_mesh_2d((2, 2), device="cpu"), impl=impl,
                                 coeffs=coeffs, periodic=periodic)
    np.testing.assert_array_equal(on_card, on_cpu)


def test_new_kernels_count_launches(card):
    ts.reset_launches()
    th.reset_launches()
    world = np.zeros((32, 32), np.float32)
    distributed_stencil(world, 9, mesh=make_mesh_2d((2, 2)), impl="stream:4")  # 2 + 1 passes
    distributed_stencil(world, 9, mesh=make_mesh_2d((2, 2)), impl="dma")
    distributed_stencil(world, 9, mesh=make_mesh_2d((2, 2)), impl="dma-deep:4")
    distributed_stencil(world, 2, mesh=make_mesh_2d((2, 2)), impl="dma-hbm")
    assert ts.launch_counts() == {"nine_point_streamed_2d": 3}
    assert th.launch_counts() == {"dma_ring": 1, "dma_deep": 3, "dma_hbm_step": 2}


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


# ---------------------------------------------------------------------------
# csrc/reduction.cu and csrc/fill.cu
#
# Tolerance of a dot kernel against its plain version on unit-normal data:
# 1e-5 * sum|(x+o)*y| (the kernels sum in another order, with fmaf); on
# ones, where every partial is an integer below 2**24, bit-equal. fill and
# iota2d write the same bits as their plain versions.

RTOL_SUM = 1e-5
FILL_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64]


def _dot_close(got, want, x, y, offset=0.0):
    bound = RTOL_SUM * ((x.double() + offset) * y.double()).abs().sum(-1)
    assert bool(((got.double() - want.double()).abs() <= bound).all()), (got, want)


@pytest.mark.parametrize("dtype", FILL_DTYPES)
@pytest.mark.parametrize("shape", [(37, 53), (8, 128), (3,), (1000, 1001)])
def test_fill_kernel(card, dtype, shape):
    value = 7 if not dtype.is_floating_point else 0.1
    got = tf.fill(shape, value, dtype)
    assert got.is_cuda and got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, tf.fill_plain(shape, value, dtype, card))
    assert torch.equal(got.cpu(), tf.fill(shape, value, dtype, device="cpu"))


@pytest.mark.parametrize("dtype", FILL_DTYPES)
@pytest.mark.parametrize("shape", [(37, 53), (8, 128), (5, 257), (300, 70000)])
def test_iota2d_kernel(card, dtype, shape):
    # exact, with inf and NaN in the same places (w = 70000 overflows
    # float16 to inf, and row 0 is 0 * inf)
    got = tf.iota2d(shape, dtype)
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, tf.iota2d_plain(shape, dtype, card), **exact)
    torch.testing.assert_close(got.cpu(), tf.iota2d(shape, dtype, device="cpu"), **exact)


@pytest.mark.parametrize("method", ["full", "partials"])
@pytest.mark.parametrize("lead,n,block_rows,dtypes", [
    ((), 3000, 8, (torch.float32, torch.float32)),
    ((), 4099, 8, (torch.float32, torch.float32)),        # n % 8 != 0: element loads
    ((8,), 2048, 2, (torch.float32, torch.float32)),      # 8 stacked ranks
    ((), 8192, 8, (torch.bfloat16, torch.bfloat16)),
    ((2, 3), 1000, 512, (torch.bfloat16, torch.float32)),
    ((), 1 << 20, 512, (torch.float32, torch.float32)),
])
def test_dot_kernels(card, method, lead, n, block_rows, dtypes):
    x = _rand(lead + (n,), 6, card).to(dtypes[0])
    y = _rand(lead + (n,), 7, card).to(dtypes[1])
    off = torch.full(lead, 0.25, device=card) if lead else 0.25
    got = tr.dot(x, y, method, block_rows=block_rows, offset=off)
    chunk = tr._chunk(n, block_rows)
    if method == "full":
        want = tr.dot_full_plain(x, y, off)
    else:
        want = tr.dot_partials_plain(x, y, chunk, off).sum(-1)
    assert got.dtype == torch.float32 and got.shape == lead
    _dot_close(got, want, x.float(), y.float(), 0.25)
    _dot_close(got.cpu(), tr.dot(x.cpu(), y.cpu(), method, block_rows=block_rows,
                                 offset=off.cpu() if lead else off), x.float().cpu(),
               y.float().cpu(), 0.25)
    ones = torch.ones(lead + (n,), device=card, dtype=dtypes[0])
    assert torch.equal(tr.dot(ones, ones.clone().to(dtypes[1]), method, block_rows=block_rows),
                       torch.full(lead, float(n), device=card))


def test_dot_partials_kernel_per_chunk(card):
    x, y = _rand((3, 5000), 8, card), _rand((3, 5000), 9, card)
    got = tr._partials_launch(x, y, 1024, None, "probe")
    want = tr.dot_partials_plain(x, y, 1024)
    for c in range(got.shape[-1]):  # each chunk against its own bound
        chunk = slice(c * 1024, (c + 1) * 1024)
        _dot_close(got[:, c], want[:, c], x[:, chunk], y[:, chunk])


def test_dot_full_is_deterministic(card):
    x, y = _rand((1 << 22,), 10, card), _rand((1 << 22,), 11, card)
    first = tr.dot(x, y, "full")
    for _ in range(3):
        assert torch.equal(tr.dot(x, y, "full"), first)


@pytest.mark.parametrize("method", ["full", "partials", "xla"])
def test_dot_program_card_equals_cpu(card, method):
    x, y = _rand((8 * 3000,), 12, card), _rand((8 * 3000,), 13, card)
    mesh = make_mesh_1d("x", 8)
    got = dot_program(mesh, "x", method, block_rows=8, rounds=3)(x, y)
    want = dot_program(make_mesh_1d("x", 8, device="cpu"), "x", method, block_rows=8,
                       rounds=3)(x.cpu(), y.cpu())
    _dot_close(got.cpu(), want, x.cpu(), y.cpu())
    psum = run_spmd(mesh, lambda a, b: tr.local_dot_psum(a, b, "x", method), (P("x"), P("x")), P())
    _dot_close(psum(x, y).cpu(), want, x.cpu(), y.cpu())


def test_reduction_and_fill_count_launches(card):
    tr.reset_launches()
    tf.reset_launches()
    x = tf.fill((4, 1000), 1.0)
    tf.iota2d((3, 4))
    tr.dot(x, x, "full")
    tr.dot(x, x, "partials")
    tr.dot(x, x, "xla")
    x2, y2, _, block = tr.prep(x, x, 8)
    tr.dot_prepped(x2, y2, block, "full")
    assert tf.launch_counts() == {"fill": 1, "iota2d": 1}
    assert tr.launch_counts() == {"dot_partials_prepped": 1, "dot_full_prepped": 2}


def test_reduction_refusals(card):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tr.dot(torch.ones(8, device=card, dtype=torch.float64), torch.ones(8, device=card))
    wide = torch.ones(8, 16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tr.dot(wide[:, ::2], wide[:, ::2])


def test_pingpong_and_pinned_staging(card):
    assert verify_echo(make_mesh_1d("x", 2), "x", 1 << 20)
    for pinned in (True, False):
        res = pinned_staging_roundtrip(1 << 16, pinned=pinned, iters=2)
        assert res.bytes_moved == 2 * (1 << 18)
