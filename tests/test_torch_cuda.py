"""The hand-written CUDA kernels on the card, held to their plain torch
versions on the same inputs. The paged-attention kernel
(``paged_attention.cu``) sums in another order than its plain version and
dequantizes before the dot product instead of after, and the flash kernels
(``flash_attention.cu``) sum in another order too (tolerances below). The
stencil kernels (``stencil2d.cu``,
``stencil3d.cu``, ``stencil_stream2d.cu``, ``stencil_stream3d.cu``,
``halo_dma.cu``) round every product and sum on
its own in the plain versions' order, so the results must be equal bit
for bit — also against the plain path run on the CPU. The dot kernels
sum in another order than their plain versions (tolerance below); fill
and iota2d are bit-equal. The fused Adam kernel (``adam.cu``) and the
copy probes (``copy_probes.cu``) round every operation as their plain
versions do: bit-equal, also for the ZeRO step that runs the kernel, and
the pipelined plan step's overlap schedule is bit-equal to its serial one.
The 3D multigrid's streamed smoother, run on the card, is bit-equal to the
same call on the CPU, and a ``jacobi-stream`` solve launches the streamed
kernel as often as ``multigrid3d.stream_launches`` says. The async
checkpoint's snapshot holds the values its tree had, whatever the streams
do before and after it, and the guarded train step on the card gives the
CPU run's statuses.

Imports no JAX, so it runs on a card host without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips (the kernels have no CPU mode).
"""

import importlib
import math

import numpy as np
import pytest
import torch

from tpuscratch_torch.bench.dot_bench import dot_program
from tpuscratch_torch.bench.pingpong import pinned_staging_roundtrip, verify_echo
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.halo.driver import distributed_stencil
from tpuscratch_torch.ops import attention as ta
from tpuscratch_torch.ops import common as tc
from tpuscratch_torch.ops import halo_dma as th
from tpuscratch_torch.ops import stencil_stream as ts
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import rebuild
from tpuscratch_torch.ops import reduction as tr
from tpuscratch_torch.ops import stencil_kernel as tk
from tpuscratch_torch.halo.halo3d import distributed_stencil3d
from tpuscratch_torch.runtime.mesh import make_mesh, make_mesh_1d, make_mesh_2d
from tpuscratch_torch.serve.kvcache import quantize_pages
from tpuscratch_torch.bench import dma_bound as tb
from tpuscratch_torch.ops import adam as tadam

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


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits: -0.0 and +0.0 differ, a NaN equals a NaN of
    the same payload (both sides run on the card: CUDA's canonical NaN)."""
    return t.view(torch.int32)


# halos (1, 1), (2, 3) (an odd pitch: single columns) and (4, 4), stacked
# batches, and bases 4 and 8 bytes past 16-byte alignment (views into a
# larger buffer): the fresh padded tile bit-equal to the plain core and
# rebuild, the input unchanged
@pytest.mark.parametrize("fn", [tk.five_point_pallas, tk.five_point_blocked])
@pytest.mark.parametrize("lead,lay,off", [
    ((), (37, 53, 1, 1), 0), ((2, 3), (19, 23, 2, 3), 0), ((), (64, 62, 4, 4), 0),
    ((2, 4), (19, 24, 1, 1), 0), ((), (64, 62, 1, 1), 1), ((), (64, 62, 1, 1), 2),
    ((2, 4), (30, 40, 2, 3), 1), ((), (1, 1, 1, 1), 0),
])
@pytest.mark.parametrize("coeffs", [GENERAL, tk.JACOBI])
def test_five_point(card, fn, lead, lay, off, coeffs):
    lay = TileLayout(*lay)
    shape = lead + lay.padded_shape
    tile = _rand((math.prod(shape) + off,), 1, card)[off:].view(shape)
    before = tile.clone()
    want = rebuild(tile, tk.five_point_plain(tile, lay, coeffs), lay)
    got = fn(tile, lay, coeffs)
    assert got.data_ptr() != tile.data_ptr()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(tile), _bits(before))


@pytest.mark.parametrize("vec", [4, 2, 1])
def test_five_point_other_plans(card, vec):
    # every load width: the same bits
    lay = TileLayout(45, 60, 2, 2)  # pw 64: 16-byte rows
    tile = _rand((3,) + lay.padded_shape, 14, card)
    want = rebuild(tile, tk.five_point_plain(tile, lay, GENERAL), lay)
    got = tk._five_point_launch(tile, lay, GENERAL, "test", vec)
    assert torch.equal(_bits(got), _bits(want))


ZERO_SIDE = (0.25, 0.0, 0.25, 0.25, 0.25)


def _signed_zero_tile(shape, seed, device):
    """Unit-normal data holding one inf and a 16 x 16 checkerboard of 1.0
    and -0.0: a step that drops a zero term gets an inf where the reference
    gets NaN (0 x inf), and -0.0 where it gets +0.0."""
    tile = _rand(shape, seed, device)
    i = torch.arange(16, device=device)
    tile[..., 20:36, 20:36] = torch.where((i[:, None] + i[None, :]) % 2 == 0, 1.0, -0.0)
    tile[..., 44, 47] = float("inf")
    return tile


@pytest.mark.parametrize("coeffs", [tk.JACOBI, ZERO_SIDE])
def test_deep_trapezoid_adds_zero_terms(card, coeffs):
    # shrink_step adds every term, a zero coefficient's product included:
    # the kernel must too (bits compared: torch.equal counts -0.0 and +0.0
    # equal, and a NaN unequal to itself)
    lay = TileLayout(64, 64, 4, 4)
    tile = _signed_zero_tile(lay.padded_shape, 15, card)
    want = tk.deep_trapezoid_plain(tile, lay, 4, coeffs)
    assert bool(torch.isnan(want).any())
    assert torch.equal(_bits(tk.deep_trapezoid_pallas(tile, lay, 4, coeffs)), _bits(want))
    for five in (tk.five_point_pallas, tk.five_point_blocked):
        want = rebuild(tile, tk.five_point_plain(tile, lay, coeffs), lay)
        assert torch.equal(_bits(five(tile, lay, coeffs)), _bits(want))


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


# the deep trapezoid's row march: one step past a launch (33: 32 + 1) with
# 4-byte and 16-byte rows, substeps below the halo with an odd crop (the
# window's start not a multiple of 4, or 16-byte rows), tiles narrower
# than the window, batches
@pytest.mark.parametrize("lead,lay,sub", [
    ((), (37, 53, 33, 33), 33), ((2,), (40, 62, 33, 33), 33),
    ((), (37, 53, 7, 7), 4), ((2, 2), (19, 23, 9, 9), 6), ((2,), (64, 128, 8, 8), 5),
    ((3,), (300, 520, 16, 16), 16),
])
def test_deep_trapezoid_march_edges(card, lead, lay, sub):
    lay = TileLayout(*lay)
    tile = _rand(lead + lay.padded_shape, 7, card)
    for coeffs in (tk.JACOBI, GENERAL):
        assert torch.equal(tk.deep_trapezoid_pallas(tile, lay, sub, coeffs),
                           tk.deep_trapezoid_plain(tile, lay, sub, coeffs))


@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("width,rows", [(None, None), (4, 1), (64, 7), (None, 1000)])
def test_deep_trapezoid_other_plans(card, levels, width, rows):
    # other levels a stage, strips and chunks than the rule's: the same bits
    lay, k = TileLayout(37, 52, 5, 5), 5
    tile = _rand((2, 3) + lay.padded_shape, 8, card)
    plan = tc.march_plan(6, 37, 52, k, 132, 4, levels=levels, width=width,
                         rows=min(rows, 37) if rows else None)
    for coeffs in (tk.JACOBI, GENERAL):
        out = torch.empty((2, 3, 37, 52), device=card)
        tk._trapezoid_call(tile, out, k, coeffs, plan)
        assert torch.equal(out, tk.deep_trapezoid_plain(tile, lay, k, coeffs))


# the resident kernel's folded rounds: fewer steps than a fold (1, 3), a
# remainder (5 = 4 + 1), each of its three sums (symmetric Jacobi, n s w e
# without a centre, with one), 4-byte (W % 4 != 0) and 16-byte rows
NO_CENTRE = (0.3, 0.15, 0.2, 0.25, 0.0)


@pytest.mark.parametrize("coeffs", [tk.JACOBI, NO_CENTRE, GENERAL])
@pytest.mark.parametrize("shape", [(37, 53), (64, 128), (3, 3)])
@pytest.mark.parametrize("steps", [1, 3, 5])
def test_resident_folds(card, coeffs, shape, steps):
    core = _rand(shape, 9, card)
    assert torch.equal(tk.resident_periodic_pallas(core, steps, coeffs),
                       tk.resident_periodic_plain(core, steps, coeffs))


@pytest.mark.parametrize("fold", [1, 2, 3, 4])
@pytest.mark.parametrize("per_sm", [1, 3])
def test_resident_other_plans(card, fold, per_sm):
    # other folds and grids than the rule's: the same bits
    core = _rand((130, 244), 10, card)
    plan = tk.resident_plan(130, 244, 19, 132, per_sm, fold=fold)
    for coeffs in (tk.JACOBI, GENERAL):
        assert torch.equal(tk._resident_launch(core, 19, coeffs, lambda _: plan),
                           tk.resident_periodic_plain(core, 19, coeffs))


@pytest.mark.parametrize("impl,halo", [("deep-pallas", 16), ("deep-pallas", 32), ("resident", 1)])
def test_headline_impls_card_equals_cpu_at_1024(card, impl, halo):
    world = np.random.default_rng(11).standard_normal((1024, 1024)).astype(np.float32)
    on_card = distributed_stencil(world, 64, halo=(halo, halo), impl=impl)
    on_cpu = distributed_stencil(world, 64, halo=(halo, halo), impl=impl, device="cpu")
    np.testing.assert_array_equal(on_card, on_cpu)


def test_deep_trapezoid_counts_a_launch_a_link(card):
    tk.reset_launches()
    lay = TileLayout(80, 72, 70, 70)
    tile = _rand(lay.padded_shape, 12, card)
    tk.deep_trapezoid_pallas(tile, lay, 70)
    tk.deep_trapezoid_pallas(tile, lay, 32)
    assert tk.launch_counts()["deep_trapezoid_pallas"] == 3 + 1  # 32 + 32 + 6, then 32


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


def _ring_device_plan(cores, steps, cap=None, fold=None):
    """The ring kernel's host rule on this card, with a cap on blocks an SM
    or another fold where given."""
    sms = torch.cuda.get_device_properties(cores.device).multi_processor_count
    vec = tc.ring_vec(cores.shape[-1], cores.data_ptr())
    per_sm = th._ring_per_sm(cores.device.index or 0, vec)
    return tc.ring_plan(*cores.shape, steps, sms, min(cap or per_sm, per_sm), fold=fold)


@pytest.mark.parametrize("steps", [1, 7, 64, 65])
@pytest.mark.parametrize("core", [(3, 3), (37, 53), (2048, 2048)])
@pytest.mark.parametrize("dims", [(1, 1), (2, 3)])
def test_dma_ring_plans(card, dims, core, steps):
    # folds of at most 4: steps 1 is one round of one step, 7 a round of 4
    # and one of 3, 64 sixteen rounds of 4, 65 ends in a round of one step;
    # cores of 3 cells (a window wraps the torus many times), W not a
    # multiple of 4 (scalar loads) and 2048 (16-byte rows)
    cores = _rand(dims + core, 25, card)
    plan = _ring_device_plan(cores, steps)
    assert plan.fold == min(steps, tc.RING_F)
    for coeffs in (tk.JACOBI, GENERAL):
        got = th._ring_launch(cores, steps, coeffs, plan)
        assert torch.equal(got, th.dma_ring_plain(cores, steps, coeffs))


@pytest.mark.parametrize("fold", [1, 3, 4])
@pytest.mark.parametrize("cap", [1, 3])
def test_dma_ring_other_plans(card, fold, cap):
    # other folds and grids than the rule's: the same bits
    cores = _rand((2, 3, 37, 53), 26, card)
    plan = _ring_device_plan(cores, 19, cap=cap, fold=fold)
    assert plan.fold == fold
    assert torch.equal(th._ring_launch(cores, 19, GENERAL, plan),
                       th.dma_ring_plain(cores, 19, GENERAL))


def test_dma_ring_wrapper_takes_the_rule(card):
    th.reset_launches()
    for core, width in (((1024, 1024), "vec4"), ((37, 53), "scalar")):
        cores = _rand((1, 1) + core, 27, card)
        assert torch.equal(th.dma_ring(cores, 64, GENERAL), th.dma_ring_plain(cores, 64, GENERAL))
        assert th.dma_ring.route == width
    assert th.launch_counts()["dma_ring"] == 2


@pytest.mark.parametrize("depth,steps,coeffs", [(1, 3, C9), (3, 7, C9), (8, 19, tk.JACOBI),
                                                (3, 5, GENERAL)])
def test_dma_deep(card, depth, steps, coeffs):
    cores = _rand((2, 3, 37, 53), 21, card)
    assert torch.equal(th.dma_deep(cores, steps, coeffs, depth),
                       th.dma_deep_plain(cores, steps, coeffs, depth))


# the row march of stream2d_kernel and dma_deep_kernel, across its edges:
# both template tap masks (Jacobi, 8 points without the centre) and sets
# under the runtime mask (5 points with a centre, all 9, a sparse set), W not a multiple of 4 (4-byte columns) and
# below one strip, k above W, cores of 3 cells, k = 32 and deeper passes
# chained through dense grids (k = 33, 81), and plans other than the rule's
SPARSE = (0.1, 0.0, 0.2, 0.3, 0.05, 0.0, 0.0, 0.0, 0.2)
NINE = (0.125,) * 4 + (0.0625,) * 4 + (0.0,)
MARCH_COEFFS = [tk.JACOBI, GENERAL, NINE, C9, SPARSE]


def _stream2d_operands(lead, H, W, k, ghost, flags, card, seed):
    core, top, bot = (_rand(lead + s, seed + i, card) for i, s in
                      enumerate(((H, W), (k, W), (k, W))))
    gl = _rand(lead + (H + 2 * k, k), seed + 3, card) if ghost else None
    gr = _rand(lead + (H + 2 * k, k), seed + 4, card) if ghost else None
    if flags is None:
        flags = np.random.default_rng(seed + 5).integers(0, 2, lead + (4,))
    return core, top, bot, gl, gr, torch.as_tensor(np.asarray(flags)).int().to(card)


@pytest.mark.parametrize("coeffs", MARCH_COEFFS)
@pytest.mark.parametrize("lead,hw,k,ghost", [
    ((1, 1), (37, 53), 16, False),    # W not a multiple of 4, below one strip
    ((2, 2), (64, 9), 9, True),       # ghost columns as wide as the core
    ((1,), (40, 9), 16, False),       # k > W: the window wraps x many times
    ((2, 2), (3, 3), 3, True),        # cores of 3 cells
    ((1, 1), (3, 3), 3, False),
    ((1, 1), (100, 600), 32, False),  # k = 32 over three strips, 16-byte groups
    ((2, 1), (90, 300), 33, True),    # chained: 32 + 1
    ((1, 1), (90, 100), 81, False),   # chained: 32 + 32 + 17
    ((2, 3), (81, 100), 81, True),
])
def test_stream2d_march_edges(card, lead, hw, k, ghost, coeffs):
    H, W = hw
    core, top, bot, gl, gr, flags = _stream2d_operands(lead, H, W, k, ghost, None, card, 30)
    got = ts.nine_point_streamed_2d(core, top, bot, hw, coeffs, k, open_flags=flags, gl=gl, gr=gr)
    assert torch.equal(got, ts.nine_point_streamed_2d_plain(core, top, bot, coeffs, k, flags,
                                                            gl, gr))


@pytest.mark.parametrize("k", [3, 8, 40])
def test_stream2d_open_ends_of_a_mesh(card, k):
    # a 3x3 mesh whose edge ranks are open on their outer sides and whose
    # interior rank is not: strips and chunks at an open end and inside
    flags = [[[r == 0, r == 2, c == 0, c == 2] for c in range(3)] for r in range(3)]
    core, top, bot, gl, gr, f = _stream2d_operands((3, 3), 70, 300, k, True, flags, card, 40)
    for coeffs in (tk.JACOBI, C9):
        got = ts.nine_point_streamed_2d(core, top, bot, (70, 300), coeffs, k, open_flags=f,
                                        gl=gl, gr=gr)
        assert torch.equal(got, ts.nine_point_streamed_2d_plain(core, top, bot, coeffs, k, f,
                                                                gl, gr))


@pytest.mark.parametrize("open_", [True, False])
@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("width,rows", [(None, None), (4, 1), (64, 7), (None, 1000)])
def test_stream2d_other_plans(card, levels, width, rows, open_):
    # other levels a stage, strips (as narrow as 4 columns, below k) and
    # chunks than the rule's, in the kernel with the open ends' zeroing
    # (random open flags) and without it (none): the same bits
    k, lead, H, W = 5, (2, 2), 37, 120
    flags = None if open_ else np.zeros(lead + (4,), np.int32)
    core, top, bot, gl, gr, flags = _stream2d_operands(lead, H, W, k, True, flags, card, 50)
    plan = tc.march_plan(4, H, W, k, 132, 4, levels=levels, width=width,
                         rows=min(rows, H) if rows else None)
    for coeffs in (GENERAL, C9):
        got = ts._launch(core, top, bot, gl, gr, flags, coeffs, k, plans=[plan], open_=open_)
        assert torch.equal(got, ts.nine_point_streamed_2d_plain(core, top, bot, coeffs, k, flags,
                                                                gl, gr))


@pytest.mark.parametrize("coeffs", MARCH_COEFFS)
@pytest.mark.parametrize("dims,core,steps,depth", [
    ((1, 1), (3, 3), 7, 3),           # cores of 3 cells: the window wraps the torus
    ((2, 3), (37, 53), 19, 8),        # W not a multiple of 4
    ((2, 3), (37, 53), 5, 1),         # depth 1, the 9-point dma path's rounds
    ((2, 2), (64, 128), 17, 16),      # 16-byte groups across rank edges
    ((1, 1), (64, 300), 64, 32),
    ((2, 2), (40, 9), 33, 33),        # a round chained: 32 + 1
    ((1, 1), (90, 100), 81, 81),      # 32 + 32 + 17
])
def test_dma_deep_march_edges(card, dims, core, steps, depth, coeffs):
    cores = _rand(dims + core, 31, card)
    assert torch.equal(th.dma_deep(cores, steps, coeffs, depth),
                       th.dma_deep_plain(cores, steps, coeffs, depth))


@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("width,rows", [(None, None), (4, 1), (64, 7), (None, 1000)])
def test_dma_deep_other_plans(card, levels, width, rows):
    cores = _rand((2, 3, 37, 52), 32, card)
    for coeffs in (GENERAL, NINE):
        plan = tc.march_plan(1, 2 * 37, 3 * 52, 5, 132, 4, levels=levels, width=width,
                             rows=min(rows, 74) if rows else None)
        assert torch.equal(th._deep_launch(cores, coeffs, plan),
                           th.dma_deep_plain(cores, 5, coeffs, 5))


@pytest.mark.parametrize("flags,open_", [(None, False), ([0, 0, 0, 0], False),
                                         ([0, 1, 0, 0], True), ("card", True)])
def test_stream2d_takes_the_open_variant_where_flags_may_be_set(card, flags, open_):
    if flags == "card":
        flags = torch.zeros(4, dtype=torch.int32, device=card)
    assert ts.may_open(flags) == open_
    per_rank = [[list(flags) if isinstance(flags, list) else [0] * 4]]
    core, top, bot, gl, gr, f = _stream2d_operands((1, 1), 40, 64, 6, True, per_rank, card, 70)
    got = ts.nine_point_streamed_2d(core, top, bot, (40, 64), C9, 6, open_flags=flags, gl=gl, gr=gr)
    assert torch.equal(got, ts.nine_point_streamed_2d_plain(core, top, bot, C9, 6, f, gl, gr))


def test_march_wrappers_count_one_launch_a_pass(card):
    ts.reset_launches()
    th.reset_launches()
    core, top, bot, gl, gr, flags = _stream2d_operands((1, 1), 64, 64, 32, False, None, card, 60)
    ts.nine_point_streamed_2d(core, top, bot, (64, 64), tk.JACOBI, 32, open_flags=flags)
    th.dma_deep(_rand((1, 1, 64, 64), 61, card), 64, NINE, 32)
    th.dma_deep(_rand((1, 1, 64, 64), 62, card), 3, C9, 1)
    assert ts.launch_counts()["nine_point_streamed_2d"] == 1
    assert th.launch_counts()["dma_deep"] == 2 + 3


@pytest.mark.parametrize("coeffs", [tk.JACOBI, GENERAL, C9])
def test_dma_hbm_step(card, coeffs):
    cores = _rand((2, 3, 37, 53), 22, card)
    assert torch.equal(th.dma_hbm_step(cores, coeffs), th.dma_hbm_step_plain(cores, coeffs))


@pytest.mark.parametrize("coeffs", [tk.JACOBI, C9])
@pytest.mark.parametrize("core", [(1, 1), (2, 3), (3, 1), (37, 53), (100, 392)])
@pytest.mark.parametrize("dims", [(1, 1), (2, 3), (4, 4)])
def test_dma_hbm_step_tiles(card, dims, core, coeffs):
    # cores of 1-3 cells (a neighbour is the rank itself, or one step
    # crosses two ranks' edges), W not a multiple of 4 (one column a lane),
    # and 100 x 392 (16-byte rows, tiles whose halo lies inside the core)
    cores = _rand(dims + core, 24, card)
    got = th.dma_hbm_step(cores, coeffs)
    assert th.dma_hbm_step.route == ("vec4" if core[1] % 4 == 0 else "scalar")
    assert torch.equal(got, th.dma_hbm_step_plain(cores, coeffs))


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
    assert ts.launch_counts() == {"nine_point_streamed_2d": 3, "seven_point_streamed_pallas": 0}
    assert th.launch_counts() == {"dma_ring": 1, "dma_deep": 3, "dma_hbm_step": 2}


def test_explicit_cuda_device(card):
    world = np.random.default_rng(5).standard_normal((32, 32)).astype(np.float32)
    out = distributed_stencil(world, 2, impl="pallas", device="cuda")
    np.testing.assert_array_equal(out, distributed_stencil(world, 2, impl="pallas"))


def test_counts_launches(card):
    # one launch a call, also for the one-step wrappers, which run no
    # rebuild on the card
    tk.reset_launches()
    lay = TileLayout(16, 16, 2, 2)
    tile = torch.zeros((2, 3) + lay.padded_shape, device=card)
    tk.five_point_pallas(tile, lay)
    tk.five_point_blocked(tile, lay, band=5)
    tk.five_point_blocked(tile[0, 0], lay)
    tk.deep_trapezoid_pallas(tile[0, 0], lay, 2)
    tk.resident_periodic_pallas(torch.zeros(16, 16, device=card), 3)
    assert tk.launch_counts() == {"five_point_pallas": 1, "five_point_blocked": 2,
                                  "deep_trapezoid_pallas": 1, "resident_periodic_pallas": 1,
                                  "seven_point_banded_pallas": 0, "seven_point_strips_pallas": 0,
                                  "seven_point_assembled_pallas": 0}


def test_refusals(card):
    lay = TileLayout(8, 8, 1, 1)
    with pytest.raises(TypeError, match="float32"):
        tk.five_point_pallas(torch.zeros(lay.padded_shape, device=card, dtype=torch.float64), lay)
    wide = torch.zeros(lay.padded_shape[0], 2 * lay.padded_shape[1], device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tk.five_point_pallas(wide[:, ::2], lay)
    # a plan the pitch or the alignment does not allow: the launcher refuses
    # it, it never reads past a row or misaligned
    tile = torch.zeros(lay.padded_shape, device=card)  # pw 10
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk._five_point_launch(tile, lay, tk.JACOBI, "test", 4)
    off = torch.zeros(tile.numel() + 1, device=card)[1:].view(lay.padded_shape)
    with pytest.raises(RuntimeError, match="misaligned"):
        tk._five_point_launch(off, lay, tk.JACOBI, "test", 2)
    with pytest.raises(TypeError, match="iota2d"):
        tf.iota2d((3, 4), torch.float64, device=card)


# ---------------------------------------------------------------------------
# csrc/stencil3d.cu and csrc/stencil_stream3d.cu

JACOBI7 = (1 / 6,) * 6 + (0.0,)
GENERAL7 = (0.11, 0.13, 0.17, 0.19, 0.07, 0.05, 0.2)
C27 = tuple(np.linspace(0.01, 0.26, 26)) + (0.3,)
AXES3 = ("z", "row", "col")


def _arrivals3d(lead, shape, seed, card):
    cz, cy, cx = shape
    shapes = [shape, (1, cy, cx), (1, cy, cx), (cz, 1, cx), (cz, 1, cx), (cz, cy, 1), (cz, cy, 1)]
    return [_rand(lead + s, seed + i, card) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("lead,shape", [((), (11, 13, 17)), ((2, 1, 2), (11, 13, 17)),
                                        ((), (40, 9, 130)), ((2,), (1, 1, 1))])
@pytest.mark.parametrize("coeffs", [JACOBI7, GENERAL7])
def test_seven_point_one_step(card, lead, shape, coeffs):
    core, mz, pz, my, py, mx, px = _arrivals3d(lead, shape, 30, card)
    padded = _rand(lead + tuple(n + 2 for n in shape), 37, card)
    assert torch.equal(tk.seven_point_banded_pallas(padded, shape, coeffs),
                       tk.seven_point_banded_plain(padded, coeffs))
    zpad = torch.cat([mz, core, pz], dim=-3)
    assert torch.equal(tk.seven_point_strips_pallas(zpad, my, py, mx, px, shape, coeffs),
                       tk.seven_point_strips_plain(zpad, my, py, mx, px, coeffs))
    f = _rand(lead + shape, 38, card)
    for ys, xs, fterm in (((my, py), (mx, px), None), ((None, None), (mx, px), None),
                          ((my, py), (None, None), None), ((None, None), (None, None), f)):
        got = tk.seven_point_assembled_pallas(core, mz, pz, *ys, *xs, shape, coeffs,
                                              fterm=fterm, fc=0.3)
        assert torch.equal(got, tk.seven_point_assembled_plain(core, mz, pz, *ys, *xs, coeffs,
                                                               fterm, 0.3))


def _stream3d_inputs(lead, shape, k, ghost_y, ghost_x, card, rhs=False):
    cz, cy, cx = shape
    a = [_rand(lead + s, 40 + i, card) for i, s in enumerate((shape, (k, cy, cx), (k, cy, cx)))]
    kw = {}
    if ghost_y:
        kw["gy"] = _rand(lead + (cz + 2 * k, 2 * k, cx), 43, card)
    if ghost_x:
        kw["gx"] = _rand(lead + (cz + 2 * k, cy, 2 * k), 44, card)
    if ghost_y and ghost_x:
        kw["gc"] = _rand(lead + (cz + 2 * k, 2 * k, 2 * k), 45, card)
    if rhs:
        kw["rhs"] = _rand(lead + (cz + 2 * k, cy, cx), 46, card)
    flags = torch.from_numpy(np.random.default_rng(47).integers(0, 2, lead + (6,))).int().to(card)
    return a, kw, flags


@pytest.mark.parametrize("ghost_y,ghost_x", [(False, False), (True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("k", [1, 3, 4, 11])
def test_stream3d(card, ghost_y, ghost_x, k):
    # k = 11 is deeper than a block's shared memory seats: chained launches
    lead, shape = (2, 1, 2), (11, 13, 17)
    a, kw, flags = _stream3d_inputs(lead, shape, k, ghost_y, ghost_x, card)
    got = ts.seven_point_streamed_pallas(*a, shape, GENERAL7, k, open_flags=flags, **kw)
    want = ts.seven_point_streamed_plain(*a, GENERAL7, k, flags, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 11])
def test_stream3d_27_point_and_rhs(card, k):
    lead, shape = (2,), (11, 13, 17)
    a, kw, flags = _stream3d_inputs(lead, shape, k, False, False, card, rhs=True)
    got = ts.seven_point_streamed_pallas(*a, shape, GENERAL7, k, open_flags=flags,
                                         rhs_coeff=0.37, **kw)
    assert torch.equal(got, ts.seven_point_streamed_plain(*a, GENERAL7, k, flags,
                                                          rhs_coeff=0.37, **kw))
    got = ts.seven_point_streamed_pallas(*a, shape, C27, k, open_flags=flags)
    assert torch.equal(got, ts.seven_point_streamed_plain(*a, C27, k, flags))


def _stream3d_plan_on_card(shape, nb, k, nt):
    """The z-march plans a pass of depth k takes on this card."""
    j = min(k, ts.STREAM3D_MAX_J)
    go = k - j
    out = tuple(n + 2 * go for n in shape)
    return out, ts.stream3d_plan(out, nb, j, nt, *ts._stream3d_device(0, nt, j))


@pytest.mark.parametrize("case", ["ghosts", "open", "rhs", "27pt", "chained"])
def test_stream3d_z_march_tiles(card, case):
    # stacked ranks, a core whose depth is no multiple of the z chunk and
    # whose rows and columns are no multiple of the tile, with open flags,
    # the rhs term, 27 points, or a pass deeper than one launch
    lead, shape = (2, 1, 2), (47, 37, 70)
    k = {"chained": 10, "27pt": 3}.get(case, 4)
    ghost = case in ("ghosts", "open", "chained")
    a, kw, flags = _stream3d_inputs(lead, shape, k, ghost, ghost, card, rhs=case == "rhs")
    if case != "open":
        flags = torch.zeros_like(flags) if case != "ghosts" else flags
    coeffs = C27 if case == "27pt" else GENERAL7
    out, plan = _stream3d_plan_on_card(shape, 4, k, len(coeffs))
    assert out[1] % plan.ty and out[2] % plan.tx, plan
    assert case == "chained" or out[0] % plan.zc, plan
    rc = 0.37 if case == "rhs" else 0.0
    got = ts.seven_point_streamed_pallas(*a, shape, coeffs, k, open_flags=flags, rhs_coeff=rc,
                                         **kw)
    assert torch.equal(got, ts.seven_point_streamed_plain(*a, coeffs, k, flags, rhs_coeff=rc,
                                                          **kw))


@pytest.mark.parametrize("k", [2, 4])
def test_stream3d_config9_shape(card, k):
    # config 9's tile, the shape the 3D path times
    shape = (256, 512, 512)
    a, kw, flags = _stream3d_inputs((), shape, k, False, False, card)
    got = ts.seven_point_streamed_pallas(*a, shape, JACOBI7, k, open_flags=flags)
    assert torch.equal(got, ts.seven_point_streamed_plain(*a, JACOBI7, k, flags))


@pytest.mark.parametrize("impl", ["compact", "compact-pallas", "compact-strips", "compact-asm",
                                  "padded", "stream:3"])
@pytest.mark.parametrize("dims,periodic", [((1, 1, 1), True), ((2, 2, 2), True),
                                           ((1, 2, 2), (False, True, False))])
def test_3d_card_path_equals_cpu_path(card, impl, dims, periodic):
    world = np.random.default_rng(48).standard_normal((12, 20, 36)).astype(np.float32)
    on_card = distributed_stencil3d(world, 7, make_mesh(dims, AXES3), impl=impl,
                                    periodic=periodic, coeffs=GENERAL7)
    on_cpu = distributed_stencil3d(world, 7, make_mesh(dims, AXES3, "cpu"), impl=impl,
                                   periodic=periodic, coeffs=GENERAL7)
    np.testing.assert_array_equal(on_card, on_cpu)


def test_3d_kernels_count_launches(card):
    tk.reset_launches()
    ts.reset_launches()
    world = np.zeros((12, 8, 8), np.float32)
    for impl in ("compact-pallas", "compact-strips", "compact-asm"):
        distributed_stencil3d(world, 3, make_mesh((2, 1, 1), AXES3), impl=impl)
    distributed_stencil3d(world, 9, make_mesh((2, 1, 1), AXES3), impl="stream:4")  # 2 + 1 passes
    counts = {**tk.launch_counts(), **ts.launch_counts()}
    assert [counts[n] for n in ("seven_point_banded_pallas", "seven_point_strips_pallas",
                                "seven_point_assembled_pallas",
                                "seven_point_streamed_pallas")] == [3, 3, 3, 3]


def test_3d_refusals(card):
    z = torch.zeros((4, 6, 6), device=card, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        tk.seven_point_banded_pallas(z, (2, 4, 4), JACOBI7)
    with pytest.raises(TypeError, match="float32"):
        ts.seven_point_streamed_pallas(z, z[:1], z[:1], (4, 6, 6), JACOBI7, 1)


# ---------------------------------------------------------------------------
# csrc/reduction.cu and csrc/fill.cu
#
# Tolerance of a dot kernel against its plain version on unit-normal data:
# 1e-5 * sum|(x+o)*y| (the kernels sum in another order, with fmaf); on
# ones, where every partial is an integer below 2**24, bit-equal. fill and
# iota2d write the same bits as their plain versions.

RTOL_SUM = 1e-5
FILL_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64,
               torch.int8, torch.uint8, torch.int16]


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


@pytest.mark.parametrize("cap", [None, 1, 132])
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (37, 53)), (torch.int8, (3,)),
                                         (torch.bfloat16, (1000, 1001)),
                                         (torch.int64, (70_001,))])
def test_fill_kernel_on_smaller_grids(card, cap, dtype, shape):
    # the rule's grid (a block a 256 16-byte units) and grids that stride:
    # one block, one an SM
    nbytes = math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
    value = -7 if not dtype.is_floating_point else 0.1
    got = tf._fill_launch(torch.empty(shape, dtype=dtype, device=card), value,
                          tf.fill_blocks(nbytes, cap))
    assert torch.equal(got, tf.fill_plain(shape, value, dtype, card))


@pytest.mark.parametrize("dtype", FILL_DTYPES)
@pytest.mark.parametrize("shape", [(37, 53), (8, 128), (5, 257), (300, 70000),
                                   (1, 1), (3, 3), (7, 1), (1, 13), (2, 6), (300, 70001)])
def test_iota2d_kernel(card, dtype, shape):
    # exact, with inf and NaN in the same places (w = 70000 overflows
    # float16 to inf, and row 0 is 0 * inf); widths and sizes off a multiple
    # of 4 walk a 16-byte unit across row ends and leave a tail
    got = tf.iota2d(shape, dtype)
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, tf.iota2d_plain(shape, dtype, card), **exact)
    torch.testing.assert_close(got.cpu(), tf.iota2d(shape, dtype, device="cpu"), **exact)


@pytest.mark.parametrize("cap", [1, 3, 132])
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (37, 53)), (torch.bfloat16, (5, 257)),
                                         (torch.int64, (300, 71)), (torch.float16, (7, 1)),
                                         (torch.int8, (37, 53)), (torch.uint8, (5, 257)),
                                         (torch.int16, (300, 71))])
def test_iota2d_on_smaller_grids(card, cap, dtype, shape):
    # grids that stride over the units: the same elements
    nbytes = math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
    got = tf._iota_launch(torch.empty(shape, dtype=dtype, device=card), tf.fill_blocks(nbytes, cap))
    torch.testing.assert_close(got, tf.iota2d_plain(shape, dtype, card), rtol=0, atol=0)


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


@pytest.mark.parametrize("lead,n,block_rows", [((), 100_000_000, 512), ((8,), 2048, 2)])
def test_dot_partials_prepped_is_deterministic(card, lead, n, block_rows):
    # one launch a call; the same bits on every run (per-rank offsets on 8 ranks)
    x, y = _rand(lead + (n,), 16, card), _rand(lead + (n,), 17, card)
    off = torch.linspace(-1, 1, 8, device=card) if lead else None
    x2, y2, _, block = tr.prep(x, y, block_rows)
    tr.reset_launches()
    first = tr.dot_partials_prepped(x2, y2, block, offset=off)
    assert tr.launch_counts() == {"dot_partials_prepped": 1, "dot_full_prepped": 0}
    for _ in range(3):
        assert torch.equal(tr.dot_partials_prepped(x2, y2, block, offset=off), first)
    want = tr.dot_partials_plain(x, y, block * 128, off).sum(-1)
    _dot_close(first, want, x, y, off[:, None] if lead else 0.0)


@pytest.mark.parametrize("chunk", [4096, 16384])  # blocks of 256 and of 512 threads
@pytest.mark.parametrize("blocks", [1, 2, 5, 132, "chunks"])
def test_dot_partials_on_other_grids(card, blocks, chunk):
    # one block walking every chunk, a few, one an SM and the rule's block
    # a chunk: each chunk's partial is one block's fixed order, so every
    # grid gives the rule's bits, partials and sums
    x, y = _rand((2, 1 << 20), 18, card), _rand((2, 1 << 20), 19, card)
    nchunks = (1 << 20) // chunk
    g = nchunks if blocks == "chunks" else min(blocks, nchunks)
    sums, parts = tr._partials_dot(x, y, chunk, 0.5, "probe", g)
    want_sums, want_parts = tr._partials_dot(x, y, chunk, 0.5, "probe")
    assert torch.equal(sums, want_sums) and torch.equal(parts, want_parts)
    _dot_close(sums, tr.dot_partials_plain(x, y, chunk, 0.5).sum(-1), x, y, 0.5)
    ones = torch.ones((2, 1 << 20), device=card)
    assert torch.equal(tr._partials_dot(ones, ones, chunk, None, "probe", g)[0],
                       torch.full((2,), float(1 << 20), device=card))


@pytest.mark.parametrize("blocks", [1, 7, 132, 528, 792, 1056])
def test_dot_full_on_other_grids(card, blocks):
    # a grid of one block (no ticket), a few, and one to eight an SM: the
    # last block's tail sums 1 to 1056 partials in its fixed order
    x, y = _rand((2, 1 << 20), 14, card), _rand((2, 1 << 20), 15, card)
    got = tr._full_launch(x, y, 0.5, "probe", blocks)
    _dot_close(got, tr.dot_full_plain(x, y, 0.5), x, y, 0.5)
    assert torch.equal(got, tr._full_launch(x, y, 0.5, "probe", blocks))
    ones = torch.ones((2, 1 << 20), device=card)
    assert torch.equal(tr._full_launch(ones, ones, None, "probe", blocks),
                       torch.full((2,), float(1 << 20), device=card))


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


# The paged-attention kernel against its plain version: both f32, the
# kernel's dot products and softmax sums in another order (and int8/fp8
# pages dequantized before the product, not folded in after), so a few
# ulps of the O(1) outputs.
PAGED_ATOL = 1e-5


def _paged_operands(seed, lead, B, K, H, D, page, P, max_pages, dtype, device):
    """Ragged lengths with an idle slot, shuffled page ids with sentinel
    tail entries, and int8/fp8 pools quantized from f32 pages."""
    rng = np.random.default_rng(seed)
    q = _rand(lead + (B, K, H, D), seed, device)
    kf = torch.from_numpy(rng.standard_normal(lead + (P, page, H, D)).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal(lead + (P, page, H, D)).astype(np.float32))
    lens = rng.integers(1, max_pages * page - K + 2, lead + (B,))
    lens[..., 0] = 0
    table = np.full(lead + (B, max_pages), P + 3, np.int32)
    for idx in np.ndindex(*lead, B):
        need = -(-(int(lens[idx]) + K - 1) // page)
        table[idx][:need] = rng.permutation(P)[:need]
    ops = [q]
    if dtype == torch.float32:
        ops += [kf.to(device), vf.to(device)]
        scales = [None, None]
    else:
        (k8, ks), (v8, vs) = quantize_pages(kf, dtype), quantize_pages(vf, dtype)
        ops += [k8.to(device), v8.to(device)]
        scales = [ks.to(device), vs.to(device)]
    ops += [torch.from_numpy(table).to(device), torch.from_numpy(lens).int().to(device)]
    return ops + scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("K", [1, 4, 20])
def test_paged_attention(card, dtype, K):
    # page 4: K = 20 reaches past page + 1, so an idle slot's frontier
    # spans several (sentinel) pages
    ops = _paged_operands(40 + K, (), 6, K, 3, 40, 4, 64, 12, dtype, card)
    ta.reset_launches()
    got = ta.paged_attention(*ops)
    assert ta.launch_counts()["paged_attention"] == 1
    want = ta._verify_attention_dense(*ops)
    assert float((got - want).abs().max()) <= PAGED_ATOL
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # the idle slot
    on_cpu = ta._verify_attention_dense(*(o.cpu() if o is not None else None for o in ops))
    assert float((got.cpu() - on_cpu).abs().max()) <= PAGED_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_paged_attention_strided_stacked_pools(card, dtype):
    # two stacked ranks (one launch each), each pool a layer of a bigger
    # cache whose heads are split: page, token and head strides all
    # differ from a contiguous pool's
    q, k, v, table, lens, ks, vs = _paged_operands(50, (2,), 5, 3, 2, 128, 16, 32, 6, dtype, card)
    big_k = torch.zeros((2, 3, 32, 16, 4, 128), dtype=k.dtype, device=card)
    big_v = torch.zeros_like(big_k)
    big_k[:, 1, :, :, 2:] = k
    big_v[:, 1, :, :, 2:] = v
    pk, pv = big_k[:, 1, :, :, 2:], big_v[:, 1, :, :, 2:]
    if ks is not None:
        big_s = torch.zeros((2, 2, 32, 4), device=card)
        big_s[:, 0, :, 2:], big_s[:, 1, :, 2:] = ks, vs
        ks, vs = big_s[:, 0, :, 2:], big_s[:, 1, :, 2:]
    ta.reset_launches()
    got = ta.verify_attention(q, pk, pv, table, lens, ks, vs)
    assert ta.launch_counts()["paged_attention"] == 2
    want = ta.verify_attention(q, pk, pv, table, lens, ks, vs, fused=False)
    assert float((got - want).abs().max()) <= PAGED_ATOL


def _long_paged(dtype, B, T, card, seed=80):
    """Config 12's geometry (H 8, d_head 128, 16-token pages), B sequences
    whose lengths reach T, sequence 0 idle, pages shuffled over a pool of
    twice what they need."""
    rng = np.random.default_rng(seed)
    H, D, page = 8, 128, 16
    max_pages = T // page
    P = 2 * B * max_pages
    q = _rand((B, 1, H, D), seed, card)
    kf = torch.from_numpy(rng.standard_normal((P, page, H, D)).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((P, page, H, D)).astype(np.float32))
    lens = np.concatenate([[0], rng.integers(T - 3 * page, T + 1, B - 1)]).astype(np.int32)
    table = rng.permutation(P)[:B * max_pages].reshape(B, max_pages).astype(np.int32)
    if dtype == torch.float32:
        k, v, ks, vs = kf.to(card), vf.to(card), None, None
    else:
        (k, ks), (v, vs) = quantize_pages(kf, dtype), quantize_pages(vf, dtype)
        k, v, ks, vs = k.to(card), v.to(card), ks.to(card), vs.to(card)
    return [q, k, v, torch.from_numpy(table).to(card), torch.from_numpy(lens).to(card), ks, vs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.float8_e4m3fn])
def test_paged_attention_split_is_exact_and_deterministic(card, dtype):
    # B 2 x T 4096: too few (head, sequence) blocks for the SMs, so the
    # host rule splits the positions and a second kernel combines them
    ops = _long_paged(dtype, 2, 4096, card)
    ta.reset_launches()
    got = ta.paged_attention(*ops)
    again = ta.paged_attention(*ops)
    assert ta.launch_counts()["paged_attention"] == 2            # one a call
    assert ta.paged_attention.splits > 1 and ta.paged_attention.route == "16B"
    assert torch.equal(got, again)                               # the same bits
    assert torch.equal(got[0], torch.zeros_like(got[0]))         # the idle slot
    assert float((got - ta._verify_attention_dense(*ops)).abs().max()) <= PAGED_ATOL


@pytest.mark.parametrize("K,H,D,dtype,view,route", [
    (4, 3, 40, torch.int8, False, "8B"),             # 40-byte rows
    (1, 3, 20, torch.float32, False, "16B"),         # 80-byte rows
    (3, 3, 20, torch.int8, False, "4B"),
    (2, 2, 3, torch.float8_e4m3fn, False, "1B"),     # 3-byte rows: byte loads
    (5, 2, 128, torch.float32, True, "4B"),          # a view of 129-column rows
    (1, 2, 128, torch.int8, True, "1B"),
])
def test_paged_attention_load_width_routes(card, K, H, D, dtype, view, route):
    q, k, v, table, lens, ks, vs = _paged_operands(90 + D, (), 5, K, H, D, 8, 40, 6, dtype, card)
    if view:  # the pools as views of rows one column wider: 4-byte (1-byte) strides
        wk = torch.zeros(k.shape[:-1] + (D + 1,), dtype=k.dtype, device=card)
        wv = torch.zeros_like(wk)
        wk[..., 1:], wv[..., 1:] = k, v
        k, v = wk[..., 1:], wv[..., 1:]
    ta.reset_launches()
    got = ta.paged_attention(q, k, v, table, lens, ks, vs)
    assert ta.paged_attention.route == route
    assert ta.launch_counts()["paged_attention"] == 1
    want = ta._verify_attention_dense(q, k, v, table, lens, ks, vs)
    assert float((got - want).abs().max()) <= PAGED_ATOL
    assert torch.equal(got, ta.paged_attention(q, k, v, table, lens, ks, vs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("K", [1, 8])
def test_paged_attention_wide_head(card, dtype, K):
    # d_head 16384 (ROADMAP C2): no whole row fits a ring stage and no q a
    # block's shared memory, so a chunk streams through the ring in
    # 512-column units; one sequence (slot 1 of the operands) over 3 pages
    ops = _paged_operands(110 + K, (), 2, K, 1, 16384, 16, 8, 3, dtype, card)
    one = [ops[0][1:], ops[1], ops[2], ops[3][1:], ops[4][1:], ops[5], ops[6]]
    ta.reset_launches()
    got = ta.paged_attention(*one)
    assert ta.launch_counts()["paged_attention"] == 1
    assert float((got - ta._verify_attention_dense(*one)).abs().max()) <= PAGED_ATOL
    assert torch.equal(got, ta.paged_attention(*one))


@pytest.mark.parametrize("K,D,dtype,qdtype", [
    (3, 1030, torch.float32, torch.float32),      # 3 tiles, a 2-column last group: 8-byte loads
    (5, 1030, torch.int8, torch.bfloat16),        # byte loads, bf16 q
    (2, 2048, torch.float8_e4m3fn, torch.float32),
])
def test_paged_attention_wide_units_and_split(card, K, D, dtype, qdtype):
    # wide heads through every load route, and split over the positions
    # (2 heads x 4 tiles leave the SMs idle): two calls give the same bits
    ops = _paged_operands(120 + D, (), 3, K, 2, D, 16, 160, 64, dtype, card)
    ops[0] = ops[0].to(qdtype)
    got = ta.paged_attention(*ops)
    assert torch.equal(got, ta.paged_attention(*ops))
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # the idle slot
    want = ta._verify_attention_dense(*ops)
    atol = PAGED_ATOL if qdtype == torch.float32 else PAGED_BF16_ATOL
    assert float((got.float() - want.float()).abs().max()) <= atol
    if D == 2048:
        assert ta.paged_attention.splits > 1


# bf16 q: the kernel and the plain version both round an f32 result to
# bf16 once, and the f32 results differ by a few ulps, so one bf16 ulp of
# the O(1) outputs (2^-7 at magnitudes below 2).
PAGED_BF16_ATOL = 1e-2


def _f16_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far an f16 result lies from the f32 result it rounds, beyond
    that rounding (half an f16 ulp: 2^-11 of |want|, 2^-25 below the
    normal range): at most the f32 tolerance when the kernel's f32 result
    is within it."""
    want = want.double()
    slack = torch.clamp(want.abs() * 2.0 ** -11, min=2.0 ** -25)
    return float(((got.double() - want).abs() - slack).max())


@pytest.mark.parametrize("K,D,dtype,qdtype", [
    (65, 40, torch.float32, torch.float32),     # past one query group of 64
    (128, 128, torch.int8, torch.float32),      # two full groups
    (3, 384, torch.float32, torch.float32),     # three output tiles, not a multiple of 128
    (65, 384, torch.float8_e4m3fn, torch.float32),
    (4, 128, torch.float32, torch.bfloat16),    # bf16 q returns bf16
    (70, 200, torch.int8, torch.bfloat16),
    (1, 128, torch.float32, torch.float16),     # f16 q returns f16, every pool
    (4, 128, torch.int8, torch.float16),
    (20, 200, torch.float8_e4m3fn, torch.float16),
])
def test_paged_attention_any_k_d_and_bf16(card, K, D, dtype, qdtype):
    ops = _paged_operands(70 + K + D, (), 5, K, 2, D, 8, 96, 28, dtype, card)
    ops[0] = ops[0].to(qdtype)
    ta.reset_launches()
    got = ta.paged_attention(*ops)
    assert ta.launch_counts()["paged_attention"] == 1
    assert got.dtype == qdtype and got.shape == ops[0].shape
    if qdtype == torch.float16:  # f32 arithmetic: the plain f32 result, rounded once
        want = ta._verify_attention_dense(ops[0].float(), *ops[1:])
        assert _f16_excess(got, want) <= PAGED_ATOL
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        return
    want = ta._verify_attention_dense(*ops)
    atol = PAGED_ATOL if qdtype == torch.float32 else PAGED_BF16_ATOL
    assert float((got.float() - want.float()).abs().max()) <= atol
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # the idle slot


# The flash kernels against their plain versions on the card, as
# chip_smoke.py holds them. f32 (the FMA kernels): both sum f32 products in
# other orders (the kernels with FMAs over the D and key axes, the plain
# version through cuBLAS), so a few ulps of the largest output; held to 1e-5
# of max(1, max|want|). bf16 (the tensor-core kernels): q/k * scale, p and ds
# are rounded to bf16 in both (the kernels redo a value near a rounding
# midpoint in cuBLAS's order), so an output differs where its f32 sum, in
# the tensor cores' order, rounds to the other bf16 neighbour, plus one
# bf16 ulp (2^-7 of |want|) where the output is bf16 itself: held element
# by element to a |want| + b rms(want) (a = 2^-7 for a bf16 output, else 0)
# and as a whole to rms(got - want) <= c rms(want). The forward rounds p
# against each key tile's running max, the plain version against the final
# one, so its (b, c) are larger than the backward's, which recomputes p from
# the final lse in both. The limits and their readings: chip_smoke.py's
# FLASH_BF16.
FLASH_TOL = 1e-5
FLASH_BF16 = {"fwd": (4e-2, 4e-3), "bwd": (2e-3, 2.5e-4)}


def _flash_ok(got, want, dtype, part="fwd", tol=FLASH_TOL) -> bool:
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got.float()).all()) and bool(torch.isfinite(want.float()).all())
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    if dtype == torch.float32:
        return float(d.max()) <= tol * max(1.0, float(w.max()))
    live = w < 1e29                  # the m state's -1e30 sentinel must match exactly
    if bool((d[~live] != 0).any()):
        return False
    d, w = d[live], w[live]
    rms = w.square().mean().sqrt()
    a = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    b, c = FLASH_BF16[part]
    return bool((d <= a * w + b * rms).all()) and float(d.square().mean().sqrt()) <= c * float(rms)


def _flash_inputs(seed, lead, S, T, H, D, dtype, device):
    q = _rand(lead + (S, H, D), seed, device).to(dtype)
    k = _rand(lead + (T, H, D), seed + 1, device).to(dtype)
    v = _rand(lead + (T, H, D), seed + 2, device).to(dtype)
    do = _rand(lead + (S, H, D), seed + 3, device).to(dtype)
    return q, k, v, do


# (lead, S, T, H, D, causal, q_offset, kv_offset): ragged S and T, per-entry
# offsets with one fully masked entry (its queries all precede its keys);
# then the bf16 tensor-core kernels' other branches: rows of 40 bytes (D 20,
# H 3) that TMA cannot address, D 320 split over output-column chunks, and
# S = T = 1000 causal with per-entry offsets off the tile grid (one entry
# fully masked); and D 18, whose f32 rows (72 bytes) the split-TF32 kernels
# stage without TMA too
FLASH_CASES = [
    ((), 70, 70, 2, 64, True, 0, 0),
    ((2,), 45, 83, 3, 128, False, 0, 0),
    ((), 64, 96, 2, 128, True, 16, 0),
    ((2, 3), 40, 40, 2, 64, True, [[0, 40, 80], [0, 0, 0]], [[0, 0, 0], [100, 40, 30]]),
    ((2,), 33, 65, 2, 256, True, 0, 0),
    ((), 17, 129, 1, 96, False, 0, 0),
    ((), 40, 40, 3, 20, True, 0, 0),
    ((), 50, 70, 2, 320, False, 0, 0),
    ((2,), 1000, 1000, 2, 128, True, [0, 300], [37, 1400]),
    ((), 40, 40, 3, 18, True, 0, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"case{i}" for i in range(len(FLASH_CASES))])
def test_flash_kernels_match_plain(card, case, dtype):
    lead, S, T, H, D, causal, qo, ko = case
    q, k, v, do = _flash_inputs(len(lead) + S + D, lead, S, T, H, D, dtype, card)
    if not isinstance(qo, int):
        qo, ko = torch.tensor(qo, device=card), torch.tensor(ko, device=card)
    ta.reset_launches()
    assert _flash_ok(ta._flash_fwd_call(q, k, v, qo, ko, causal),
                     ta._flash_fwd_plain(q, k, v, qo, ko, causal, False), dtype)
    acc, m, l = ta._flash_fwd_call(q, k, v, qo, ko, causal, return_state=True)
    pacc, pm, pl = ta._flash_fwd_plain(q, k, v, qo, ko, causal, True)
    for got, want in ((acc, pacc), (m, pm), (l, pl)):
        assert _flash_ok(got, want, dtype)
    o, lse = ta._normalize(pacc, pm, pl, dtype)
    delta = ta._delta(do, o)
    for out_dtype in (None, torch.float32):
        got = ta._flash_bwd_call(q, k, v, do, lse, delta, qo, ko, causal, out_dtype=out_dtype)
        want = ta._flash_bwd_plain(q, k, v, do, lse, delta, qo, ko, causal, out_dtype)
        for g, w in zip(got, want):
            assert _flash_ok(g, w, dtype, "bwd")
    counts = ta.launch_counts()
    assert counts["_flash_fwd_call"] == 2 and counts["_flash_bwd_call"] == 2
    if causal and isinstance(qo, int):
        assert _flash_ok(ta._flash_fwd_compact(q, k, v, qo, ko),
                         ta._flash_fwd_plain(q, k, v, qo, ko, True, False), dtype)
        got = ta._flash_bwd_compact(q, k, v, do, lse, delta, qo, ko)
        want = ta._flash_bwd_plain(q, k, v, do, lse, delta, qo, ko, True)
        for g, w in zip(got, want):
            assert _flash_ok(g, w, dtype, "bwd")
        assert ta.launch_counts()["_flash_fwd_compact"] == 1
        assert ta.launch_counts()["_flash_bwd_compact"] == 1


def test_flash_bf16_backward_is_deterministic(card):
    # no atomics: two calls give the same bits, through both backward wrappers
    q, k, v, do = _flash_inputs(7, (2,), 300, 300, 2, 128, torch.bfloat16, card)
    acc, m, l = ta._flash_fwd_plain(q, k, v, 0, 0, True, True)
    o, lse = ta._normalize(acc, m, l, torch.bfloat16)
    delta = ta._delta(do, o)
    for call in (lambda: ta._flash_bwd_call(q, k, v, do, lse, delta, 0, 0, True,
                                            out_dtype=torch.float32),
                 lambda: ta._flash_bwd_compact(q, k, v, do, lse, delta, 0, 0)):
        a, b = call(), call()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_f32_backward_is_deterministic(card):
    # the split-TF32 backward: two kernels, no atomics, the same bits every call
    q, k, v, do = _flash_inputs(8, (2,), 300, 300, 2, 128, torch.float32, card)
    acc, m, l = ta._flash_fwd_plain(q, k, v, 0, 0, True, True)
    o, lse = ta._normalize(acc, m, l, torch.float32)
    delta = ta._delta(do, o)
    for call in (lambda: ta._flash_bwd_call(q, k, v, do, lse, delta, 0, 0, True),
                 lambda: ta._flash_bwd_compact(q, k, v, do, lse, delta, 0, 0)):
        a, b = call(), call()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_tf32_kernels_hold_tf32_hgmma(card):
    # every instantiation of the three split-TF32 kernels issues TF32 warpgroup MMAs
    import pathlib
    import subprocess

    from tpuscratch_torch.ops.common import build_all, nvcc_path

    tool = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build_all()["flash_attention"])],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fn = fn if "tf32" in fn else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line and "TF32" in line:
            counts[fn] += 1
    assert len(counts) == 12, counts      # 3 kernels x (TMA, own loads) x (64, 128 columns)
    assert min(counts.values()) > 0, counts


@pytest.mark.parametrize("dtype,D,want", [(torch.float32, 128, "tf32"), (torch.float32, 20, "tf32"),
                                          (torch.float32, 18, "tf32"), (torch.float32, 256, "fma"),
                                          (torch.bfloat16, 128, "bf16")])
def test_flash_route_follows_the_shape_rule(card, dtype, D, want):
    # f32 heads up to 128 columns take the split-TF32 kernels, wider ones
    # the FMA kernels; bf16 the bf16 tensor-core kernels
    q, k, v, do = _flash_inputs(4, (), 64, 64, 2, D, dtype, card)
    ta._flash_fwd_call(q, k, v, 0, 0, True)
    acc, m, l = ta._flash_fwd_plain(q, k, v, 0, 0, True, True)
    o, lse = ta._normalize(acc, m, l, dtype)
    ta._flash_bwd_call(q, k, v, do, lse, ta._delta(do, o), 0, 0, True)
    assert ta._flash_fwd_call.route == want and ta._flash_bwd_call.route == want


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (0, 1, 3, 4, 9)],
                         ids=[f"case{i}" for i in (0, 1, 3, 4, 9)])
def test_flash_f16_takes_the_f32_kernels(card, case):
    # f16 operands are widened to the f32 kernels: the state and the f32
    # gradient partials within FLASH_TOL of the plain version on the widened
    # operands, the f16 outputs and gradients that result rounded once
    lead, S, T, H, D, causal, qo, ko = case
    q, k, v, do = _flash_inputs(len(lead) + S + D, lead, S, T, H, D, torch.float16, card)
    wide = [t.float() for t in (q, k, v, do)]
    if not isinstance(qo, int):
        qo, ko = torch.tensor(qo, device=card), torch.tensor(ko, device=card)
    out = ta._flash_fwd_call(q, k, v, qo, ko, causal)
    assert out.dtype == torch.float16
    assert ta._flash_fwd_call.route == ("tf32" if D <= 128 else "fma")
    want = ta._flash_fwd_plain(*wide[:3], qo, ko, causal, False)
    assert _f16_excess(out, want) <= FLASH_TOL * max(1.0, float(want.abs().max()))
    acc, m, l = ta._flash_fwd_call(q, k, v, qo, ko, causal, return_state=True)
    pacc, pm, pl = ta._flash_fwd_plain(*wide[:3], qo, ko, causal, True)
    for got, w in ((acc, pacc), (m, pm), (l, pl)):
        assert _flash_ok(got, w, torch.float32)
    o, lse = ta._normalize(pacc, pm, pl, torch.float16)
    delta = ta._delta(do, o)
    got = ta._flash_bwd_call(q, k, v, do, lse, delta, qo, ko, causal, out_dtype=torch.float32)
    want = ta._flash_bwd_plain(*wide, lse, delta, qo, ko, causal, torch.float32)
    for g, w in zip(got, want):
        assert _flash_ok(g, w, torch.float32)
    for g, w in zip(ta._flash_bwd_call(q, k, v, do, lse, delta, qo, ko, causal), want):
        assert g.dtype == torch.float16
        assert _f16_excess(g, w) <= FLASH_TOL * max(1.0, float(w.abs().max()))


def test_flash_fully_masked_entry_is_zero(card):
    q, k, v, do = _flash_inputs(5, (2,), 40, 40, 2, 64, torch.float32, card)
    qo, ko = torch.tensor([0, 0], device=card), torch.tensor([0, 100], device=card)
    out = ta._flash_fwd_call(q, k, v, qo, ko, True)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    acc, m, l = ta._flash_fwd_call(q, k, v, qo, ko, True, return_state=True)
    assert torch.equal(l[1], torch.zeros_like(l[1])) and bool((m[1] == -1e30).all())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_match_autograd_of_plain(card, causal):
    # the autograd.Functions (kernels both ways) against torch's own
    # autograd through the plain forward, f32
    q, k, v, do = _flash_inputs(9, (2,), 70, 70, 2, 64, torch.float32, card)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    ta.reset_launches()
    out = ta.flash_attention(qs, ks, vs, causal=causal)
    out.backward(do)
    want = ta._flash_fwd_plain(qp, kp, vp, 0, 0, causal, False)
    want.backward(do)
    assert _flash_ok(out.detach(), want.detach(), torch.float32)
    for a, b in ((qs, qp), (ks, kp), (vs, vp)):
        assert _flash_ok(a.grad, b.grad, torch.float32, tol=1e-4)
    counts = ta.launch_counts()
    name = "compact" if causal else "call"
    assert counts[f"_flash_fwd_{name}"] == 1 and counts[f"_flash_bwd_{name}"] == 1


# ---- fused Adam (adam.cu) and the copy probes (copy_probes.cu) ----------------------


def _adam_inputs(shape, mdt, seed, device):
    w, g, m = (_rand(shape, seed + i, device) for i in range(3))
    v = _rand(shape, seed + 3, device).abs()
    return w, g, m.to(mdt), v.to(mdt)


def _bits_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all()) and bool(torch.isfinite(b.float()).all())
        assert torch.equal(a, b)


@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,alpha_shape", [((1,), ()), ((3,), ()), ((1023,), ()),
                                               ((1025,), ()), ((3001,), ()), ((4, 3001), (4,)),
                                               ((2, 3, 1024), (2, 3))])
@pytest.mark.parametrize("donate", [False, True])
def test_fused_adam_kernel(card, mdt, shape, alpha_shape, donate):
    w, g, m, v = _adam_inputs(shape, mdt, 40, card)
    alpha = torch.linspace(1e-3, 4e-3, math.prod(alpha_shape) or 1, device=card).reshape(alpha_shape)
    want = tadam.fused_adam_plain(w, g, m, v, alpha)
    ptrs = (w.data_ptr(), m.data_ptr(), v.data_ptr())
    tadam.reset_launches()
    got = tadam.fused_adam_flat(w, g, m, v, alpha, donate=donate)
    torch.cuda.synchronize()
    assert tadam.launch_counts() == {"fused_adam_flat": 1}
    _bits_equal(got, want)
    assert ((tuple(t.data_ptr() for t in got) == ptrs) if donate
            else all(t.data_ptr() not in ptrs for t in got))


def test_fused_adam_kernel_strided_rows(card):
    # the overlap schedule hands the kernel one block of every rank's shard:
    # rows of a strided view, updated in place
    w, g, m, v = _adam_inputs((4, 3, 520), torch.float32, 41, card)
    alpha = torch.tensor([1e-3, 2e-3, 3e-3, 4e-3], device=card)
    want = tadam.fused_adam_plain(w[:, 1], g[:, 1], m[:, 1], v[:, 1], alpha)
    got = tadam.fused_adam_flat(w[:, 1], g[:, 1].contiguous(), m[:, 1], v[:, 1], alpha)
    _bits_equal(got, want)
    _bits_equal((w[:, 1], m[:, 1], v[:, 1]), want)


def test_zero_step_card_equals_cpu(card):
    from tpuscratch_torch.models import transformer as tt
    from tpuscratch_torch.models import zero as tz

    cfg = tt.TransformerConfig(d_model=16, n_heads=2, n_experts=2, d_ff=32)
    x, y = (_rand((4, 16, 16), s, "cpu") for s in (1, 2))
    out = {}
    for dev in ("cpu", card):
        mesh = make_mesh((2, 1), ("dp", "sp"), device=dev)
        p = tt.init_params(0, cfg, dev)
        o = tz.init_zero_adam_state(p, 2)
        step = tz.train_step_zero(mesh, cfg, lr=0.01, overlap_blocks=2)
        for _ in range(2):
            p, o, loss = step(p, o, x.to(dev), y.to(dev))
        out[str(dev)] = (float(loss), [t.cpu() for t in tt._leaves(p)])
    (lc, pc), (lg, pg) = out.values()
    # sums through matmuls and attention differ between the CPU and the card
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    for a, b in zip(pc, pg):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.parametrize("zero", [True, False])
def test_plan_step_card_equals_cpu_and_overlap_is_bitwise(card, zero):
    # the pipelined plan step (pp2 x dp2, n_micro 2, flash ring) on the card:
    # against the CPU as the ZeRO step is held above, overlap against serial
    # bit for bit, and its launches: 3 ticks x 1 layer a stage a step, fused
    # Adam once a step serial and once a block (4) with overlap
    from tpuscratch_torch.models import transformer as tt
    from tpuscratch_torch.models import zero as tz
    from tpuscratch_torch.parallel.plan import ShardingPlan

    cfg = tt.TransformerConfig(d_model=16, n_heads=2, n_experts=2, d_ff=32, n_layers=2,
                               attn_impl="pallas")
    x, y = (_rand((4, 16, 16), s, "cpu") for s in (3, 4))
    out = {}
    for dev, overlap in (("cpu", False), (card, False), (card, True)):
        plan = ShardingPlan(make_mesh((2, 1, 2), ("dp", "sp", "pp"), device=dev), pp="pp",
                            n_micro=2, overlap=overlap)
        p = tt.stack_layers(tt.init_params(0, cfg, dev))
        o = tz.init_plan_zero_state(p, plan) if zero else tt.init_adam_state(p)
        step = tz.train_step_plan(plan, cfg, lr=0.01, zero=zero)
        ta.reset_launches()
        tadam.reset_launches()
        for _ in range(2):
            p, o, loss = step(p, o, x.to(dev), y.to(dev))
        out[(str(dev), overlap)] = (float(loss), [t.cpu() for t in tt._leaves(p)],
                                    ta.launch_counts()["_flash_fwd_call"],
                                    tadam.launch_counts()["fused_adam_flat"])
    (lc, pc, _, _), (ls, ps, fs, as_), (lo, po, fo, ao) = out.values()
    assert abs(lc - ls) <= 1e-5 * abs(lc)
    for a, b in zip(pc, ps):
        assert float((a - b).abs().max()) <= 1e-4
    assert ls == lo and all(torch.equal(a, b) for a, b in zip(ps, po))
    assert (fs, fo) == (6, 6)
    assert (as_, ao) == ((2, 8) if zero else (0, 0))


@pytest.mark.parametrize("make,plain", [
    (lambda: tb.manual_stream(4096, 2, "copy"), tb.copy_plain),
    (lambda: tb.manual_stream(4096, 3, "touch"), tb.touch_plain),
    (lambda: tb.hbm2hbm(), tb.copy_plain), (lambda: tb.kway_hbm2hbm(4), tb.copy_plain),
    (lambda: tb.kway_hbm2hbm(8), tb.copy_plain),
    (lambda: tb.lanes_stream(2048, 2, 4), tb.touch_plain),
    (lambda: tb.lanes_stream(4096, 3, 2, "copy"), tb.copy_plain),
    # every design switch, other rings, 8 and 15 rings a block (64 compute
    # threads a ring), the 2-way split, ragged chunks
    (lambda: tb.hbm2hbm(flags=0), tb.copy_plain),
    (lambda: tb.hbm2hbm(49152, 4, flags=tb.DYNAMIC), tb.copy_plain),
    (lambda: tb.hbm2hbm(16400, 2, flags=tb.EVICT_FIRST), tb.copy_plain),
    (lambda: tb.hbm2hbm(16400, 3, flags=tb.DYNAMIC | tb.EVICT_FIRST), tb.copy_plain),
    (lambda: tb.kway_hbm2hbm(2), tb.copy_plain),
    (lambda: tb.kway_hbm2hbm(2, flags=0), tb.copy_plain),
    (lambda: tb.manual_stream(16384, 2, "touch", flags=0), tb.touch_plain),
    (lambda: tb.manual_stream(8208, 4, "copy", flags=tb.EVICT_FIRST), tb.copy_plain),
    (lambda: tb.lanes_stream(4096, 2, 8), tb.touch_plain),
    (lambda: tb.lanes_stream(2048, 2, 15, flags=0), tb.touch_plain),
    (lambda: tb.lanes_stream(1024, 4, 15, "copy"), tb.copy_plain),
    (lambda: tb.hbm2hbm(flags=tb.DYNAMIC | tb.PDL), tb.copy_plain),
    (lambda: tb.manual_stream(16384, 2, "touch", flags=7), tb.touch_plain),
    # a work-sized grid: more blocks than a wave, a few chunks a ring
    (lambda: tb._ring(tb.hbm2hbm, 4096, 2, 1, "direct", 0, 1000), tb.copy_plain)])
@pytest.mark.parametrize("shape", [(8, 37, 12), (tb.NZ, tb.CY, tb.CX)])
def test_copy_probes(card, make, plain, shape):
    x = _rand(shape, 5, card)
    c = torch.full((1,), 1.0 + 2 ** -20, device=card)
    got = make()(x, c)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(x, c))


@pytest.mark.parametrize("flags", [tb.FLAGS, tb.DYNAMIC | tb.PDL, tb.PDL])
def test_copy_probe_chains(card, flags):
    # each step reads the one before: with a programmatic dependent launch
    # the next kernel starts early and must wait for the last one's writes
    x = _rand((tb.NZ, tb.CY, tb.CX), 6, card)
    c = torch.full((1,), 1.0 + 2 ** -20, device=card)
    steps = [(tb.hbm2hbm(flags=flags), tb.copy_plain),
             (tb.manual_stream(16384, 2, "touch", flags=flags), tb.touch_plain),
             (tb.kway_hbm2hbm(2, flags=flags), tb.copy_plain),
             (tb.lanes_stream(8192, 2, 4, flags=flags), tb.touch_plain)] * 2
    got, want = x, x
    for step, plain in steps:
        got, want = step(got, c), plain(want, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_copy_probe_models_match_the_kernel(card):
    # the host's shared-memory model is the launcher's; the card gives a
    # block what the lists were checked against, and holds hbm2hbm's ring
    lib = tb._lib()
    for mode, nbuf, chunk, lanes in [("direct", 4, 32768, 1), ("copy", 3, 16384, 1),
                                     ("touch", 2, 4096, 15), ("touch", 4, 1024, 15)]:
        assert lib.ts_copy_probe_smem(tb.MODES[mode], nbuf, chunk, lanes) == \
            tb.probe_smem(mode, nbuf, chunk, lanes)
    assert tb._optin(card) >= tb.SMEM_OPTIN
    n_sm, per_sm = tb._occupancy(card, tb.MODES["direct"], tb.HBM2HBM[1], tb.HBM2HBM[0], 1)
    assert n_sm >= 1 and per_sm >= 1


def test_copy_probe_refusals(card):
    c = torch.ones(1, device=card)
    with pytest.raises(ValueError, match="16 bytes"):
        tb.hbm2hbm()(torch.zeros(5, device=card), c)
    with pytest.raises(ValueError, match="shared memory"):
        tb.manual_stream(65536, 4, "touch")(torch.zeros(64, device=card), c)


# the streamed 3D smoother of the 3D multigrid (solvers.multigrid3d): the
# kernel in rhs mode against the same call on the plain version on the CPU
@pytest.mark.parametrize("dims,sweeps", [((1, 1, 1), 2), ((2, 1, 1), 2), ((1, 1, 1), 5)])
def test_jacobi_smooth3_stream(card, dims, sweeps):
    from tpuscratch_torch.comm.spmd import mesh_context
    from tpuscratch_torch.solvers import multigrid3d as mg3

    core = (16, 8, 128)
    world = np.zeros(tuple(c * d for c, d in zip(core, dims)), np.float32)
    u, f = (_rand(tuple(dims) + core, seed, "cpu") for seed in (40, 41))
    out = {}
    for dev in ("cpu", card):
        mesh = make_mesh(dims, ("z", "row", "col"), device=dev)
        spec = mg3._mg_prologue3(world, mesh, None)[2][0][0]
        ts.reset_launches()
        with mesh_context(mesh):
            out[str(dev)] = mg3.jacobi_smooth3_stream(u.to(dev), f.to(dev), spec, 6 / 7, sweeps)
    assert ts.seven_point_streamed_pallas.launches == (2 if sweeps == 5 else 1)
    assert torch.equal(_bits(out[str(card)].cpu()), _bits(out["cpu"]))


@pytest.mark.parametrize("shape", [(64, 64, 64), (64, 16, 128)])
def test_jacobi_stream_solve_launches_by_the_rule(card, shape):
    # at 64^3 no level is 128 columns wide, so the rule admits none and the
    # kernel must not launch; at 64x16x128 the finest level streams
    from tpuscratch_torch.solvers import multigrid3d as mg3

    b = np.random.default_rng(42).standard_normal(shape).astype(np.float32)
    b -= b.mean()
    mesh = make_mesh((1, 1, 1), ("z", "row", "col"), device=card)
    ts.reset_launches()
    x, cycles, rel = mg3.mg_poisson3d_solve(b, mesh, tol=1e-6, smoother="jacobi-stream")
    launches = ts.seven_point_streamed_pallas.launches
    specs = mg3._mg_prologue3(b, mesh, None)[2]
    assert launches == mg3.stream_launches(specs) * cycles
    assert (launches > 0) == (shape[2] >= 128)
    xc, cc, _ = mg3.mg_poisson3d_solve(b, make_mesh((1, 1, 1), ("z", "row", "col"),
                                                    device="cpu"),
                                       tol=1e-6, smoother="jacobi-stream")
    assert rel <= 2.5e-6 and abs(cycles - cc) <= 1
    assert np.abs(x - xc).max() <= 1e-4 * np.abs(xc).max()


# the deep (s-step) smoothers of the 3D multigrid against the per-sweep
# ones on the card: the same elementwise ops in the same order, so the
# same bits, as on the CPU (the JAX tests' (sweeps, s) cases)
@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("smoother,sweeps,s,rev", [
    ("jacobi", 4, 2, False), ("jacobi", 5, 2, False), ("jacobi", 4, 4, False),
    ("jacobi", 3, 3, False), ("rbgs", 4, 2, False), ("rbgs", 3, 2, True), ("rbgs", 4, 3, False)])
def test_deep_smoothers_bit_identical(card, dims, smoother, sweeps, s, rev):
    from tpuscratch_torch.comm.spmd import mesh_context
    from tpuscratch_torch.solvers import multigrid3d as mg3

    core = (16, 16, 16)
    world = np.zeros(tuple(c * d for c, d in zip(core, dims)), np.float32)
    u, f = (_rand(tuple(dims) + core, seed, card) for seed in (50, 51))
    mesh = make_mesh(dims, ("z", "row", "col"), device=card)
    spec = mg3._mg_prologue3(world, mesh, None)[2][0][0]
    with mesh_context(mesh):
        if smoother == "jacobi":
            shal = mg3.jacobi_smooth3(u, f, spec, 6 / 7, sweeps)
            deep = mg3.jacobi_smooth3_deep(u, f, spec, 6 / 7, sweeps, s)
        else:
            shal = mg3.rbgs_smooth3(u, f, spec, sweeps, rev)
            deep = mg3.rbgs_smooth3_deep(u, f, spec, sweeps, s, rev)
    assert deep.is_cuda and not torch.equal(deep, u)
    assert torch.equal(_bits(deep), _bits(shal))


def test_pair_fft_refuses_tf32_products(card):
    from tpuscratch_torch.parallel import fft as pfft

    mesh = make_mesh_1d("x", 1, device=card)
    prog = run_spmd(mesh, lambda r, i: pfft.fft2_sharded_pair(r, i, "x", method="direct"),
                    (P("x"), P("x")), (P("x"), P("x")))
    re, im = _rand((64, 64), 60, card), _rand((64, 64), 61, card)
    want = prog(re, im)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert pfft.tf32_products()
        with pytest.raises(RuntimeError, match="TF32"):
            prog(re, im)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert not pfft.tf32_products()
    assert all(torch.equal(a, b) for a, b in zip(prog(re, im), want))


@pytest.mark.parametrize("with_pool", [False, True])
def test_async_snapshot_race_on_a_cuda_stream(card, tmp_path, with_pool):
    """The async checkpoint's two races on the card: its copy must wait for
    the work queued before the snapshot (the fill to 1 behind a sleep
    kernel), and the work queued after it (an in-place fill to 2, as a
    donated state's update) must wait for the copy. The host does not wait
    for either: once the pinned buffers are pooled (a first snapshot of the
    same shapes, as every save after a run's first), ``snapshot`` returns
    while the sleep still runs. The write reports the copy's device time.
    With a native ``HostPool`` (``pool=``) the same holds: its buffers are
    registered with the card once and kept until ``close``."""
    from tpuscratch_torch.native.hostpool import HostPool
    from tpuscratch_torch.runtime import checkpoint
    from tpuscratch_torch.runtime.async_ckpt import AsyncCheckpointer

    x = torch.zeros(16 << 20, device=card)
    y = torch.zeros(3, 5, device=card)
    writes = []

    class Sink:
        def emit(self, event, **f):
            writes.append(f)

    pool = HostPool(lock_pages=False) if with_pool else None
    with AsyncCheckpointer(sink=Sink(), pool=pool) as ck:
        ck.snapshot(tmp_path / "warm", 1, {"x": x, "y": y, "n": np.int32(0)})
        ck.drain()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        x.fill_(1.0)
        y.fill_(1.0)
        queued = torch.cuda.Event()
        queued.record()
        ck.snapshot(tmp_path / "ck", 1, {"x": x, "y": y, "n": np.int32(7)})
        waited = queued.query()
        x.fill_(2.0)
        y.add_(1.0)
        ck.drain()
    got, _, _ = checkpoint.restore(tmp_path / "ck", {"x": x, "y": y, "n": np.int32(0)})
    assert got["x"].is_cuda and int(got["n"]) == 7
    assert float(got["x"].min()) == float(got["x"].max()) == 1.0, "the copy raced the fills"
    assert bool((got["y"] == 1.0).all()), "the copy raced the fills"
    assert bool((x == 2.0).all()) and bool((y == 2.0).all())
    assert not waited, "snapshot waited for the device"
    assert len(writes) == 2 and writes[1]["copy_device_s"] > 0.0
    if with_pool:  # both leaves staged through the pool, all returned at close
        assert pool.stats()["alloc_calls"] == 2 and pool.stats()["live_buffers"] == 0
        pool.close()


def test_guarded_step_on_the_card_against_the_cpu(card):
    """``train_step(guard=...)`` with the flash kernels on the card against
    the same step's plain path on the CPU: the same statuses (clipped, then
    skipped on an Inf batch); a skipped step returns the params bit for bit;
    the clipped step's loss within 1e-5 relative and its update within
    1e-4 of the largest update (the kernels and cuBLAS sum in other orders)
    plus two f32 spacings of the parameter (how finely the stored
    parameter shows an update)."""
    from tpuscratch_torch.models import transformer as mt

    cfg = mt.TransformerConfig(d_model=64, n_heads=2, n_experts=2, d_ff=96,
                               capacity_factor=2.0, attn_impl="pallas")
    x, y = _rand((2, 64, 64), 70, "cpu"), _rand((2, 64, 64), 71, "cpu")
    bad = x.clone()
    bad[0, 0, 0] = math.inf
    out = {}
    for dev in ("cpu", card):
        step = mt.train_step(make_mesh((1, 1), ("dp", "sp"), device=dev), cfg, lr=0.05,
                             guard=(0.1, 1e30))
        p0 = mt.init_params(0, cfg, dev)
        ref = torch.tensor(float("nan"), device=dev)
        out[str(dev)] = [step(p0, xb.to(dev), y.to(dev), ref) for xb in (x, bad)], p0
    (cpu, cp0), (gpu, gp0) = out["cpu"], out[str(card)]
    assert [int(r[3]) for r in cpu] == [int(r[3]) for r in gpu] == [1, 2]
    assert all(torch.equal(a, b) for a, b in zip(mt._leaves(gpu[1][0]), mt._leaves(gp0)))
    assert abs(float(gpu[0][1]) - float(cpu[0][1])) <= 1e-5 * abs(float(cpu[0][1]))
    for w, a, b in zip(mt._leaves(cp0), mt._leaves(cpu[0][0]), mt._leaves(gpu[0][0])):
        ua, ub = a - w, b.cpu() - w
        seen = 2 * torch.from_numpy(np.spacing(w.abs().numpy()))
        assert bool(((ua - ub).abs() <= 1e-4 * float(ua.abs().max()) + seen).all())


def test_scheduler_fence_books_side_stream_work_to_its_tick(card):
    """A tick that leaves work on a side stream (as an async snapshot's
    copy does) has it booked to its own busy seconds: the scheduler fences
    each tick, so the other workload's next tick, which would wait for it
    on the shared card, does not pay for it."""
    from tpuscratch_torch.runtime.chunked import ChunkedProgram, ChunkResult
    from tpuscratch_torch.runtime.scheduler import MeshScheduler, RoundRobin

    side = torch.cuda.Stream()

    def prog(name, sleep_cycles):
        def run_chunk(cp, pos):
            with torch.cuda.stream(side):
                torch.cuda._sleep(sleep_cycles)   # left running when the chunk returns
            return pos

        return ChunkedProgram(workload=name, total=2, run_chunk=run_chunk,
                              make_event=lambda cp, pos, p, sp: ChunkResult(pos + 1, save=False))

    torch.cuda.synchronize()
    sched = MeshScheduler(policy=RoundRobin())
    sched.add(prog("slow", 200_000_000))
    sched.add(prog("idle", 0))
    sched.run()
    busy = {n: e.busy_s for n, e in sched.entries.items()}
    assert [e.ticks for e in sched.entries.values()] == [2, 2]
    assert busy["slow"] > 0.05 and busy["slow"] > 10 * busy["idle"]


def test_ledger_on_the_card_matches_the_cpu(card):
    """``obs.ledger.analyze`` records the same collectives on CUDA tensors
    as on CPU ones, and its flops leave out the hand-written kernels (a
    ctypes launch no dispatch mode sees)."""
    from tpuscratch_torch.halo.exchange import HaloSpec, halo_exchange
    from tpuscratch_torch.halo.layout import TileLayout
    from tpuscratch_torch.obs.ledger import analyze
    from tpuscratch_torch.ops.fill import fill
    from tpuscratch_torch.runtime.mesh import make_mesh, topology_of

    leds = {}
    for dev in ("cpu", card):
        mesh = make_mesh((2, 2), ("row", "col"), device=dev)
        spec = HaloSpec(layout=TileLayout(64, 48, 2, 2), topology=topology_of(mesh))
        tiles = torch.randn((2, 2) + spec.layout.padded_shape, device=dev)
        leds[str(dev)] = analyze(halo_exchange, tiles, spec)
    a, b = leds.values()
    assert a.collectives == b.collectives and a.count("collective-permute") == 8
    led = analyze(lambda: fill((1024, 1024), 3.0, device=card))
    assert led.flops == 0 and led.collectives == ()


# ---- the native library (native/src, built with g++) on the card host ---------------


def test_native_library_builds_and_registers_with_the_card(card):
    """The planner and pool library builds from the checkout's sources on
    the card host; a pool buffer registered with the card is page-locked
    (``is_pinned``), takes an asynchronous copy from the card and frees."""
    from tpuscratch_torch import native
    from tpuscratch_torch.halo.exchange import python_plan
    from tpuscratch_torch.halo.layout import TileLayout
    from tpuscratch_torch.native.hostpool import HostPool
    from tpuscratch_torch.runtime.topology import CartTopology

    assert native.build().exists() and native.has_plan3d()
    lay, topo = TileLayout(16, 16, 1, 1), CartTopology((4, 8), (True, False))
    assert native.build_plan((4, 8), (True, False), 16, 16, 1, 1, 8) == [
        {"direction": t.direction.offset, "send_rect": (*t.send.offsets, *t.send.shape),
         "recv_rect": (*t.recv.offsets, *t.recv.shape), "perm": list(t.perm)}
        for t in python_plan(lay, topo, 8)]
    x = _rand((1 << 20,), 3, card)
    with HostPool(lock_pages=False) as pool:
        buf = pool.alloc(x.numel() * 4)
        host = buf.tensor(torch.float32, tuple(x.shape))
        assert not host.is_pinned()
        buf.register_with_card()
        assert host.is_pinned()
        host.copy_(x, non_blocking=True)
        torch.cuda.synchronize()
        assert torch.equal(host, x.cpu())
        del host
        buf.free()                       # unregisters, then returns the pages
        assert pool.stats()["live_buffers"] == 0


# ---- the serving levers on the card: sync-free writes, dispatches, accept rule -----------


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.float8_e4m3fn])
def test_put_is_sync_free_and_bit_equal_to_the_masked_write(card, dtype):
    """``serve.decode._Writes`` and ``_put`` under
    ``set_sync_debug_mode("error")``: one scatter, bit-equal to the masked
    write made entry by entry on the host, with dropped entries sharing a
    kept entry's target and a rank with no kept entry (both land in the
    pool's write sink)."""
    from tpuscratch_torch.comm.spmd import mesh_context
    from tpuscratch_torch.serve.decode import _put, _Writes
    from tpuscratch_torch.serve.kvcache import CacheGeometry, init_kv_cache

    g = torch.Generator(device="cpu").manual_seed(7)
    L, P_, page, H, D, B, li = 2, 6, 4, 3, 8, 5, 1
    pool = init_kv_cache(CacheGeometry(L, P_, page, H, D), 2, dtype, device=card)["k"]
    pool.copy_(torch.randn(pool.shape, generator=g).mul(50).to(dtype))
    pages = torch.randint(0, P_ + 1, (2, B), generator=g, dtype=torch.int32)
    offs = torch.randint(0, page, (2, B), generator=g, dtype=torch.int32)
    pages[0] = torch.tensor([0, P_, 0, 1, P_ + 3], dtype=torch.int32)  # dropped entries on
    offs[0] = torch.tensor([1, 1, 2, 1, 3], dtype=torch.int32)         # a kept entry's target
    pages[1] = P_                                                       # rank 1 keeps nothing
    vals = torch.randn((2, B, H, D), generator=g).mul(50).to(dtype)
    want = pool.cpu().clone()
    for r in range(2):
        for b in range(B):
            if pages[r, b] < P_:
                want[li, r * P_ + int(pages[r, b]), int(offs[r, b])] = vals[r, b]
    # the stacked (dp 2, sp 1) views that run_spmd hands a program
    dst = pool.unflatten(1, (2, P_)).movedim(1, 0).unsqueeze(1)
    pages_d, offs_d, vals_d = (t.unsqueeze(1).to(card) for t in (pages, offs, vals))
    with mesh_context(make_mesh((2, 1), ("dp", "sp"), card)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _put(dst, li, _Writes((pages_d, offs_d), pages_d < P_, P_, L), vals_d)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(pool.cpu().view(torch.uint8), want.view(torch.uint8))


def _serve_engine(card, **kw):
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.serve import ServeConfig, ServeEngine

    cfg = TransformerConfig(d_model=64, n_heads=4, n_experts=4, d_ff=96, n_layers=2,
                            capacity_factor=4.0)
    scfg = ServeConfig(n_slots=4, n_pages=64, page_size=8, max_seq=96, vocab=32, seed=1, **kw)
    return ServeEngine(make_mesh((1, 1), ("dp", "sp"), card), cfg, scfg)


def _periodic_requests(n=4, max_new=40):
    from tpuscratch_torch.serve import Request

    return [Request(rid=i, prompt=tuple((t % (2 + i % 3)) + 1 for t in range(12 + i)),
                    max_new=max_new) for i in range(n)]


@pytest.mark.parametrize("kw", [dict(), dict(spec_k=3), dict(macro_steps=16),
                                dict(macro_steps=16, kv_dtype="int8"),
                                dict(spec_k=3, macro_steps=4)],
                         ids=["decode", "verify", "macro16", "macro16-int8", "spec-macro4"])
def test_a_dispatch_makes_one_host_sync(card, kw):
    """One engine tick past admission (a decode step, a verify step, a
    macro dispatch) under ``set_sync_debug_mode("error")``: the one pull of
    its sampled tokens (exempt inside the engine) is its only host sync."""
    eng = _serve_engine(card, fused_attention="on", **kw)
    for r in _periodic_requests():
        eng.submit(r)
    eng.step()                          # admissions (prefill, first token) and a dispatch
    assert eng.n_active == 4 and not eng.n_queued
    syncs0, disp0 = eng.host_syncs, eng.dispatches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.dispatches - disp0 == 1 and eng.host_syncs - syncs0 == 1


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 4)])
def test_accept_batch_on_the_card_equals_the_cpu(card, temperature, top_k):
    """The device accept rule on the card against the same call on the CPU:
    the same accepted lengths and terminal tokens (the uniforms, keys and
    argmax are integer or bit-exact; the f32 softmax of the card may move
    a threshold by an ulp, which these draws are not near)."""
    from tpuscratch_torch.serve.sampling import accept_batch, key

    g = torch.Generator(device="cpu").manual_seed(3)
    B, K, V = 16, 5, 64
    logits = torch.randn((B, K, V), generator=g) * 3
    drafts = torch.randint(0, V, (B, K - 1), generator=g, dtype=torch.int32)
    drafts[:8] = logits.argmax(-1)[:8, :K - 1].to(torch.int32)
    dlen = torch.randint(0, K, (B,), generator=g, dtype=torch.int32)
    rids = torch.arange(B, dtype=torch.int32) + 100
    pos0 = torch.arange(B, dtype=torch.int32) * 7
    args = (rids, pos0, logits, drafts, dlen)
    want = accept_batch(key(11, "cpu"), *args, temperature=temperature, top_k=top_k)
    got = accept_batch(key(11, card), *(a.to(card) for a in args), temperature=temperature,
                       top_k=top_k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_macro_dispatch_equal_with_and_without_the_kernel(card, kv_dtype):
    """A T = 16 macro engine with the paged-attention kernel and with the
    plain attention: equal greedy outputs, and the kernel launched n_layers
    x T times a dispatch (every round runs, masked)."""
    reports = {}
    for mode in ("off", "on"):
        eng = _serve_engine(card, fused_attention=mode, macro_steps=16, kv_dtype=kv_dtype)
        ta.reset_launches()
        reports[mode] = eng.run(_periodic_requests(max_new=24))
        if mode == "on":
            assert ta.launch_counts()["paged_attention"] == 2 * 16 * reports[mode].dispatches
    assert reports["on"].outputs == reports["off"].outputs
