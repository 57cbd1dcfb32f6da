"""The host rules of the z-march 3D kernel (``ops.stencil_stream``), of
the folded ring of the DMA ring and resident kernels (``ops.common
.ring_plan``) and of the row march of the streamed, depth-k and
deep-trapezoid 2D kernels (``ops.common.march_plan``), as pure functions
at an H100's 132 SMs and 232,448 B of opt-in shared memory a block: the
fold, the grid, the tiles, strips and chunks they choose, and that every
plan fits."""

import pathlib

import pytest

from tpuscratch_torch.ops import common as tc
from tpuscratch_torch.ops import halo_dma as th
from tpuscratch_torch.ops import stencil_kernel as tk
from tpuscratch_torch.ops import stencil_stream as ts

SMS, OPTIN = 132, 232448


@pytest.mark.parametrize("nt", [7, 27])
@pytest.mark.parametrize("j", range(1, 9))
def test_stream3d_plan_fits(nt, j):
    smem = ts.stream3d_smem(nt, j)
    assert smem <= OPTIN
    assert 2 * (smem + 1024) <= 233_472  # two blocks fit an SM's 228 KB
    rows, cols = ts.stream3d_window(j)
    plan = ts.stream3d_plan((256, 512, 512), 1, j, nt, SMS, 2)
    assert (plan.ty, plan.tx) == (rows - 2 * j, cols - 2 * j) and plan.ty > 0 and plan.tx > 0
    chunks = -(-256 // plan.zc)
    assert plan.blocks == chunks * -(-512 // plan.ty) * -(-512 // plan.tx)
    assert plan.smem == smem


@pytest.mark.parametrize("out,nb,j,zc,blocks", [
    ((256, 512, 512), 1, 4, 64, 1280),   # config 9's tile at k = 4: 320 tiles x 4 chunks
    ((256, 512, 512), 1, 2, 256, 234),   # at k = 2 one chunk a tile fills a wave
    ((256, 256, 256), 8, 4, 128, 1280),  # the 2x2x2 world's stacked ranks
    ((11, 13, 17), 4, 3, 1, 44),         # a small core: a plane a block
])
def test_stream3d_plan_chunks(out, nb, j, zc, blocks):
    plan = ts.stream3d_plan(out, nb, j, 7, SMS, 2)
    assert (plan.zc, plan.blocks) == (zc, blocks)


def test_stream3d_plan_minimises_waves_times_steps():
    out, nb, j = (256, 512, 512), 1, 4
    plan = ts.stream3d_plan(out, nb, j, 7, SMS, 2)
    tiles = plan.blocks // -(-out[0] // plan.zc)

    def cost(zc):
        return -(-tiles * -(-out[0] // zc) // (SMS * 2)) * (zc + 2 * j)

    assert all(cost(plan.zc) <= cost(zc) for zc in range(1, out[0] + 1))


@pytest.mark.parametrize("shape,steps,fold,rounds,blocks", [
    ((4, 4, 2048, 2048), 64, 4, 16, 396),   # config 4: 268 MB a buffer
    ((1, 1, 1024, 1024), 64, 4, 16, 396),   # config 10: 4 MB
    ((1, 1, 1024, 1024), 65, 4, 17, 396),   # a last round of one step
    ((1, 1, 1024, 1024), 4, 4, 1, 396),     # one round
    ((2, 3, 2048, 2048), 64, 4, 16, 396),
    ((1, 1, 2048, 2048), 7, 4, 2, 396),     # a last round of three steps
    ((2, 3, 37, 53), 64, 4, 16, 37),        # 148 strip rows: a warp a row at most
    ((1, 1, 3, 3), 1, 1, 1, 1),
])
def test_ring_plan(shape, steps, fold, rounds, blocks):
    plan = tc.ring_plan(*shape, steps, SMS)
    assert (plan.fold, plan.rounds, plan.blocks) == (fold, rounds, blocks)


@pytest.mark.parametrize("shape", [(4, 4, 2048, 2048), (1, 1, 1024, 1024), (2, 3, 37, 53),
                                   (1, 1, 3, 3), (1, 1, 2560, 2560), (1, 2, 20, 116)])
@pytest.mark.parametrize("steps", [1, 7, 8, 9, 64, 65])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_ring_plan_fits(shape, steps, per_sm):
    plan = tc.ring_plan(*shape, steps, SMS, per_sm)
    L = tc.ring_rows(*shape)
    warps = plan.blocks * tc.RING_WARPS
    assert plan.blocks <= SMS * per_sm  # one cooperative wave
    assert warps - tc.RING_WARPS < L  # no block without a strip row
    # the kernel's even split of the strip rows over the warps covers each once
    spans = [(w * L // warps, (w + 1) * L // warps) for w in range(warps)]
    assert spans[0][0] == 0 and spans[-1][1] == L
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert plan.rounds == -(-steps // plan.fold) and 1 <= plan.fold <= tc.RING_F
    assert plan.fold == min(steps, tc.RING_F)


def test_ring_plan_grid_follows_the_card():
    # as many blocks as the SMs hold, unless the torus has fewer strip rows
    assert tc.ring_plan(4, 4, 2048, 2048, 64, SMS, 2).blocks == 264
    assert tc.ring_plan(4, 4, 2048, 2048, 64, 1, 1).blocks == 1
    assert tc.ring_plan(1, 1, 1024, 1024, 64, 114).blocks == 342
    assert tc.ring_plan(1, 1, 40, 120, 64, SMS).blocks == 10  # 40 rows of one strip


@pytest.mark.parametrize("fold", [1, 2, 4])
def test_ring_plan_takes_a_fold(fold):
    plan = tc.ring_plan(4, 4, 2048, 2048, 65, SMS, fold=fold)
    assert plan.fold == fold and plan.rounds == -(-65 // fold)
    with pytest.raises(ValueError):
        tc.ring_plan(4, 4, 2048, 2048, 65, SMS, fold=tc.RING_F + 1)


def test_ring_vec():
    assert tc.ring_vec(2048, 0, 256) == 4
    assert tc.ring_vec(53, 0) == 1
    assert tc.ring_vec(2048, 8) == 1


# ---------------------------------------------------------------------------
# the row march (stream2d_kernel, dma_deep_kernel)

SM_REGS = 65536  # 32-bit registers an SM
MARCH_SHAPES = [(16, 2048, 2048), (1, 1024, 1024), (1, 8192, 8192), (6, 37, 53), (1, 3, 3),
                (4, 40, 9), (1, 74, 106), (1, 200_000, 300)]


@pytest.mark.parametrize("nb,out_h,out_w", MARCH_SHAPES)
@pytest.mark.parametrize("depth", [1, 2, 3, 8, 16, 17, 32])
@pytest.mark.parametrize("per_sm", [1, 4, 32])
def test_march_plan_fits_and_covers(nb, out_h, out_w, depth, per_sm):
    plan = tc.march_plan(nb, out_h, out_w, depth, SMS, per_sm)
    assert plan.levels == tc.march_levels(depth) and plan.warps == -(-depth // plan.levels)
    assert 1 <= plan.warps <= tc.MARCH_WARPS
    # a block's registers and shared memory fit an SM, and the shared memory
    # needs no opt-in
    assert (plan.warps + 1) * 32 * tc.MARCH_REGS <= SM_REGS  # the stages and the I/O warp
    assert plan.smem == tc.march_smem(plan.warps) == (
        tc.MARCH_WIN + (tc.MARCH_RING + tc.MARCH_HAND * (plan.warps - 1) + 2) * tc.MARCH_WIN) * 4
    assert tc.MARCH_RING >= tc.MARCH_AHEAD + 2  # the rows in flight and the two before
    assert plan.smem <= 48 * 1024 <= OPTIN
    # the window holds the strip and its apron; the apron covers the depth
    # in whole 16-byte groups
    assert plan.apron >= depth and plan.apron % 4 == 0
    assert plan.width % 4 == 0 and plan.width + 2 * plan.apron == tc.MARCH_WIN
    # strips and chunks cover the output once, in at most 65,535 chunks
    assert (plan.strips - 1) * plan.width < out_w <= plan.strips * plan.width
    assert (plan.chunks - 1) * plan.rows < out_h <= plan.chunks * plan.rows
    assert plan.chunks <= 65535


# the paths' shapes at the blocks an SM the H100 holds of each kernel
@pytest.mark.parametrize("nb,out_h,out_w,depth,per_sm,rows,strips", [
    (16, 2048, 2048, 16, 3, 171, 10),  # config 4's stream:16 pass, 4x4 stacked ranks
    (16, 2048, 2048, 32, 1, 410, 11),  # its stream:32 pass
    (1, 1024, 1024, 16, 3, 13, 5),     # the 1x1 world at 1024^2
    (1, 8192, 8192, 8, 4, 547, 35),    # dma-deep:8 on the 8192^2 torus
    (1, 1024, 1024, 8, 4, 10, 5),      # dma-deep:8 on the 1024^2 torus
    (1, 1024, 1024, 1, 18, 13, 5),     # the 9-point dma path's depth-1 rounds
])
def test_march_plan_chunks(nb, out_h, out_w, depth, per_sm, rows, strips):
    plan = tc.march_plan(nb, out_h, out_w, depth, SMS, per_sm)
    assert (plan.rows, plan.strips) == (rows, strips)


@pytest.mark.parametrize("nb,out_h,out_w,depth,per_sm", [
    (16, 2048, 2048, 16, 4), (1, 1024, 1024, 16, 4), (1, 1024, 1024, 1, 32), (6, 37, 53, 3, 16)])
def test_march_plan_minimises_its_cost(nb, out_h, out_w, depth, per_sm):
    plan = tc.march_plan(nb, out_h, out_w, depth, SMS, per_sm)

    def cost(rows):
        return tc.march_cost(nb, out_h, plan.strips, depth, plan.levels, rows, SMS, per_sm)

    # the cheapest of the even chunks, the tallest on a tie
    even = tc.march_chunks(out_h)
    assert plan.rows in even
    assert all(cost(plan.rows) <= cost(rows) for rows in even)
    assert all(cost(plan.rows) < cost(rows) for rows in even if rows > plan.rows)


@pytest.mark.parametrize("out_h", [1, 2, 3, 37, 1024, 2048])
def test_march_chunks_are_even(out_h):
    heights = tc.march_chunks(out_h)
    assert heights == sorted(set(heights), reverse=True)
    assert heights[0] == out_h and heights[-1] == 1
    for rows in heights:
        # c chunks of at most `rows` rows: the last one is the only shorter
        # one, and no shorter height gives as few chunks
        c = -(-out_h // rows)
        assert 0 < out_h - (c - 1) * rows <= rows
        assert rows == 1 or -(-out_h // (rows - 1)) > c
    # every number of chunks has its height
    assert {-(-out_h // rows) for rows in heights} == {-(-out_h // r) for r in range(1, out_h + 1)}


def test_march_plan_grid_follows_the_card():
    # more SMs, shorter chunks and more blocks; on one SM the stacked
    # 8192^2 world takes a chunk a strip
    chunks = [tc.march_plan(1, 1024, 1024, 16, n_sm, 4).chunks for n_sm in (1, 66, 132, 264)]
    assert chunks == sorted(chunks) and chunks[0] < chunks[-1]
    assert tc.march_plan(16, 2048, 2048, 16, 1, 4).chunks == 1


@pytest.mark.parametrize("levels", tc.MARCH_LEVELS)
def test_march_plan_takes_a_plan(levels):
    plan = tc.march_plan(2, 100, 300, min(5, tc.march_depth(levels)), SMS, 4, levels=levels,
                         width=64, rows=7)
    assert (plan.levels, plan.width, plan.rows, plan.strips, plan.chunks) == (
        levels, 64, 7, 5, 15)
    with pytest.raises(ValueError):
        tc.march_plan(2, 100, 300, tc.march_depth(levels) + 1, SMS, 4, levels=levels)
    with pytest.raises(ValueError):
        tc.march_plan(2, 100, 300, 3, SMS, 4, levels=levels, width=6)
    with pytest.raises(ValueError):
        tc.march_plan(2, 100, 300, 3, SMS, 4, levels=3)


@pytest.mark.parametrize("depth,launches", [
    (1, [1]), (16, [16]), (32, [32]), (33, [32, 1]), (81, [32, 32, 17])])
def test_stream2d_plans_chain_deep_passes(depth, launches):
    plans = tc.march_chain(4, 40, 53, depth, SMS, lambda levels, warps: 4)
    assert [p.depth for p in plans] == launches
    # every launch but the last writes the dense grid of the rings still to go
    done = 0
    for p in plans:
        go = depth - done - p.depth
        assert (p.chunks - 1) * p.rows < 40 + 2 * go <= p.chunks * p.rows
        assert (p.strips - 1) * p.width < 53 + 2 * go <= p.strips * p.width
        done += p.depth


@pytest.mark.parametrize("steps,depth,rounds", [
    (19, 8, [8, 8, 3]), (7, 1, [1] * 7), (5, 3, [3, 2]), (81, 81, [32, 32, 17]),
    (64, 32, [32, 32]), (70, 40, [32, 8, 30])])
def test_deep_rounds(steps, depth, rounds):
    assert th.deep_rounds(steps, depth) == rounds


JACOBI5 = (0.25, 0.25, 0.25, 0.25, 0.0)
ODD5 = (0.3, 0.15, 0.2, 0.25, 0.1)
C9 = (0.15, 0.15, 0.1, 0.1, 0.05, 0.05, 0.08, 0.07, 0.25)
NINE = (0.125,) * 4 + (0.0625,) * 4 + (0.0,)
SPARSE = (0.1, 0.0, 0.2, 0.3, 0.05, 0.0, 0.0, 0.0, 0.2)


@pytest.mark.parametrize("coeffs,mask", [
    (JACOBI5, 0x0AA), (ODD5, 0), (NINE, 0x1EF), (C9, 0), (SPARSE, 0)])
def test_march_masks(coeffs, mask):
    # both kernels see the same tap positions; only their sum orders differ
    assert tc.march_mask(ts.stream_c9(coeffs)) == mask
    assert tc.march_mask(th.deep_c9(coeffs)) == mask
    assert ts.stream_c9(coeffs) == th.deep_c9(coeffs)
    assert tc.tap_mask(th.deep_c9(ODD5)) == 0b010111010  # n, w, c, e, s
    assert tc.tap_mask(th.deep_c9(SPARSE)) == 0b000111011  # nw, n, w, c, e


# ---------------------------------------------------------------------------
# the resident kernel (the folded ring over one grid) and the deep
# trapezoid (the row march over a padded tile)


@pytest.mark.parametrize("hw", [(37, 53), (1024, 1024), (2560, 2560)])
@pytest.mark.parametrize("steps", [1, 17, 64, 1000])
@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
def test_resident_plan(hw, steps, per_sm):
    plan = tk.resident_plan(*hw, steps, SMS, per_sm)
    assert plan == tc.ring_plan(1, 1, *hw, steps, SMS, per_sm)
    # folds of at most 4, enough rounds for every step and no round idle
    assert plan.fold == min(steps, tc.RING_F)
    assert plan.rounds * plan.fold >= steps > (plan.rounds - 1) * plan.fold
    # one cooperative wave, and every warp a strip row
    L = tc.ring_rows(1, 1, *hw)
    assert 1 <= plan.blocks <= SMS * per_sm
    assert plan.blocks * tc.RING_WARPS <= L


@pytest.mark.parametrize("hw,steps,fold,rounds,blocks", [
    ((1024, 1024), 1000, 4, 250, 396),  # the headline's resident:8 run at 3 blocks an SM
    ((2560, 2560), 1000, 4, 250, 396),  # the largest grid the L2 rule admits
    ((1024, 1024), 17, 4, 5, 396),      # a last round of one step
    ((1024, 1024), 64, 4, 16, 396),
    ((37, 53), 17, 4, 5, 9),            # 37 strip rows: 9 warps of 4 rows and one of 5
    ((37, 53), 1, 1, 1, 9),
    ((3, 3), 3, 3, 1, 1),               # fewer strip rows than a block's warps
])
def test_resident_plan_picks(hw, steps, fold, rounds, blocks):
    plan = tk.resident_plan(*hw, steps, SMS)
    assert (plan.fold, plan.rounds, plan.blocks) == (fold, rounds, blocks)


@pytest.mark.parametrize("coeffs,comb", [
    ((0.25,) * 4 + (0.0,), tk.SYM), ((0.3, 0.15, 0.2, 0.25, 0.0), tk.NSWE),
    ((0.3, 0.15, 0.2, 0.25, 0.1), tk.NSWEC), ((0.25,) * 5, tk.NSWEC)])
def test_resident_comb(coeffs, comb):
    assert tk.resident_comb(coeffs) == comb


@pytest.mark.parametrize("substeps,launches", [
    (1, [1]), (16, [16]), (32, [32]), (33, [32, 1]), (64, [32, 32]), (70, [32, 32, 6])])
def test_trapezoid_chain(substeps, launches):
    # the deep trapezoid's launches: at most 32 substeps each, every one
    # but the last writing the core and the rings still to go
    chain = tc.march_chain(2, 150, 130, substeps, SMS, lambda levels, warps: 3)
    assert [p.depth for p in chain] == launches and sum(launches) == substeps
    assert all(1 <= p.depth <= tc.march_depth() for p in chain)
    left = substeps
    for p in chain:
        left -= p.depth
        assert (p.chunks - 1) * p.rows < 150 + 2 * left <= p.chunks * p.rows


@pytest.mark.parametrize("nb", [1, 8])
@pytest.mark.parametrize("n,k", [(1024, 16), (1024, 32), (8192, 16), (8192, 32)])
@pytest.mark.parametrize("per_sm", [1, 3, 4])
def test_trapezoid_plan_fits(nb, n, k, per_sm):
    plan, = tc.march_chain(nb, n, n, k, SMS, lambda levels, warps: per_sm)
    assert plan == tc.march_plan(nb, n, n, k, SMS, per_sm)
    assert (plan.levels, plan.warps) == (4, k // 4)
    assert plan.apron == k and plan.width == tc.MARCH_WIN - 2 * k
    assert (plan.strips - 1) * plan.width < n <= plan.strips * plan.width
    assert (plan.chunks - 1) * plan.rows < n <= plan.chunks * plan.rows
    assert plan.chunks <= 65535 and plan.smem <= 48 * 1024


def test_trapezoid_c9():
    # the 5 coefficients by tap position: n 1, w 3, c 4, e 5, s 7, the
    # positions of the trapezoid's tap set, zero coefficients included
    c9 = tk.trapezoid_c9((0.1, 0.2, 0.3, 0.4, 0.5))
    assert c9 == (0.0, 0.1, 0.0, 0.3, 0.5, 0.4, 0.0, 0.2, 0.0)
    assert tc.tap_mask(c9) == tk.TRAPEZOID_TAPS


# the deep trapezoid sums all five taps whatever the coefficients
# (shrink_step adds every term), unlike the streamed and DMA kernels,
# whose references skip zero weights: the kernel's one tap set, the
# TRAP_TAPS the march runs under, is all five, and holds every tap the
# coefficients place
@pytest.mark.parametrize("coeffs", [JACOBI5, ODD5, (0.25, 0.0, 0.25, 0.25, 0.25), (0.0,) * 5])
def test_trapezoid_taps_are_all_five(coeffs):
    assert tk.TRAPEZOID_TAPS == 0b010111010  # n, w, c, e, s
    src = (pathlib.Path(tk.__file__).parents[1] / "csrc" / "stencil2d.cu").read_text()
    assert "constexpr int TRAP_TAPS = 0x0BA;" in src
    assert "run<L, ORDER_NSWE, TRAP_TAPS, false>" in src
    assert tc.tap_mask(tk.trapezoid_c9(coeffs)) & ~tk.TRAPEZOID_TAPS == 0
    with pytest.raises(ValueError, match="5-point"):
        tk.trapezoid_c9(coeffs + (0.0,))


# ---------------------------------------------------------------------------
# the one-step 2D kernel (five_point_kernel): the load width a pitch and
# the buffers' alignment allow


@pytest.mark.parametrize("pw,ptrs,vec", [
    (1026, (0, 1 << 20), 2),    # the headline's 1024 + 2 halo: rows 8-byte aligned
    (1028, (0, 1 << 20), 4),    # 16-byte rows
    (1027, (0, 1 << 20), 1),    # an odd pitch: single columns
    (8194, (256, 512), 2),      # the 8192^2 world
    (1028, (4, 1 << 20), 1),    # a base 4 bytes off
    (1028, (8, 1 << 20), 2),    # a base 8 bytes off
    (1028, (0, 24), 2),         # the output's base decides as well
    (59, (0, 0), 1),            # halo (2, 3) around 53 columns
])
def test_five_plan(pw, ptrs, vec):
    assert tk.five_plan(pw, *ptrs) == vec
    # a group is a whole number of columns of every row, aligned to its size
    assert pw % vec == 0 and all(p % (4 * vec) == 0 for p in ptrs)
