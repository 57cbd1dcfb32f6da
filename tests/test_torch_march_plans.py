"""The host rules of the z-march 3D kernel (``ops.stencil_stream``) and of
the folded DMA ring kernel (``ops.halo_dma``), as pure functions at an
H100's 132 SMs and 232,448 B of opt-in shared memory a block: the fold,
the grid, the tiles and chunks they choose, and that every plan fits."""

import pytest

from tpuscratch_torch.ops import halo_dma as th
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
    plan = th.ring_plan(*shape, steps, SMS)
    assert (plan.fold, plan.rounds, plan.blocks) == (fold, rounds, blocks)


@pytest.mark.parametrize("shape", [(4, 4, 2048, 2048), (1, 1, 1024, 1024), (2, 3, 37, 53),
                                   (1, 1, 3, 3), (1, 1, 2560, 2560), (1, 2, 20, 116)])
@pytest.mark.parametrize("steps", [1, 7, 8, 9, 64, 65])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_ring_plan_fits(shape, steps, per_sm):
    plan = th.ring_plan(*shape, steps, SMS, per_sm)
    L = th.ring_rows(*shape)
    warps = plan.blocks * th.RING_WARPS
    assert plan.blocks <= SMS * per_sm  # one cooperative wave
    assert warps - th.RING_WARPS < L  # no block without a strip row
    # the kernel's even split of the strip rows over the warps covers each once
    spans = [(w * L // warps, (w + 1) * L // warps) for w in range(warps)]
    assert spans[0][0] == 0 and spans[-1][1] == L
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert plan.rounds == -(-steps // plan.fold) and 1 <= plan.fold <= th.RING_F
    assert plan.fold == min(steps, th.RING_F)


def test_ring_plan_grid_follows_the_card():
    # as many blocks as the SMs hold, unless the torus has fewer strip rows
    assert th.ring_plan(4, 4, 2048, 2048, 64, SMS, 2).blocks == 264
    assert th.ring_plan(4, 4, 2048, 2048, 64, 1, 1).blocks == 1
    assert th.ring_plan(1, 1, 1024, 1024, 64, 114).blocks == 342
    assert th.ring_plan(1, 1, 40, 120, 64, SMS).blocks == 10  # 40 rows of one strip


@pytest.mark.parametrize("fold", [1, 2, 4])
def test_ring_plan_takes_a_fold(fold):
    plan = th.ring_plan(4, 4, 2048, 2048, 65, SMS, fold=fold)
    assert plan.fold == fold and plan.rounds == -(-65 // fold)
    with pytest.raises(ValueError):
        th.ring_plan(4, 4, 2048, 2048, 65, SMS, fold=th.RING_F + 1)


def test_ring_vec():
    assert th.ring_vec(2048, 0, 256) == 4
    assert th.ring_vec(53, 0) == 1
    assert th.ring_vec(2048, 8) == 1
