"""tpuscratch_torch's stencil kernel wrappers.

On the CPU every wrapper runs its kernel's plain torch version; these
tests hold that version to the Pallas twin in tpuscratch (interpret mode
on the CPU, as tests/test_halo.py runs it). With Jacobi coefficients the
order of operations and every rounding match, so results are equal bit
for bit; with GENERAL coefficients the tolerance is FMA_ATOL (see
_torch_twins). tests/test_torch_cuda.py holds each CUDA kernel to its
plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import FMA_ATOL, GENERAL, JACOBI, rand, to_torch
from tpuscratch.halo.layout import TileLayout as JLayout
from tpuscratch.ops import stencil_kernel as jk
from tpuscratch_torch.halo.layout import TileLayout
from tpuscratch_torch.halo.stencil import rebuild
from tpuscratch_torch.ops import stencil_kernel as tk


def _close(got, want, coeffs):
    if coeffs == JACOBI:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FMA_ATOL)


class TestFivePoint:
    @pytest.mark.parametrize("lay", [(16, 16, 1, 1), (13, 21, 2, 3), (64, 96, 1, 1)])
    @pytest.mark.parametrize("coeffs", [JACOBI, GENERAL])
    def test_pallas_twin(self, lay, coeffs):
        tile = rand(TileLayout(*lay).padded_shape, 5)
        want = np.asarray(jk.five_point_pallas(jnp.asarray(tile), JLayout(*lay), coeffs))
        got = tk.five_point_pallas(to_torch(tile), TileLayout(*lay), coeffs).numpy()
        _close(got, want, coeffs)

    @pytest.mark.parametrize("band", [8, 16, 256])
    @pytest.mark.parametrize("coeffs", [JACOBI, GENERAL])
    def test_blocked_twin(self, band, coeffs):
        lay = (32, 24, 1, 1)
        tile = rand(TileLayout(*lay).padded_shape, 6)
        want = np.asarray(jk.five_point_blocked(jnp.asarray(tile), JLayout(*lay), coeffs, band))
        got = tk.five_point_blocked(to_torch(tile), TileLayout(*lay), coeffs, band).numpy()
        _close(got, want, coeffs)

    def test_blocked_drops_band_divisibility(self):
        # the TPU kernel refuses core_h % band != 0; the port computes it
        lay = TileLayout(30, 24, 1, 1)
        tile = to_torch(rand(lay.padded_shape, 7))
        with pytest.raises(ValueError, match="divisible"):
            jk.five_point_blocked(jnp.asarray(tile.numpy()), JLayout(30, 24, 1, 1), JACOBI, 8)
        assert torch.equal(tk.five_point_blocked(tile, lay, JACOBI, 8),
                           tk.five_point_pallas(tile, lay))

    def test_stacked_batch_matches_per_tile(self):
        lay = TileLayout(6, 5, 1, 1)
        tiles = to_torch(rand((2, 4) + lay.padded_shape, 8))
        got = tk.five_point_pallas(tiles, lay, GENERAL)
        for r in range(2):
            for c in range(4):
                assert torch.equal(got[r, c], tk.five_point_pallas(tiles[r, c], lay, GENERAL))

    def test_plain_is_the_new_core(self):
        lay = TileLayout(8, 8, 1, 1)
        tile = to_torch(rand(lay.padded_shape, 9))
        assert torch.equal(rebuild(tile, tk.five_point_plain(tile, lay), lay),
                           tk.five_point_pallas(tile, lay))

    @pytest.mark.parametrize("fn", [tk.five_point_pallas, tk.five_point_blocked])
    def test_refusals(self, fn):
        with pytest.raises(ValueError, match="halo"):
            fn(torch.zeros(4, 6), TileLayout(4, 4, 0, 1))
        with pytest.raises(ValueError, match="padded"):
            fn(torch.zeros(5, 6), TileLayout(4, 4, 1, 1))


class TestDeepTrapezoid:
    @pytest.mark.parametrize("lay,sub,budget", [
        ((32, 24, 3, 3), 3, None),
        ((32, 24, 3, 3), 3, (8 + 6) * 30 * 4),   # JAX banded
        ((32, 24, 4, 4), 2, (8 + 8) * 32 * 4),   # banded + partial substeps
        ((64, 96, 4, 4), 4, None),
        ((16, 16, 4, 4), 1, None),
    ])
    @pytest.mark.parametrize("coeffs", [JACOBI, GENERAL])
    def test_pallas_twin(self, lay, sub, budget, coeffs):
        tile = rand(TileLayout(*lay).padded_shape, 10)
        kw = {} if budget is None else {"budget_bytes": budget}
        want = np.asarray(jk.deep_trapezoid_pallas(jnp.asarray(tile), JLayout(*lay), sub, coeffs, **kw))
        got = tk.deep_trapezoid_pallas(to_torch(tile), TileLayout(*lay), sub, coeffs, **kw).numpy()
        assert got.shape == (lay[0], lay[1])
        _close(got, want, coeffs)

    def test_stacked_batch(self):
        lay = TileLayout(6, 5, 2, 2)
        tiles = to_torch(rand((4, 2) + lay.padded_shape, 11))
        got = tk.deep_trapezoid_pallas(tiles, lay, 2)
        assert tuple(got.shape) == (4, 2, 6, 5)
        assert torch.equal(got[3, 1], tk.deep_trapezoid_pallas(tiles[3, 1], lay, 2))

    def test_refusals(self):
        with pytest.raises(ValueError, match="square"):
            tk.deep_trapezoid_pallas(torch.zeros(8, 6), TileLayout(4, 4, 2, 1), 1)
        for sub in (0, 3):
            with pytest.raises(ValueError, match="substeps"):
                tk.deep_trapezoid_pallas(torch.zeros(8, 8), TileLayout(4, 4, 2, 2), sub)
        with pytest.raises(ValueError, match="padded"):
            tk.deep_trapezoid_pallas(torch.zeros(9, 8), TileLayout(4, 4, 2, 2), 2)


class TestResident:
    @pytest.mark.parametrize("coeffs", [JACOBI, GENERAL, (0.3, 0.2, 0.25, 0.25, 0.0)])
    @pytest.mark.parametrize("steps", [0, 1, 10])
    def test_pallas_twin(self, coeffs, steps):
        core = rand((64, 96), 12)
        want = np.asarray(jk.resident_periodic_pallas(jnp.asarray(core), steps, coeffs))
        got = tk.resident_periodic_pallas(to_torch(core), steps, coeffs).numpy()
        _close(got, want, coeffs)

    def test_never_returns_its_input(self):
        core = torch.ones(4, 4)
        assert tk.resident_periodic_pallas(core, 0).data_ptr() != core.data_ptr()

    def test_l2_rule(self):
        # both ping-pong buffers must fit: 2 * bytes <= l2_limit_bytes
        core = torch.zeros(16, 16)
        assert tk.resident_periodic_pallas(core, 1, l2_limit_bytes=2 * 16 * 16 * 4).shape == (16, 16)
        with pytest.raises(ValueError, match="L2"):
            tk.resident_periodic_pallas(core, 1, l2_limit_bytes=2 * 16 * 16 * 4 - 1)
        with pytest.raises(ValueError, match="L2"):
            tk.resident_periodic_pallas(torch.zeros(2560, 2561), 1)
        assert 2 * 2560 * 2560 * 4 == tk.L2_BYTES

    def test_refusals(self):
        with pytest.raises(ValueError, match="2D"):
            tk.resident_periodic_pallas(torch.zeros(1, 4, 4), 1)
        with pytest.raises(ValueError, match="negative"):
            tk.resident_periodic_pallas(torch.zeros(4, 4), -1)
        with pytest.raises(ValueError, match="unroll"):
            tk.resident_periodic_pallas(torch.zeros(4, 4), 1, unroll=0)


class TestWrapperRouting:
    def test_cpu_runs_plain_and_counts_nothing(self):
        tk.reset_launches()
        lay = TileLayout(8, 8, 2, 2)
        tile = torch.zeros(lay.padded_shape)
        tk.five_point_pallas(tile, lay)
        tk.five_point_blocked(tile, lay)
        tk.deep_trapezoid_pallas(tile, lay, 2)
        tk.resident_periodic_pallas(torch.zeros(8, 8), 3)
        assert tk.launch_counts() == {w.__name__: 0 for w in tk.WRAPPERS}

    def test_other_devices_raise(self):
        lay = TileLayout(8, 8, 1, 1)
        with pytest.raises(ValueError, match="device"):
            tk.five_point_pallas(torch.zeros(lay.padded_shape, device="meta"), lay)

    def test_wrappers_cover_the_four_tpu_kernels(self):
        assert [w.__name__ for w in tk.WRAPPERS] == [
            "five_point_pallas", "five_point_blocked",
            "deep_trapezoid_pallas", "resident_periodic_pallas",
            "seven_point_banded_pallas", "seven_point_strips_pallas",
            "seven_point_assembled_pallas"]  # the four 2D kernels, then the 3D ones


# ---------------------------------------------------------------------------
# zero terms: the reference adds every one of the five terms, a zero
# coefficient's product included (0 x inf is NaN; a sum of -0.0 terms plus
# +0.0 is +0.0), and the port's plain versions, which the CUDA kernels are
# held to bit for bit on the card, do the same. Bits compared; NaN by
# position (the two frameworks' NaN payloads may differ). The products by
# 0.25 are exact, so XLA:CPU's FMA contraction moves no bit.

ZERO_SIDE = (0.25, 0.0, 0.25, 0.25, 0.25)


def _signed_zero_tile(shape, seed: int) -> np.ndarray:
    """Unit-normal data holding one inf and a 16 x 16 checkerboard of 1.0
    and -0.0 (as chip_smoke.py's ``signed_zero_tile``)."""
    tile = rand(shape, seed)
    i = np.arange(16)
    tile[..., 20:36, 20:36] = np.where((i[:, None] + i[None, :]) % 2 == 0, 1.0, -0.0)
    tile[..., 44, 47] = np.inf
    return tile


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.where(nan, 0, got).view(np.uint32),
                                  np.where(nan, 0, want).view(np.uint32))


@pytest.mark.parametrize("kernel", ["five_point", "deep_trapezoid"])
@pytest.mark.parametrize("coeffs", [JACOBI, ZERO_SIDE])
def test_zero_terms_bit_equal(kernel, coeffs):
    lay = (64, 64, 4, 4)
    tile = _signed_zero_tile(TileLayout(*lay).padded_shape, 13)
    if kernel == "five_point":
        want = jk.five_point_pallas(jnp.asarray(tile), JLayout(*lay), coeffs)
        got = rebuild(to_torch(tile), tk.five_point_plain(to_torch(tile), TileLayout(*lay), coeffs),
                      TileLayout(*lay))
    else:
        want = jk.deep_trapezoid_pallas(jnp.asarray(tile), JLayout(*lay), 4, coeffs)
        got = tk.deep_trapezoid_plain(to_torch(tile), TileLayout(*lay), 4, coeffs)
    want = np.asarray(want)
    # the tile makes the zero terms show: 0 x inf, and under Jacobi +0.0
    # sums of -0.0 neighbours and a zero centre term
    assert np.isnan(want).any()
    assert coeffs != JACOBI or ((want == 0) & ~np.signbit(want)).any()
    _same_bits(got.numpy(), want)
