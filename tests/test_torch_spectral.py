"""tpuscratch_torch's spectral solvers (``solvers.spectral``) against
tpuscratch's on the same seeded inputs, on the CPU, and both against the
numpy Laplacian.

Both packages divide the same transform by the same sin²-form
eigenvalues; the transforms are two FFT libraries (``impl='xla'``) or
float32 products summed in two orders (``'dft'``), so the twins agree to
1e-5 of max|x| and the residual to the JAX tests' 1e-4 (2D) and 1e-3
(3D)."""

import numpy as np
import pytest
import torch

from _torch_twins import rand
from tpuscratch.runtime.mesh import make_mesh_1d as jax_mesh_1d
from tpuscratch.solvers import spectral as js
from tpuscratch_torch.runtime.mesh import make_mesh_1d
from tpuscratch_torch.solvers import spectral as ts

TWIN = 1e-5


def _lap3(x):
    return 6 * x - sum(np.roll(x, s, a) for a in range(3) for s in (1, -1))


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("impl", ["xla", "dft"])
def test_periodic_poisson_fft_twin(n, impl):
    b = rand((32, 16), 3)
    b -= b.mean()
    want = js.periodic_poisson_fft(b, jax_mesh_1d("x", n), impl=impl)
    got = ts.periodic_poisson_fft(b, make_mesh_1d("x", n, device="cpu"), impl=impl)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TWIN * np.abs(want).max())
    assert abs(got.mean()) < 1e-5
    assert np.abs(ts.periodic_laplacian_np(got.astype(np.float64)) - b).max() < 1e-4
    # only the zero-mean part of b is solvable: a shifted b solves the same
    got2 = ts.periodic_poisson_fft(b + 1.0, make_mesh_1d("x", n, device="cpu"), impl=impl)
    assert np.abs(got2 - got).max() < 1e-4


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("impl", ["xla", "dft"])
def test_periodic_poisson3d_fft_twin(n, impl):
    b = rand((16, 16, 16), 13)
    b -= b.mean()
    want = js.periodic_poisson3d_fft(b, jax_mesh_1d("x", n), impl=impl)
    got = ts.periodic_poisson3d_fft(b, make_mesh_1d("x", n, device="cpu"), impl=impl)
    np.testing.assert_allclose(got, want, rtol=0, atol=TWIN * np.abs(want).max())
    assert np.abs(_lap3(got.astype(np.float64)) - b).max() < 1e-3
    assert abs(got.mean()) < 1e-5


def test_periodic_laplacian_np_is_the_jax_packages():
    x = rand((12, 20), 4).astype(np.float64)
    np.testing.assert_array_equal(ts.periodic_laplacian_np(x), js.periodic_laplacian_np(x))


def test_auto_follows_complex_supported_and_refusals(monkeypatch):
    b = rand((16, 16), 5)
    mesh = make_mesh_1d("x", 2, device="cpu")
    # complex_supported is True on torch, so auto takes the complex path,
    # and the JAX package's TPUSCRATCH_COMPLEX override has no say here
    xla = ts.periodic_poisson_fft(b, mesh, impl="xla")
    np.testing.assert_array_equal(ts.periodic_poisson_fft(b, mesh), xla)
    monkeypatch.setenv("TPUSCRATCH_COMPLEX", "0")
    np.testing.assert_array_equal(ts.periodic_poisson_fft(b, mesh), xla)
    assert not np.array_equal(ts.periodic_poisson_fft(b, mesh, impl="dft"), xla)
    with pytest.raises(ValueError, match="impl must be"):
        ts.periodic_poisson_fft(b, mesh, impl="fftw")
    with pytest.raises(ValueError, match="divisible"):
        ts.periodic_poisson_fft(rand((16, 18), 6), make_mesh_1d("x", 4, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        ts.periodic_poisson3d_fft(rand((16, 6, 8), 7), make_mesh_1d("x", 4, device="cpu"))
    if not torch.cuda.is_available():
        for fn in (ts.periodic_poisson_fft, ts.periodic_poisson3d_fft):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(b if fn is ts.periodic_poisson_fft else rand((8, 8, 8), 8))
