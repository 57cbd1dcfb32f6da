"""tpuscratch_torch.ops.fill held to its JAX twin, bit for bit.

The JAX side runs its Pallas kernels in interpret mode on the CPU (as
tests/test_ops.py runs them); the torch side runs the plain versions on
the CPU (tests/test_torch_cuda.py holds the CUDA kernels to those on the
card). Tolerance: none. ``fill`` casts the value on the host as
``jnp.asarray([value], dtype)`` does and writes its bits; ``iota2d``
computes ``r * w + c`` in the dtype with one rounding per operation on
both sides. JAX without x64 refuses int64 in ``fill`` and computes int64
iotas in int32, so int64 is held to numpy instead.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages export the functions fill and iota2d, which shadow the
# modules' names as attributes of ``ops``
jf = importlib.import_module("tpuscratch.ops.fill")
tf = importlib.import_module("tpuscratch_torch.ops.fill")

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16), (jnp.int32, torch.int32)]
SHAPES = [(8, 128), (37, 53)]


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy, JAX or torch array, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        size = a.element_size()
        a = a.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[size]).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("value", [2.5, 0.1, -3, 1e6 + 0.7])
def test_fill_bit_equal(jdt, tdt, shape, value):
    want = jf.fill(shape, value, jdt)
    got = tf.fill(shape, value, tdt, device="cpu")
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("value", [7, -(2**40) - 3])
def test_fill_int64(value):
    got = tf.fill((37, 53), value, torch.int64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.full((37, 53), value, np.int64))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(5, 257)])
def test_iota2d_bit_equal(jdt, tdt, shape):
    want = jf.iota2d(shape, jdt)
    got = tf.iota2d(shape, tdt, device="cpu")
    assert got.dtype == tdt
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_iota2d_int64_and_exact_f32():
    got = tf.iota2d((37, 53), torch.int64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.arange(37 * 53).reshape(37, 53))
    # below 2**24 the two roundings of float32 change nothing
    np.testing.assert_array_equal(tf.iota2d((8, 128), device="cpu").numpy(),
                                  np.arange(8 * 128, dtype=np.float32).reshape(8, 128))


def test_refusals():
    with pytest.raises(ValueError, match=r"\(rows, cols\)"):
        tf.iota2d((2, 3, 4), device="cpu")
    with pytest.raises(ValueError, match="negative"):
        tf.fill((2, -1), 0.0, device="cpu")
