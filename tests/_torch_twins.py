"""Helpers of the tests/test_torch_*.py files: run a JAX reference function
per tile under ``shard_map`` on the virtual CPU mesh, and move numpy
inputs into the torch package on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from tpuscratch.comm import run_spmd
from tpuscratch.runtime.mesh import make_mesh_2d as jax_mesh_2d

# tier-1 runs several xdist workers on one host
torch.set_num_threads(1)

TILES = P("row", "col", None, None)
JACOBI = (0.25, 0.25, 0.25, 0.25, 0.0)
# A general 5-point stencil: products by these coefficients are inexact,
# unlike Jacobi's 0.25.
GENERAL = (0.3, 0.15, 0.2, 0.25, 0.1)
# Tolerance against a Pallas kernel run in interpret mode with GENERAL
# coefficients: XLA:CPU may contract the kernel body's multiply-adds into
# FMAs, while the torch versions round every product (so does the CUDA
# kernel); on unit-normal data that is an ulp or two per step.
FMA_ATOL = 2e-6


def jax_tiles(dims, tile_fn, tiles: np.ndarray) -> np.ndarray:
    """``tile_fn`` applied to every rank's tile under shard_map over a
    ``dims`` CPU mesh, as the JAX package's own tests run it."""
    mesh = jax_mesh_2d(tuple(dims))
    f = run_spmd(mesh, lambda x: tile_fn(x[0, 0])[None, None], TILES, TILES)
    return np.asarray(f(jnp.asarray(tiles)))


def to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
