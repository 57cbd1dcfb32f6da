"""tpuscratch_torch.ops.reduction and the dot benchmark held to their JAX twins.

The JAX side runs as tests/test_ops.py runs it: the Pallas kernels in
interpret mode, on the 8-device CPU mesh. The torch side runs its plain
versions on the CPU (tests/test_torch_cuda.py holds the CUDA kernels to
those on the card). Inputs are made from a seed with numpy and go
unchanged into both packages.

Tolerances:
- unit-normal data: |port - jax| <= 1e-5 * sum|x*y| (RTOL_SUM below).
  Both sum float32 products, in different orders (per-chunk partials,
  XLA:CPU's tree reduce, the library dot), which moves the result by a
  few ulps of the running sums, which are bounded by sum|x*y|;
- all-ones and ragged lengths: bit-equal (every partial sum is an
  integer below 2**24, so every order rounds nothing);
- bfloat16 inputs: a float32 result, bit-equal on ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_twins import rand, to_torch
from tpuscratch.bench.dot_bench import dot_program as jax_dot_program
from tpuscratch.comm import run_spmd as jax_run_spmd
from tpuscratch.ops import reduction as jr
from tpuscratch.runtime.mesh import make_mesh_1d as jax_mesh_1d
from tpuscratch_torch.bench import record
from tpuscratch_torch.bench.dot_bench import bench_dot, dot_program
from tpuscratch_torch.comm import P, run_spmd
from tpuscratch_torch.comm.spmd import shards_from_numpy
from tpuscratch_torch.ops import reduction as tr
from tpuscratch_torch.runtime.mesh import make_mesh_1d

RTOL_SUM = 1e-5
METHODS = ["full", "partials", "xla"]
KERNELS = ["full", "partials"]


def _close(got, want, x, y, offset=0.0):
    bound = RTOL_SUM * float(np.abs((x.astype(np.float64) + offset) * y).sum())
    assert abs(float(got) - float(want)) <= bound, (float(got), float(want), bound)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,block_rows", [(4096, 8), (16384, 8), (16384, 512), (3000, 2)])
def test_dot_unit_normal(method, n, block_rows):
    x, y = rand(n, 10), rand(n, 11)
    want = jr.dot(jnp.asarray(x), jnp.asarray(y), method, block_rows=block_rows)
    got = tr.dot(to_torch(x), to_torch(y), method, block_rows=block_rows)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, x, y)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [3000, 8 * 128 * 4, 16384])
def test_dot_ones_bit_equal(method, n):
    x = np.ones(n, np.float32)
    want = float(jr.dot(jnp.asarray(x), jnp.asarray(x), method, block_rows=8))
    assert float(tr.dot(to_torch(x), to_torch(x.copy()), method, block_rows=8)) == want == n


@pytest.mark.parametrize("method", METHODS)
def test_bf16_accumulates_f32(method):
    x = np.ones(8192, np.float32)
    want = jr.dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), method, block_rows=8)
    got = tr.dot(to_torch(x).bfloat16(), to_torch(x).bfloat16(), method, block_rows=8)
    assert got.dtype == torch.float32 and float(got) == float(want) == 8192.0
    # random data rounded to bf16 the same way (round to nearest even) on both sides
    a, b = rand(4096, 12), rand(4096, 13)
    want = jr.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                  method, block_rows=8)
    got = tr.dot(to_torch(a).bfloat16(), to_torch(b).bfloat16(), method, block_rows=8)
    _close(got, want, a, b)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("offset", [0.5, -1.25])
def test_offset(method, offset):
    x, y = rand(4096, 14), rand(4096, 15)
    want = jr.dot(jnp.asarray(x), jnp.asarray(y), method, block_rows=8, offset=offset)
    got = tr.dot(to_torch(x), to_torch(y), method, block_rows=8, offset=offset)
    _close(got, want, x, y, offset)
    # the same offset as a one-element float32 tensor (what a loop carries)
    got_t = tr.dot(to_torch(x), to_torch(y), method, block_rows=8,
                   offset=torch.tensor([offset], dtype=torch.float32))
    assert float(got_t) == float(got)


@pytest.mark.parametrize("method", METHODS)
def test_batched_offsets_are_per_row(method):
    x, y = rand((3, 2000), 16), rand((3, 2000), 17)
    off = torch.tensor([0.0, 0.5, -2.0])
    got = tr.dot(to_torch(x), to_torch(y), method, block_rows=8, offset=off)
    rows = [tr.dot(to_torch(x[i]), to_torch(y[i]), method, block_rows=8, offset=float(off[i]))
            for i in range(3)]
    assert got.shape == (3,)
    if method == "xla":  # a batched library product against single dots: another order
        for i in range(3):
            _close(got[i], rows[i], x[i], y[i], float(off[i]))
    else:  # the same partition and order, row by row
        assert torch.equal(got, torch.stack(rows))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("block_rows", [2, 8])
def test_local_dot_psum_8_ranks(method, block_rows):
    n = 8 * 2048
    x, y = rand(n, 1), rand(n, 2)
    f = jax_run_spmd(
        jax_mesh_1d("x"),
        lambda a, b: jr.local_dot_psum(a, b, "x", method=method, block_rows=block_rows),
        (JP("x"), JP("x")), JP())
    want = f(jnp.asarray(x), jnp.asarray(y))
    g = run_spmd(make_mesh_1d("x", 8, device="cpu"),
                 lambda a, b: tr.local_dot_psum(a, b, "x", method=method, block_rows=block_rows),
                 (P("x"), P("x")), P())
    got = g(to_torch(x), to_torch(y))
    assert got.shape == ()
    _close(got, want, x, y)
    ones = np.ones(n, np.float32)
    assert float(g(to_torch(ones), to_torch(ones))) == float(f(jnp.asarray(ones), jnp.asarray(ones))) == n


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("rounds", [1, 3])
def test_dot_program(method, rounds):
    n = 8 * 1500
    x, y = rand(n, 3), rand(n, 4)
    want = jax_dot_program(jax_mesh_1d("x"), "x", method, block_rows=8, rounds=rounds)(
        jnp.asarray(x), jnp.asarray(y))
    got = dot_program(make_mesh_1d("x", 8, device="cpu"), "x", method, block_rows=8,
                      rounds=rounds)(to_torch(x), to_torch(y))
    _close(got, want, x, y)


def test_prep_matches_jax_blocking():
    x, y = rand(3000, 5), rand(3000, 6)
    jx2, jy2, jgrid, jblock = jr.prep(jnp.asarray(x), jnp.asarray(y), 8)
    x2, y2, grid, block = tr.prep(to_torch(x), to_torch(y), 8)
    assert (grid, block) == (jgrid, jblock)
    np.testing.assert_array_equal(x2.numpy(), np.asarray(jx2))
    np.testing.assert_array_equal(y2.numpy(), np.asarray(jy2))
    for method in KERNELS:
        want = jr.dot_prepped(jx2, jy2, jblock, method)
        _close(tr.dot_prepped(x2, y2, block, method), want, x, y)


def test_refusals_match_jax():
    a, b = torch.ones(8), torch.ones(9)
    with pytest.raises(ValueError, match="unknown dot method"):
        tr.dot(a, a, "atomic")
    with pytest.raises(ValueError, match="shape mismatch"):
        tr.dot(a, b, "full")
    x2, y2, _, block = tr.prep(torch.ones(3000), torch.ones(3000), 8)
    with pytest.raises(ValueError, match="unknown prepped dot method"):
        tr.dot_prepped(x2, y2, block, "xla")
    with pytest.raises(ValueError, match="prepped operands must be"):
        tr.dot_full_prepped(x2[:5], y2[:5], block)
    with pytest.raises(ValueError, match="prepped shape mismatch"):
        tr.dot_partials_prepped(x2, y2[:8], block)
    with pytest.raises(ValueError, match="neither one value nor the batch"):
        tr.dot(torch.ones(2, 8), torch.ones(2, 8), "full", offset=torch.ones(3))


def test_shards_from_numpy():
    a = np.arange(24, dtype=np.float32)
    t = shards_from_numpy(a, 4, device="cpu")
    assert t.shape == (4, 6) and torch.equal(t.flatten(), torch.from_numpy(a))
    with pytest.raises(ValueError):
        shards_from_numpy(a, 5, device="cpu")


@pytest.mark.parametrize("method,rounds", [("full", 1), ("partials", 3), ("xla", 3)])
def test_bench_dot_on_cpu(method, rounds):
    res = bench_dot(make_mesh_1d("x", 8, device="cpu"), n_elems=8 * 1000, method=method,
                    iters=2, rounds=rounds)
    assert res.items == 8000 * rounds and res.bytes_moved == 8 * 8000 * rounds
    assert res.gbps > 0 and len(res.times_s) == 2


def test_config2_on_cpu():
    out = []
    res = record.config2_dot(out, iters=3, n_elems=8000, screen_rounds=2, final_s=0.001,
                             device="cpu")
    assert [line["metric"] for line in out] == ["dot_1e8_f32_call_latency_s",
                                                "dot_1e8_f32_elements_per_s"]
    assert res["winner"] in record.METHODS and set(res["screen"]) == set(record.METHODS)
    assert out[1]["value"] == res["final"].items_per_s and out[1]["platform"] == "cpu"
    with pytest.raises(SystemExit, match="not ported"):
        record.main(["--configs", "1"])


def test_timing_twin():
    from tpuscratch.bench import timing as jt
    from tpuscratch_torch.bench import timing as tt

    begins, ends = [1.0, 1.5, 0.9], [2.0, 2.2, 1.8]
    assert tt.span_max_min(begins, ends) == jt.span_max_min(begins, ends)
    assert tt.percentile([3.0, 1.0, 2.0], 50) == jt.percentile([3.0, 1.0, 2.0], 50)
    for mod in (tt, jt):
        with pytest.raises(ValueError):
            mod.span_max_min([], [])
    kw = dict(name="dot", times_s=(0.002, 0.001, 0.004), bytes_moved=8000, items=1000)
    got, want = tt.BenchResult(**kw), jt.BenchResult(**kw)
    assert (got.best, got.gbps, got.items_per_s, got.summary()) == (
        want.best, want.gbps, want.items_per_s, want.summary())
    res = tt.time_device(lambda a: a + 1, torch.zeros(4), iters=2, warmup=1, fence="readback")
    assert len(res.times_s) == 2
    with pytest.raises(ValueError, match="unknown fence mode"):
        tt.time_device(lambda: torch.zeros(1), iters=1, warmup=0, fence="tunnel")
