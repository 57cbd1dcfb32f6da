"""tpuscratch_torch.comm (and the runtime layer under it) held to its JAX twin.

Every collective and point-to-point pattern runs under ``run_spmd`` in
both packages on the same integer-valued float32 inputs (made with
numpy): the JAX side under ``shard_map`` on the 8-device CPU mesh, the
torch side on a stacked CPU mesh of the same shape. Integer values make
every sum exact in any order, so the results must be equal bit for bit.
Also: the runtime context, errors and memory staging, and the pingpong
probe on a 2-rank mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import tpuscratch.comm as jc
import tpuscratch.runtime.errors as jerr
import tpuscratch_torch.comm as tc
from _torch_twins import to_torch
from tpuscratch.bench.pingpong import pingpong_program as jax_pingpong_program
from tpuscratch.runtime.mesh import make_mesh as jax_make_mesh
from tpuscratch_torch.bench import pingpong as tp
from tpuscratch_torch.comm.spmd import PartitionSpec
from tpuscratch_torch.runtime import context, errors, memory
from tpuscratch_torch.runtime.mesh import make_mesh

MESHES = {"1d": ((8,), ("x",)), "2d": ((2, 4), ("half", "local"))}


def _data(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(-50, 50, size=shape).astype(np.float32)


def _twin(mesh_key, body, in_specs, out_specs, *arrays):
    """(torch result, JAX result) of ``body(comm_module, *shards)``."""
    shape, names = MESHES[mesh_key]

    def specs(mod, s):
        if isinstance(s, list):  # a tuple of specs (a list here, so it is no spec)
            return tuple(mod(*e) for e in s)
        return mod(*s)

    jf = jc.run_spmd(jax_make_mesh(shape, names), lambda *a: body(jc, *a),
                     specs(JP, in_specs), specs(JP, out_specs))
    tf = tc.run_spmd(make_mesh(shape, names, device="cpu"), lambda *a: body(tc, *a),
                     specs(tc.P, in_specs), specs(tc.P, out_specs))
    return tf(*(to_torch(a) for a in arrays)), jf(*(jnp.asarray(a) for a in arrays))


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


X = ("x",)
HL = ("half", "local")
# (id, mesh, body, in spec, out spec, input shape)
CASES = [
    ("allreduce_sum", "1d", lambda c, x: c.allreduce_sum(x, "x"), X, X, (32,)),
    ("allreduce_max", "1d", lambda c, x: c.allreduce_max(x, "x"), X, X, (32,)),
    ("allreduce_min", "1d", lambda c, x: c.allreduce_min(x, "x"), X, X, (32,)),
    ("reduce_to_root", "1d", lambda c, x: c.reduce_to_root(x, "x"), X, X, (32,)),
    ("reduce_to_root_3", "1d", lambda c, x: c.reduce_to_root(x, "x", root=3), X, X, (32,)),
    ("broadcast_3", "1d", lambda c, x: c.broadcast(x, "x", root=3), X, X, (32,)),
    ("all_gather", "1d", lambda c, x: c.all_gather(x, "x"), X, X, (32,)),
    ("all_gather_tiled", "1d", lambda c, x: c.all_gather(x, "x", tiled=True), X, X, (32,)),
    ("gather_to_root", "1d", lambda c, x: c.gather_to_root(x, "x", root=2), X, X, (32,)),
    ("gather_to_root_tiled", "1d", lambda c, x: c.gather_to_root(x, "x", tiled=True), X, X, (32,)),
    ("scatter_from_root", "1d", lambda c, x: c.scatter_from_root(x, "x"), (), X, (16,)),
    ("scatter_from_root_5", "1d", lambda c, x: c.scatter_from_root(x, "x", root=5), (), X, (16, 3)),
    ("reduce_scatter_tiled", "1d", lambda c, x: c.reduce_scatter(x, "x", tiled=True), X, X, (64,)),
    ("reduce_scatter", "1d", lambda c, x: c.reduce_scatter(x, "x"), X, X, (64, 3)),
    ("reduce_scatter_dim1", "1d", lambda c, x: c.reduce_scatter(x, "x", 1, tiled=True),
     X, X, (16, 16)),
    ("all_to_all_tiled", "1d",
     lambda c, x: c.all_to_all(x, "x", split_axis=1, concat_axis=0, tiled=True),
     ("x", None), ("x", None), (64, 8)),
    ("all_to_all_tiled_01", "1d",
     lambda c, x: c.all_to_all(x, "x", split_axis=0, concat_axis=1, tiled=True),
     ("x", None), ("x", None), (64, 3)),
    ("all_to_all", "1d", lambda c, x: c.all_to_all(x, "x", 0, 1), ("x", None), ("x", None), (64, 3)),
    ("prefix_sum", "1d", lambda c, x: c.prefix_sum(x, "x"), X, X, (32,)),
    ("prefix_sum_exclusive", "1d", lambda c, x: c.prefix_sum(x, "x", exclusive=True), X, X, (32,)),
    ("ring_shift", "1d", lambda c, x: c.ring_shift(x, "x", 1), X, X, (32,)),
    ("ring_shift_open_back", "1d", lambda c, x: c.ring_shift(x, "x", -2, periodic=False),
     X, X, (32,)),
    ("neighbor_exchange_open", "1d", lambda c, x: c.neighbor_exchange(x, "x"), X, [X, X], (32,)),
    ("neighbor_exchange_periodic", "1d", lambda c, x: c.neighbor_exchange(x, "x", periodic=True),
     X, [X, X], (32,)),
    ("send_pairs", "1d", lambda c, x: c.send_pairs(x, "x", [(0, 1), (1, 0)]), X, X, (32,)),
    ("send_pairs_cycle", "1d", lambda c, x: c.send_pairs(x, "x", [(2, 6), (6, 7), (7, 2)]),
     X, X, (32,)),
    ("pingpong", "1d", lambda c, x: c.pingpong(x + 10.0, "x", a=2, b=5, rounds=3), X, X, (32,)),
    ("token_ring_full", "1d", lambda c, x: c.token_ring(x, "x", hops=8), X, X, (32,)),
    ("token_ring_3", "1d", lambda c, x: c.token_ring(x, "x", hops=3, increment=2.0), X, X, (32,)),
    # a 2-axis mesh: sub-communicators (mpi9) and row-major axis tuples
    ("half_vs_world", "2d",
     lambda c, x: (c.allreduce_sum(x, "local"), c.allreduce_sum(x, ("half", "local"))),
     HL, [HL, HL], (4, 12)),
    ("reduce_to_root_local", "2d", lambda c, x: c.reduce_to_root(x, "local"), HL, HL, (4, 12)),
    ("broadcast_half", "2d", lambda c, x: c.broadcast(x, "half", root=1), HL, HL, (4, 12)),
    ("broadcast_world_6", "2d", lambda c, x: c.broadcast(x, ("half", "local"), root=6),
     HL, HL, (4, 12)),
    ("allreduce_max_local", "2d", lambda c, x: c.allreduce_max(x, "local"), HL, HL, (4, 12)),
    ("all_gather_world", "2d", lambda c, x: c.all_gather(x, ("half", "local"), tiled=True),
     HL, HL, (4, 12)),
    ("all_gather_swapped", "2d", lambda c, x: c.all_gather(x, ("local", "half")),
     HL, HL, (4, 12)),
    ("gather_to_root_local", "2d", lambda c, x: c.gather_to_root(x, "local", root=1),
     HL, HL, (4, 12)),
    ("prefix_sum_world", "2d", lambda c, x: c.prefix_sum(x, ("half", "local")), HL, HL, (4, 12)),
    ("prefix_sum_local", "2d", lambda c, x: c.prefix_sum(x, "local", exclusive=True),
     HL, HL, (4, 12)),
    ("reduce_scatter_local", "2d", lambda c, x: c.reduce_scatter(x, "local", 1, tiled=True),
     HL, HL, (4, 16)),
    ("all_to_all_local", "2d",
     lambda c, x: c.all_to_all(x, "local", split_axis=1, concat_axis=0, tiled=True),
     HL, HL, (4, 16)),
    ("ring_shift_local", "2d", lambda c, x: c.ring_shift(x, "local", 1), HL, HL, (4, 12)),
    ("ring_shift_world", "2d", lambda c, x: c.ring_shift(x, ("half", "local"), 3), HL, HL, (4, 12)),
    ("send_pairs_half", "2d", lambda c, x: c.send_pairs(x, "half", [(0, 1)]), HL, HL, (4, 12)),
    ("token_ring_local", "2d", lambda c, x: c.token_ring(x, "local", hops=5), HL, HL, (4, 12)),
]


@pytest.mark.parametrize("mesh_key,body,ins,outs,shape",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_twin_bit_equal(mesh_key, body, ins, outs, shape):
    x = _data(shape, seed=len(shape))
    got, want = _twin(mesh_key, body, ins, outs, x)
    _equal(got, want)


@pytest.mark.parametrize("ins,outs", [
    (("half", None), ("half", None)),       # replicated over "local": rank 0's value out
    ((None, "local"), (None, "local")),
    ((("half", "local"),), (("half", "local"),)),
    ((("local", "half"),), (("local", "half"),)),
    (("local", "half"), ("local", "half")),
    ((), ()),
])
def test_specs_bit_equal(ins, outs):
    # each rank adds its flat index, so a wrong slice or order shows
    def body(c, x):
        return x + _index(c, x)

    got, want = _twin("2d", body, ins, outs, _data((8, 16), seed=3))
    _equal(got, want)


def _index(c, x):
    """Each rank's row-major flat index, as a broadcast of prefix sums of ones."""
    return c.prefix_sum(x * 0 + 1, ("half", "local"), exclusive=True)


def test_send_tree_rides_one_permutation():
    def body(c, k, v):
        out = c.p2p.send_tree({"k": k, "v": (v, v * 2)}, "x", [(0, 3), (3, 0)])
        return out["k"], out["v"][0], out["v"][1]

    a, b = _data((16,), 1), _data((24,), 2)
    got, want = _twin("1d", body, [X, X], [X, X, X], a, b)
    _equal(got, want)


def test_run_spmd_refusals():
    mesh = make_mesh((2, 4), HL, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        tc.run_spmd(mesh, lambda x: x, tc.P("local"), tc.P("local"))(torch.zeros(6))
    with pytest.raises(ValueError, match="unknown axis"):
        tc.run_spmd(mesh, lambda x: tc.allreduce_sum(x, "z"), tc.P("half"), tc.P("half"))(
            torch.zeros(4))
    with pytest.raises(RuntimeError, match="inside run_spmd"):
        tc.allreduce_sum(torch.zeros(2, 4), "half")
    assert repr(PartitionSpec("x", None)) == "P('x', None)"


# ---------------------------------------------------------------------------
# runtime: context, errors, memory


def test_context_hello():
    ctx = context.initialize(device="cpu")
    assert ctx.is_root and ctx.backend == "cpu" and ctx.local_device_count == 1
    assert ctx.hello().startswith("process 0 of 1 on ")
    assert ctx.hello().endswith(": 1 local / 1 global cpu device(s)")
    assert context.node_census(ctx) == 1
    with pytest.raises(NotImplementedError, match="A7"):
        context.initialize(num_processes=2, device="cpu")


@pytest.mark.parametrize("fn,exc", [(lambda: 1 / 0, ZeroDivisionError),
                                    (lambda: [][1], IndexError)])
def test_errors_match_jax(fn, exc):
    msgs = []
    for mod in (errors, jerr):
        with pytest.raises(mod.CommError) as info:
            mod.guard_call(fn, op="probe", rank=2)
        assert isinstance(info.value.__cause__, exc)
        msgs.append(str(info.value))

        @mod.guards(op="entry")
        def entry():
            raise mod.CommError("", "inner")

        with pytest.raises(mod.CommError) as info:
            entry()
        msgs.append(str(info.value))
    assert msgs[:2] == msgs[2:]
    assert msgs[0].startswith("[rank 2] probe: ")


def test_memory_staging_round_trip():
    x = to_torch(_data((3, 5)))
    back = memory.host_roundtrip(x, pinned=False)
    assert torch.equal(back, x) and back.data_ptr() != x.data_ptr()
    assert memory.kind_of(memory.put(x, memory.UNPINNED_HOST)) == memory.UNPINNED_HOST
    assert torch.equal(memory.to_device(x, "cpu"), x)
    with pytest.raises(ValueError, match="unknown memory kind"):
        memory.put(x, "hbm")
    keep = torch.zeros(1 << 16, dtype=torch.float32)  # 256 KiB that stays alive
    assert memory.live_bytes("cpu") >= keep.numel() * 4
    assert memory.live_bytes("cpu", memory.PINNED_HOST) == 0
    stats = memory.memory_stats("cpu")
    assert stats["source"] == "live_tensors_census" and stats["bytes_in_use"] >= 1 << 18
    del keep


# ---------------------------------------------------------------------------
# pingpong on a 2-rank mesh


@pytest.mark.parametrize("n_elems", [1, 64, 1000])
def test_pingpong_program_twin(n_elems):
    x = _data((2 * n_elems,), seed=n_elems)
    want = jax_pingpong_program(jax_make_mesh((2,), ("x",)), "x", n_elems, rounds=2)(jnp.asarray(x))
    got = tp.pingpong_program(make_mesh((2,), ("x",), device="cpu"), "x", n_elems, rounds=2)(
        to_torch(x))
    _equal(got, want)


@pytest.mark.parametrize("n", [1, 2])
def test_verify_echo(n):
    assert tp.verify_echo(make_mesh((n,), ("x",), device="cpu"), "x", 1024)


def test_sweep_small_sizes():
    res = tp.sweep(make_mesh((2,), ("x",), device="cpu"), sizes_bytes=(8, 64, 4096), iters=2,
                   fence="readback")
    assert [r.bytes_moved for r in res] == [16, 128, 8192]
    assert all(r.gbps > 0 and len(r.times_s) == 2 for r in res)


@pytest.mark.parametrize("stage", [tp.host_staging_roundtrip, tp.pageable_buffer_staging_roundtrip,
                                   lambda n, iters, device: tp.pinned_staging_roundtrip(
                                       n, pinned=False, iters=iters, device=device)])
def test_host_staging_on_cpu(stage):
    res = stage(256, iters=2, device="cpu")
    assert res.bytes_moved == 2 * 256 * 4 and len(res.times_s) == 2


def test_config3_on_cpu():
    from tpuscratch_torch.bench import record

    out = []
    line = record.config3_pingpong(out, iters=2, sizes=(8, 1024), device="cpu")
    assert out == [line] and line["metric"] == "pingpong_peak_GBps"
    assert "echo PASSED" in line["detail"] and "no link" in line["detail"]
    assert [r["bytes"] for r in line["sweep"]] == [8, 1024]
