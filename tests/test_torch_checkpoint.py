"""The port's checkpoint layer (``tpuscratch_torch.runtime.checkpoint`` and
``runtime.async_ckpt``) against the JAX package's: one on-disk format, so
a tree saved by either package restores in the other bit for bit (leaves
flattened in ``jax.tree.flatten``'s order, dict keys sorted); the same
refusals of torn and drifted leaves and of a mismatched ``mesh_shape``;
the crash-safety of the aside/GC scheme under a hook that raises at every
save stage; and the async snapshot, which must hold the values the tree
had when it was taken, whatever the caller writes into its tensors
afterwards. Every comparison is of bits (no tolerance)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuscratch.runtime import checkpoint as jck
from tpuscratch_torch.runtime import checkpoint as tck
from tpuscratch_torch.runtime.async_ckpt import AsyncCheckpointer
from tpuscratch_torch.runtime.errors import CommError

torch.set_num_threads(1)


def _tree(seed):
    """A nested tree of every leaf kind both packages save: f32 and int32
    arrays, a 0-dim scalar, lists and a tuple, dict keys out of order."""
    rng = np.random.default_rng(seed)
    return {
        "z": rng.standard_normal((3, 5)).astype(np.float32),
        "layers": [{"w": rng.standard_normal((4, 2)).astype(np.float32),
                    "b": rng.integers(-9, 9, (2,)).astype(np.int32)}
                   for _ in range(2)],
        "a": (np.float32(rng.standard_normal()), np.arange(7, dtype=np.float32) / 3),
        "t": np.asarray(3, np.int32),
    }


def _torch_tree(tree):
    return tck.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np_leaves(tree):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in tck.tree_flatten(tree)[0]]


def _same(a, b):
    la, lb = _np_leaves(a), _np_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(la, lb))


def test_flatten_order_is_jax_tree_flatten():
    tree = _tree(0)
    jl, jdef = jax.tree.flatten(tree)
    tl, tdef = tck.tree_flatten(tree)
    assert len(jl) == len(tl)
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes() for a, b in zip(jl, tl))
    assert f"PyTreeDef({tdef})" == str(jdef)
    assert _same(tck.tree_unflatten(tree, tl), tree)
    assert list(tck.tree_unflatten(tree, tl)) == list(tree)  # the example's key order


def test_jax_saved_restores_in_the_port_and_back(tmp_path):
    tree = _tree(1)
    jck.save(tmp_path / "j", 4, jax.tree.map(jnp.asarray, tree), metadata={"who": "jax"})
    got, step, meta = tck.restore(tmp_path / "j", _torch_tree(tree))
    assert step == 4 and meta == {"who": "jax"} and _same(got, tree)
    assert all(isinstance(x, torch.Tensor) for x in tck.tree_flatten(got)[0])

    tck.save(tmp_path / "t", 5, _torch_tree(tree), metadata={"who": "torch"})
    back, step, meta = jck.restore(tmp_path / "t", tree)
    assert step == 5 and meta == {"who": "torch"} and _same(back, tree)
    # the same files: leaves byte for byte, and the manifests alike
    jck.save(tmp_path / "j", 5, tree, metadata={"who": "torch"})
    for i in range(len(tck.tree_flatten(tree)[0])):
        name = f"step_000000005/leaf_{i}.npy"
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    mj, mt = (json.loads((tmp_path / d / "step_000000005" / "manifest.json").read_text())
              for d in ("j", "t"))
    assert mj == mt


def test_restore_puts_tensors_where_the_example_lives(tmp_path):
    tree = _tree(2)
    tck.save(tmp_path / "c", 1, tree)
    got, _, _ = tck.restore(tmp_path / "c", tree)          # numpy example -> numpy
    assert all(isinstance(x, np.ndarray) for x in tck.tree_flatten(got)[0])
    got, _, _ = tck.restore(tmp_path / "c", _torch_tree(tree))
    assert all(x.device.type == "cpu" for x in tck.tree_flatten(got)[0])


def test_bfloat16_is_refused_not_cast(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        tck.save(tmp_path / "b", 1, {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert tck.steps(tmp_path / "b") == []


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_refusals_of_torn_drifted_and_mismatched_mesh(tmp_path, pkg):
    """The port refuses what the JAX package refuses, on either's files."""
    save = tck.save if pkg == "port" else jck.save
    d = tmp_path / "ck"
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros((), np.int32)}
    save(d, 1, tree, metadata={"mesh_shape": {"dp": 2, "sp": 1}})
    leaf = d / "step_000000001" / "leaf_0.npy"
    data = leaf.read_bytes()
    leaf.write_bytes(data[:-4])
    for restore in (tck.restore, jck.restore):
        with pytest.raises(ValueError, match="torn or corrupted"):
            restore(d, tree, step=1)
    leaf.write_bytes(data)
    for bad in ({"a": np.zeros((3, 2), np.float32), "b": np.zeros((), np.int32)},
                {"a": np.zeros((2, 3), np.float64), "b": np.zeros((), np.int32)}):
        with pytest.raises(ValueError, match="structure drifted"):
            tck.restore(d, bad, step=1)
        with pytest.raises(ValueError, match="structure drifted"):
            tck.restore(d, _torch_tree(bad), step=1)
    with pytest.raises(ValueError, match="leaves"):
        tck.restore(d, {"a": tree["a"]}, step=1)
    with pytest.raises(CommError, match="mesh"):
        tck.restore(d, tree, mesh_shape={"dp": 1, "sp": 1})
    got, _, _ = tck.restore(d, tree, mesh_shape={"dp": 2, "sp": 1})
    assert _same(got, tree)
    # reshard: the saved layout, validated against the manifest
    got, _, _ = tck.restore(d, {"a": np.zeros((6,), np.float32), "b": np.zeros((), np.int32)},
                            mesh_shape={"dp": 1, "sp": 1}, reshard=True)
    assert got["a"].shape == (2, 3)


def test_save_hook_crash_at_any_stage_keeps_published_step(tmp_path):
    """A hook that raises at any stage of an overwriting save leaves the
    published step intact and restorable, in both packages' reading."""
    d = tmp_path / "ck"
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.float32(2.0)}
    tck.save(d, 1, tree)
    tck.save(d, 2, tree)
    for stage in ["begin", "leaf_0", "leaf_1", "manifest", "swap", "publish", "end"]:
        def hook(s, stage=stage):
            if s == stage:
                raise OSError(f"injected crash at {s}")

        with pytest.raises(OSError):
            tck.save(d, 2, _torch_tree(tree), hook=hook)
        assert tck.steps(d) == jck.steps(d) == [1, 2], stage
        got, _, _ = tck.restore(d, tree, step=2)
        np.testing.assert_array_equal(got["a"], tree["a"])


def test_reads_see_stranded_aside_and_writer_collects_orphans(tmp_path):
    d = tmp_path / "ck"
    tree = {"a": np.ones((3,), np.float32)}
    tck.save(d, 1, tree)
    tck.save(d, 2, tree)
    (d / "step_000000002").rename(d / ".old_step_2_999")
    (d / ".tmp_step_2_zzz").mkdir()
    assert tck.steps(d) == [1, 2] and tck.latest_step(d) == 2
    assert (d / ".old_step_2_999").exists() and (d / ".tmp_step_2_zzz").exists()
    got, s, _ = tck.restore(d, tree)
    assert s == 2 and _same(got, tree)
    assert tck.peek_metadata(d) == (2, {})
    tck.save(d, 3, tree)                          # the writer's _gc runs
    assert (d / "step_000000002").exists()
    assert not (d / ".old_step_2_999").exists() and not (d / ".tmp_step_2_zzz").exists()
    assert tck.steps(d) == [1, 2, 3]
    tck.prune(d, keep=1)
    assert tck.steps(d) == [3]


def test_async_snapshot_holds_the_values_it_was_taken_with(tmp_path):
    """The race an async snapshot must not lose: the caller writes into the
    snapshotted tensors in place right after ``snapshot`` returns (as a
    donated optimizer state is updated), and the published checkpoint must
    still hold the values at snapshot time. A snapshot that kept views of
    the caller's storage would publish the new values."""
    tree = _torch_tree(_tree(3))
    want = tck.to_host(tree)
    want = tck.tree_map(lambda a: np.array(a, copy=True), want)
    with AsyncCheckpointer() as ck:
        ck.snapshot(tmp_path / "a", 1, tree, metadata={"m": 1})
        for leaf in tck.tree_flatten(tree)[0]:
            leaf.add_(1)                           # the next chunk, in place
        ck.drain()
    got, step, meta = tck.restore(tmp_path / "a", want)
    assert step == 1 and meta == {"m": 1} and _same(got, want)
    # byte-identical to a blocking save of the same values
    tck.save(tmp_path / "b", 1, want, metadata={"m": 1})
    for f in sorted((tmp_path / "b" / "step_000000001").iterdir()):
        assert f.read_bytes() == (tmp_path / "a" / "step_000000001" / f.name).read_bytes()


def test_async_writer_failure_surfaces_at_the_barrier(tmp_path):
    from tpuscratch_torch.ft import ChaosPlan, Fault, RetryPolicy

    plan = ChaosPlan(0, [Fault("ckpt/write", stage="manifest", at=(0, 1), times=2)])
    ck = AsyncCheckpointer(chaos=plan, retry=RetryPolicy(max_attempts=2, base_s=0.0))
    ck.snapshot(tmp_path / "f", 1, {"a": torch.zeros(3)})
    with pytest.raises(OSError, match="injected"):
        ck.drain()
    ck.close()
    assert tck.steps(tmp_path / "f") == []
