"""tpuscratch_torch.runtime.memory's donation and memory kinds against the
JAX package's (tests/test_memory.py's TestKinds and TestDonate): a donated
step returns what the undonated one does, bit for bit, and afterwards the
donated input holds no memory (the JAX array ``is_deleted()``); an output
that shares storage with a donated input keeps it; the kinds ``put``
reaches from a device include the device's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuscratch.runtime import memory as jm
from tpuscratch_torch.runtime import memory as tm

torch.set_num_threads(1)


class TestKinds:
    def test_device_kind_reported(self):
        assert jm.DEVICE in jm.memory_kinds()
        kinds = tm.memory_kinds("cpu")
        assert tm.DEVICE in kinds and tm.UNPINNED_HOST in kinds
        assert set(kinds) <= set(tm.KINDS)
        # pinning needs a CUDA driver: a CPU-only build of torch has none
        assert (tm.PINNED_HOST in kinds) == torch.cuda.is_available()

    def test_supports_kind(self):
        assert jm.supports_kind(jm.DEVICE) and tm.supports_kind(tm.DEVICE, "cpu")
        assert not jm.supports_kind("no_such_space")
        assert not tm.supports_kind("no_such_space", "cpu")

    def test_kinds_need_a_card_unless_asked_for_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.memory_kinds()


class TestDonate:
    def test_donated_step_matches_undonated(self):
        def jstep(x):
            return x * 2.0 + 1.0

        def tstep(x):
            return x * 2.0 + 1.0

        x = np.arange(16, dtype=np.float32)
        want = np.asarray(jm.donate(jstep)(jnp.asarray(x)))
        np.testing.assert_array_equal(want, np.asarray(jstep(jnp.asarray(x))))
        donated = torch.from_numpy(x.copy())   # memory numpy owns
        got = tm.donate(tstep)(donated)
        np.testing.assert_array_equal(got.numpy(), want)
        assert donated.untyped_storage().nbytes() == 0
        np.testing.assert_array_equal(got.numpy(), tstep(torch.from_numpy(x)).numpy())

    def test_donation_invalidates_input(self):
        jx = jnp.zeros((4096,), dtype=jnp.float32)
        jax.block_until_ready(jm.donate(lambda a: a + 1.0)(jx))
        assert jx.is_deleted()
        x = torch.zeros(4096)
        out = tm.donate(lambda a: a + 1.0)(x)
        assert x.untyped_storage().nbytes() == 0      # x is deleted
        assert float(out.sum()) == 4096.0

    def test_argnums_and_trees(self):
        # only the donated arguments go, every tensor of a donated tree
        def step(state, batch, scale):
            return {"w": state["w"] - scale * batch, "t": state["t"] + 1}

        state = {"w": torch.ones(8), "t": torch.zeros((), dtype=torch.int64)}
        batch = torch.full((8,), 0.5)
        out = tm.donate(step, argnums=(0,))(state, batch, 2.0)
        assert torch.equal(out["w"], torch.zeros(8)) and int(out["t"]) == 1
        assert all(t.untyped_storage().nbytes() == 0 for t in state.values())
        assert batch.untyped_storage().nbytes() == 32

        j_out = jm.donate(lambda s, b: {"w": s["w"] - 2.0 * b, "t": s["t"] + 1}, argnums=(0,))(
            {"w": jnp.ones(8), "t": jnp.zeros((), jnp.int32)}, jnp.full((8,), 0.5))
        np.testing.assert_array_equal(np.asarray(j_out["w"]), out["w"].numpy())

    def test_output_sharing_a_donated_storage_keeps_it(self):
        # an in-place update returns the donated storage itself, a view a
        # part of it: neither is released
        x = torch.arange(6.0)
        out = tm.donate(lambda a: a.mul_(3.0))(x)
        assert torch.equal(out, torch.arange(6.0) * 3.0)
        y = torch.arange(6.0)
        view = tm.donate(lambda a: a[2:4])(y)
        assert torch.equal(view, torch.tensor([2.0, 3.0]))
        z = torch.arange(4.0)
        both = tm.donate(lambda a, b: (a + b, b), argnums=(0, 1))(torch.ones(4), z)
        assert torch.equal(both[1], torch.arange(4.0)) and torch.equal(both[0], z + 1.0)
