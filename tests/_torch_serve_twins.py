"""Helpers of the serving twin tests (tests/test_torch_{spec,macro,prefix}.py):
one traffic through the JAX package's engine and the port's on the CPU,
with the same weights (the JAX draw, moved over as numpy arrays)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuscratch.models.transformer import TransformerConfig as JaxConfig
from tpuscratch.models.transformer import init_params as jax_init_params
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.serve import Request as JaxRequest
from tpuscratch.serve import ServeConfig as JaxServeConfig
from tpuscratch.serve import ServeEngine as JaxEngine
from tpuscratch_torch.models.transformer import TransformerConfig, params_from_numpy
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.serve import Request, ServeConfig, ServeEngine

# tier-1 runs several xdist workers on one host
torch.set_num_threads(1)

# capacity_factor == n_experts: no token is dropped, so outputs do not
# depend on which requests share a batch (the JAX serving tests' rule)
CFG = dict(d_model=32, n_heads=4, n_experts=4, d_ff=48, n_layers=2, capacity_factor=4.0)
# config 12's capacity (2 against 4 experts): the MoE drops tokens, so the
# port must batch every path's tokens as the JAX engine does to agree
CFG_DROP = dict(CFG, capacity_factor=2.0)
#: the engine twins run at both capacities
CAPACITY = pytest.mark.parametrize("cfg", [CFG, CFG_DROP], ids=["cf4", "cf2"])
SCFG = dict(n_slots=4, n_pages=32, page_size=4, max_seq=32, vocab=16, seed=3)
#: the report fields held equal (wall times and TTFT aside)
REPORT = ("completed", "tokens_generated", "decode_steps", "prefills", "decode_compiles",
          "prefill_compiles", "outputs", "quarantined", "slot_steps", "drafted", "accepted",
          "dispatches", "host_syncs", "prefill_tokens", "shared_tokens", "cow_pages",
          "fresh_kv_bytes", "subpage_tokens", "spilled_pages", "prefetched_pages", "cold_hits",
          "host_bytes")


def requests(traffic, jax_side: bool = False) -> list:
    """``(rid, prompt, max_new[, stop_tokens])`` tuples -> Request objects."""
    cls = JaxRequest if jax_side else Request
    return [cls(rid=t[0], prompt=tuple(t[1]), max_new=t[2],
                stop_tokens=tuple(t[3]) if len(t) > 3 else ()) for t in traffic]


def engines(dims=(1, 1), cfg: dict = CFG, jax_kw: dict | None = None, seed: int = 5, **kw):
    """(JAX engine, port engine) over a ``dims`` (dp, sp) mesh with ``SCFG``
    updated by ``kw``; ``jax_kw`` (sink, chaos, recorder) go to the JAX
    engine and are built anew for the port by the caller."""
    scfg = dict(SCFG, **kw)
    n = dims[0] * dims[1]
    jparams = jax_init_params(seed, JaxConfig(**cfg))
    jeng = JaxEngine(jax_mesh(dims, ("dp", "sp"), jax.devices()[:n]), JaxConfig(**cfg),
                     JaxServeConfig(**scfg), params=jparams, **(jax_kw or {}))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jeng, lambda **hooks: ServeEngine(make_mesh(dims, ("dp", "sp"), device="cpu"),
                                             TransformerConfig(**cfg), ServeConfig(**scfg),
                                             params=tparams, **hooks)


def run_both(traffic, dims=(1, 1), cfg: dict = CFG, **kw):
    """Drain ``traffic`` through both engines: (jax engine, its report,
    port engine, its report)."""
    jeng, make = engines(dims, cfg, **kw)
    want = jeng.run(requests(traffic, jax_side=True))
    teng = make()
    got = teng.run(requests(traffic))
    return jeng, want, teng, got


def assert_reports_equal(got, want, skip=()) -> None:
    for name in REPORT:
        if name not in skip:
            assert getattr(got, name) == getattr(want, name), name
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    assert got.accept_len_mean == want.accept_len_mean and got.shared_frac == want.shared_frac
