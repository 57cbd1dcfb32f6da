"""The port's serving engine (``tpuscratch_torch.serve.engine``) against
the JAX package's: the same tokens for the same traffic (greedy, and
temperature 0.8 with top-k) on a 1x1 and a 1x2 (dp, sp) mesh, the same
report counters, config 12 at the CPU shapes with its lever rows keyed as
the JAX harness keys them, the ServeConfig refusals of the JAX engine, and
the parts not ported (the host KV tier, the tracer) refusing to start."""

import dataclasses

import jax
import numpy as np
import pytest

from tpuscratch.bench.decode_bench import default_decode_setup as jax_decode_setup
from tpuscratch.bench.decode_bench import fitting_batches as jax_fitting_batches
from tpuscratch.models.transformer import TransformerConfig as JaxConfig
from tpuscratch.models.transformer import init_params as jax_init_params
from tpuscratch.runtime.mesh import make_mesh as jax_mesh
from tpuscratch.serve import Request as JaxRequest
from tpuscratch.serve import ServeConfig as JaxServeConfig
from tpuscratch.serve import ServeEngine as JaxEngine
from tpuscratch_torch.bench.record import config12_decode
from tpuscratch_torch.bench.decode_bench import default_decode_setup, fitting_batches
from tpuscratch_torch.models.transformer import TransformerConfig, params_from_numpy
from tpuscratch_torch.runtime.mesh import make_mesh
from tpuscratch_torch.serve import Request, ServeConfig, ServeEngine

CFG = dict(d_model=32, n_heads=4, n_experts=4, d_ff=48, n_layers=2, capacity_factor=2.0)
# six requests over four slots: mixed prompt lengths (two prompt buckets),
# budgets of 1 to 6, one stop token
TRAFFIC = [(i, tuple(t % 16 for t in range(1, 2 + (i * 5) % 11)), 1 + (i * 5) % 6,
            (5,) if i == 4 else ())
           for i in range(6)]
COUNTERS = ("completed", "tokens_generated", "decode_steps", "prefills", "decode_compiles",
            "prefill_compiles", "slot_steps", "dispatches", "host_syncs", "prefill_tokens",
            "fresh_kv_bytes", "outputs")


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 4)])
@pytest.mark.parametrize("dims", [(1, 1), (1, 2)])
def test_engine_equals_jax_engine(dims, temperature, top_k):
    kw = dict(n_slots=4, n_pages=16, page_size=4, max_seq=24, vocab=16, seed=3,
              temperature=temperature, top_k=top_k)
    n = dims[0] * dims[1]
    jparams = jax_init_params(5, JaxConfig(**CFG))
    jeng = JaxEngine(jax_mesh(dims, ("dp", "sp"), jax.devices()[:n]), JaxConfig(**CFG),
                     JaxServeConfig(**kw), params=jparams)
    want = jeng.run([JaxRequest(rid=r, prompt=p, max_new=m, stop_tokens=s)
                     for r, p, m, s in TRAFFIC])
    teng = ServeEngine(make_mesh(dims, ("dp", "sp"), device="cpu"), TransformerConfig(**CFG),
                       ServeConfig(**kw),
                       params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    free0 = teng.free_pages()
    got = teng.run([Request(rid=r, prompt=p, max_new=m, stop_tokens=s) for r, p, m, s in TRAFFIC])
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    assert teng.free_pages() == free0  # no page leaks
    assert got.prefill_compiles == 2 and got.decode_compiles == 1


def test_quantized_engine_equals_jax_engine():
    kw = dict(n_slots=4, n_pages=16, page_size=4, max_seq=24, vocab=16, kv_dtype="int8")
    jeng = JaxEngine(jax_mesh((1, 1), ("dp", "sp"), jax.devices()[:1]), JaxConfig(**CFG),
                     JaxServeConfig(**kw))
    want = jeng.run([JaxRequest(rid=r, prompt=p, max_new=m) for r, p, m, _ in TRAFFIC])
    eng = ServeEngine(make_mesh((1, 1), ("dp", "sp"), device="cpu"), TransformerConfig(**CFG),
                      ServeConfig(**kw))
    got = eng.run([Request(rid=r, prompt=p, max_new=m) for r, p, m, _ in TRAFFIC])
    assert got.outputs == want.outputs
    assert (eng.kv_cache_bytes, eng.kv_bytes_per_token) == (jeng.kv_cache_bytes,
                                                           jeng.kv_bytes_per_token)


def test_config12_rows_at_cpu_shapes():
    out: list = []
    res = config12_decode(out, device="cpu")
    assert [r["metric"] for r in out] == ["serve_decode_tokens_per_s", "serve_decode_roofline",
                                          "serve_kv_cache_bytes", "serve_decode_spec",
                                          "serve_prefix_share", "serve_decode_macro"]
    assert [r["batch"] for r in out[0]["sweep"]] == [1, 4]
    assert all(r["platform"] == "cpu" and r["device"] == "cpu" for r in out)
    assert out[1]["kernel"] == "dense" and "fused_speedup" not in out[1]
    assert out[2]["bytes_per_token_f32"] == 256.0 and out[2]["bytes_per_token_int8"] == 68.0
    assert res["fused"] is None and len(res["sweep"]) == 2
    spec, share, macro = out[3:]
    assert spec["accept_len_mean"] > 0 and spec["value"] > 0
    assert 1.0 > share["prefill_frac_r50"] > share["prefill_frac_r90"]
    assert [macro[f"dispatches_per_token_t{T}"] for T in (1, 4, 16)] == [1.0, 0.25, 0.0625]
    assert macro["host_syncs_per_token_t16"] == 0.0625 and res["macro_batch"] == 1
    # the long mix holds the chunked outputs to the monolithic run's here
    assert res["longmix_against"] == "monolithic" and res["longmix"]["mono_diff"] == 0


def _jax_row_keys(metric: str) -> set:
    """The keywords the JAX harness's ``_emit`` of ``metric`` names, read
    from its source."""
    import ast
    import pathlib

    src = pathlib.Path(__file__).resolve().parents[1] / "tpuscratch" / "bench" / "record.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit":
            kw = {k.arg: k.value for k in node.keywords}
            if isinstance(kw.get("metric"), ast.Constant) and kw["metric"].value == metric:
                return set(kw)
    raise AssertionError(f"no _emit of {metric} in the JAX harness")


def test_config12_lever_rows_keys_follow_the_jax_source():
    from tpuscratch_torch.bench.record import config12_lever_rows

    out: list = []
    config12_lever_rows(out, device="cpu")
    assert [r["metric"] for r in out] == ["serve_decode_spec", "serve_prefix_share",
                                          "serve_decode_macro"]
    for row in out:
        assert set(row) - {"platform", "device"} == _jax_row_keys(row["metric"]), row["metric"]
        assert row["platform"] == "cpu" and row["config"] == 12


@pytest.mark.parametrize("on_card", [True, False])
def test_decode_setup_and_budget_equal_jax(on_card):
    # the card takes the JAX package's TPU shapes of config 12, the CPU its CPU shapes
    cfg, scfg, batches, kw = default_decode_setup(on_card)
    jcfg, jscfg, jbatches, jkw = jax_decode_setup(on_card)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)
    assert (batches, kw) == (jbatches, jkw)
    assert fitting_batches(scfg, batches, kw["prompt_len"], kw["measure_steps"]) == \
        jax_fitting_batches(jscfg, jbatches, prompt_len=kw["prompt_len"],
                            measure_steps=kw["measure_steps"])


@pytest.mark.parametrize("knob,value", [("kv_host_pages", 8), ("tracer", "a tracer")])
def test_levers_not_ported_raise(knob, value):
    # the host KV tier and the per-request tracer wait for ROADMAP A14's parts 3 and 4
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        if knob == "tracer":
            ServeEngine(mesh, TransformerConfig(), ServeConfig(), tracer=value)
        else:
            ServeEngine(mesh, TransformerConfig(), dataclasses.replace(ServeConfig(),
                                                                       **{knob: value}))


@pytest.mark.parametrize("bad", [dict(spec_k=-1), dict(macro_steps=0), dict(chunk_prefill=-1),
                                 dict(retry_budget=1, prefix_share=True),
                                 dict(retry_budget=1, chunk_prefill=4)],
                         ids=["spec_k", "macro_steps", "chunk_prefill", "retry-share",
                              "retry-chunk"])
def test_serve_config_refusals_equal_jax(bad):
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_mesh((1, 1), ("dp", "sp"), jax.devices()[:1]), JaxConfig(**CFG),
                  JaxServeConfig(**bad))
    with pytest.raises(ValueError) as got:
        ServeEngine(make_mesh((1, 1), ("dp", "sp"), device="cpu"), TransformerConfig(**CFG),
                    ServeConfig(**bad))
    assert str(got.value) == str(want.value)


def test_engine_refusals():
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    for bad in (dict(kv_dtype="int4"), dict(fused_attention="maybe"), dict(max_seq=1024)):
        with pytest.raises(ValueError):
            ServeEngine(mesh, TransformerConfig(), ServeConfig(**bad))
    eng = ServeEngine(mesh, TransformerConfig(), ServeConfig(vocab=16, max_seq=16))
    for req in (Request(0, (1,), 0), Request(-1, (1,), 1), Request(0, (), 1),
                Request(0, (99,), 1), Request(0, (1,) * 12, 8)):
        with pytest.raises(ValueError):
            eng.submit(req)
    eng.submit(Request(1, (1,), 1))
    with pytest.raises(ValueError, match="already used"):
        eng.submit(Request(1, (2,), 1))
    # "on" demands the kernel, which the CPU does not have
    on = ServeEngine(mesh, TransformerConfig(), ServeConfig(fused_attention="on"))
    with pytest.raises(ValueError, match="no CPU mode"):
        on.run([Request(0, (1, 2), 3)])
