"""Continuous-batching inference: the train-and-serve split, demonstrated.

The twin of ``examples/ex24_serving.py``. The same parameter tree and (dp
x sp) mesh the training step uses serves autoregressive generation: a
block-paged KV cache (pages over dp, heads over sp), cached single-token
decode, and the continuous-batching engine with more requests than
decode slots, mixed prompt lengths and budgets, admission gated on each
group's free pages and finished sequences evicted mid-stream. The report
shows one decode program however many requests churn through, and every
page back on the free list at drain.

``--int8`` stores K/V pages quantized (int8 with per-page scales),
``--spec[=K]`` turns on self-drafted speculation (K draft tokens verified
a sweep), with the accounting identity ``tokens == prefills + slot_steps
+ accepted`` asserted. A closing section runs macro-step decode
(``macro_steps=4``: one dispatch and one host sync per 4 tokens) against
the per-token engine: equal outputs, and ``dispatches == ceil(slot_steps
/ 4)`` on a single stream. The 2x4 mesh's 8 ranks are stacked on the
card unless the CPU is asked for.

argv tier:  ex24_serving.py [--decode-slots=N] [--kv-pages=N]
            [--page-size=N] [--spec[=K]] [--int8]
"""

import dataclasses
import math
import sys

from tpuscratch_torch.examples._common import banner, ensure_devices


def main(argv=None, device=None) -> None:
    device = ensure_devices(device=device)
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.runtime.config import Config
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.serve import Request, ServeConfig, ServeEngine

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # sugar over the Config flag tier: bare --int8 / --spec spellings
    argv = ["--kv-dtype=int8" if a == "--int8" else "--spec=3" if a == "--spec" else a
            for a in argv]
    cli = Config.load(argv)
    mesh = make_mesh((2, 4), ("dp", "sp"), device)
    cfg = TransformerConfig(d_model=32, n_heads=4, n_experts=2, d_ff=64, n_layers=2,
                            capacity_factor=2.0)
    scfg = ServeConfig(n_slots=cli.decode_slots, n_pages=cli.kv_pages, page_size=cli.page_size,
                       max_seq=48, vocab=64, temperature=0.7, top_k=8, seed=0,
                       kv_dtype=cli.kv_dtype, spec_k=cli.spec)
    banner(f"serving on a 2x4 (dp x sp) mesh: {scfg.n_slots} decode slots, "
           f"{scfg.n_pages} pages/group x {scfg.page_size} tokens, kv={scfg.kv_dtype}"
           + (f", speculative k={scfg.spec_k}" if scfg.spec_k else ""))

    engine = ServeEngine(mesh, cfg, scfg)
    free0 = engine.free_pages()
    # periodic prompts when speculating (the draftable regime), mixed-length
    # ones otherwise; both 2x oversubscribed so queueing is real
    if scfg.spec_k:
        prompts = [tuple((j % (2 + i % 3)) + 1 for j in range(4 + (3 * i) % 7))
                   for i in range(2 * scfg.n_slots)]
    else:
        prompts = [tuple((3 * i + j) % scfg.vocab for j in range(2 + (5 * i) % 9))
                   for i in range(2 * scfg.n_slots)]
    requests = [Request(rid=i, prompt=p, max_new=3 + (7 * i) % 10) for i, p in enumerate(prompts)]
    report = engine.run(requests)

    for rid, toks in report.outputs:
        print(f"request {rid:2d}: prompt {len(prompts[rid]):2d} tokens -> {list(toks)}")
    banner("report")
    print(f"completed {report.completed} requests, {report.tokens_generated} tokens in "
          f"{report.decode_steps} decode steps + {report.prefills} prefills")
    print(f"compiles: decode {report.decode_compiles} (steady state never recompiles), "
          f"prefill {report.prefill_compiles} (one per prompt shape bucket)")
    if scfg.spec_k:
        print(f"speculation: {report.drafted} drafted, {report.accepted} accepted (mean accept "
              f"{report.accept_len_mean:.2f}/{scfg.spec_k} per sweep) — {report.slot_steps} "
              f"sweeps for {report.tokens_generated - report.prefills} decoded tokens")
    if scfg.kv_dtype == "int8":
        print(f"kv cache: int8 pages, {engine.kv_bytes_per_token:.0f} B/token of pool capacity "
              f"(fp32 would be {2 * cfg.n_layers * cfg.n_heads * cfg.d_head * 4:.0f})")
    print(f"wall: prefill {report.prefill_s:.3f}s, decode {report.decode_s:.3f}s")
    print(f"pages: {free0} free before, {engine.free_pages()} after drain")
    assert engine.free_pages() == free0, "page leak!"
    assert report.decode_compiles == 1
    # every emitted token is a prefill token, a sweep's base token, or an accepted draft
    assert report.tokens_generated == report.prefills + report.slot_steps + report.accepted, \
        "accepted-token counters do not reconcile with emitted tokens"

    # macro-step decode: one dispatch and one host sync per 4 tokens; a
    # single decoding stream makes dispatches == ceil(slot_steps / T) exact
    banner("macro-step decode (macro_steps=4)")
    macro_req = Request(rid=1000, prompt=(1, 2, 3), max_new=10)
    m1 = ServeEngine(mesh, cfg, dataclasses.replace(scfg, spec_k=0)).run([macro_req])
    m4 = ServeEngine(mesh, cfg, dataclasses.replace(scfg, spec_k=0, macro_steps=4)).run(
        [macro_req])
    assert m4.outputs == m1.outputs, "macro output diverged from per-token"
    assert m4.dispatches == math.ceil(m4.slot_steps / 4), \
        f"dispatch identity broke: {m4.dispatches} != ceil({m4.slot_steps}/4)"
    assert m1.dispatches == m1.slot_steps  # per-token: one each
    assert m4.host_syncs == m4.dispatches
    print(f"per-token: {m1.slot_steps} decode steps = {m1.dispatches} dispatches / "
          f"{m1.host_syncs} host syncs")
    print(f"macro T=4: same {m4.slot_steps} token steps in {m4.dispatches} dispatches / "
          f"{m4.host_syncs} host syncs (= ceil({m4.slot_steps}/4)), outputs identical")
    print(f"[{device.type}] serving demo PASSED")


if __name__ == "__main__":
    main()
