"""Continuous-batching generation engine over the sharded decode stack.

The twin of ``tpuscratch.serve.engine``: a fixed bank of ``n_slots``
decode slots runs one decode step per tick, and requests are inserted
into and evicted from slots between ticks. Admission is a free-page
watermark: a request enters only when its slot's dp group can cover its
whole page footprint (prompt + budgeted new tokens), counted after the
pages it shares. The decode step always sees all slots (idle ones masked
by ``seq_len == 0`` and sentinel page ids) and prompts pad to
power-of-two buckets, so the engine builds one decode program and one
prefill program per bucket, the counts the JAX engine reports as
compiles. Scheduling is host-side Python between device steps; each
decode dispatch pulls its sampled tokens to the host once, and that
pull is its only host sync (inputs go up from pinned memory without
waiting).

The levers, as in the JAX package:

- ``spec_k``: self-drafted speculation, one ``spec_k + 1``-token verify
  program instead of the one-token step, the accept rule of
  ``serve.sampling``;
- ``macro_steps`` (T) and ``async_macro``: T whole ticks a dispatch on
  the device-resident loops of ``serve.decode`` (the speculative loop
  when ``spec_k > 0``); the async tick chains every remaining dispatch of
  a steady bank on the previous one's device carry and syncs once;
- ``prefix_share`` and ``chunk_prefill``: admissions through the context
  prefill program, attaching to shared prefix pages (``PrefixCache``,
  refcounts, copy-on-write, the sub-page boundary copy) and advancing
  long prompts a chunk a tick;
- ``retry_budget``: failed prefills retried in the engine, a request
  that spends its budget quarantined;
- ``sink``, ``chaos`` (the ``serve/prefill`` site) and ``recorder``: the
  observability and fault hooks of ``obs`` and ``ft``.

The host KV tier (``kv_host_pages``) and the per-request tracer
(``tracer=``) are not ported yet and raise ``NotImplementedError``
naming ROADMAP A14.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpuscratch_torch.ft.chaos import bind_sink
from tpuscratch_torch.models.transformer import TransformerConfig, init_params
from tpuscratch_torch.obs.ledger import kv_cache_bytes
from tpuscratch_torch.obs.metrics import MetricsRegistry
from tpuscratch_torch.obs.sink import NullSink
from tpuscratch_torch.obs.trace import FlightRecorder, emit_phase_totals
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device
from tpuscratch_torch.runtime.profiling import Timeline
from tpuscratch_torch.serve.decode import (
    ProgramCounter,
    _axis_len,
    build_context_prefill,
    build_decode_loop,
    build_decode_step,
    build_prefill,
    build_spec_decode_loop,
    build_verify_step,
    check_serve_mesh,
    macro_occupancy,
    propose_draft,
)
from tpuscratch_torch.serve.kvcache import (
    CacheGeometry,
    PageAllocator,
    PrefixCache,
    init_kv_cache,
)
from tpuscratch_torch.serve.sampling import (
    accept_speculative,
    key,
    request_key,
    request_keys,
    sample_batch,
)

#: ServeConfig.kv_dtype spellings -> cache dtype (the fp32 / int8 / fp8 ladder)
_KV_DTYPES = {"float32": torch.float32, "int8": torch.int8, "fp8": torch.float8_e4m3fn}

#: ServeConfig.fused_attention spellings -> the ops.attention ``fused``
#: argument: "auto" routes by device (the kernel on the card, the plain
#: version on the CPU), "on" demands the kernel, "off" forces the plain one
_FUSED_MODES = {"auto": None, "on": True, "off": False}

#: profiling spans kept on the engine's Timeline: a recent window
_MAX_SPANS = 1024


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (the model itself comes from ``TransformerConfig``);
    every field of the JAX package's, with its defaults."""

    n_slots: int = 8          # fixed decode-batch width (all dp groups)
    n_pages: int = 64         # KV pages PER dp group
    page_size: int = 8        # tokens per page
    max_seq: int = 64         # per-request prompt + generated cap
    vocab: int = 32           # token-id space (tied embed/unembed)
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = full distribution
    seed: int = 0             # sampling + embedding seed
    retry_budget: int = 0     # extra prefill attempts before quarantine (0: raise through)
    kv_dtype: str = "float32"  # "float32", "int8" or "fp8" (e4m3)
    fused_attention: str = "auto"  # "auto", "on" or "off"
    spec_k: int = 0           # draft tokens a verify sweep scores (0: no speculation)
    spec_ngram: int = 2       # suffix length of the prompt-lookup draft
    prefix_share: bool = False  # attach admissions to shared prefix pages
    chunk_prefill: int = 0    # prompt tokens a prefilling slot advances a tick (0: whole prompt)
    macro_steps: int = 1      # token rounds a decode dispatch runs (T)
    async_macro: bool = False  # chain a steady bank's dispatches on the device carry
    kv_host_pages: int = 0    # host KV tier pages per group (not ported: A14)

    @property
    def max_pages(self) -> int:
        """Page-table width: the per-request page footprint ceiling."""
        return -(-self.max_seq // self.page_size)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int                  # unique per engine (keys the PRNG stream)
    prompt: tuple[int, ...]   # token ids
    max_new: int              # generation budget (>= 1)
    stop_tokens: tuple[int, ...] = ()  # the stop token is emitted, then the slot finishes


@dataclasses.dataclass(frozen=True)
class GenerateReport:
    """What a drain produced: the JAX package's fields. The speculative
    accounting reconciles: ``tokens_generated == prefills + slot_steps +
    accepted``. The host-tier fields stay 0 until that tier is ported."""

    completed: int
    tokens_generated: int
    decode_steps: int
    prefills: int
    decode_compiles: int
    prefill_compiles: int
    prefill_s: float
    decode_s: float
    outputs: tuple[tuple[int, tuple[int, ...]], ...]  # (rid, tokens) by rid
    quarantined: tuple[int, ...] = ()  # rids dropped this drain (budget spent)
    slot_steps: int = 0       # active-slot decode/verify invocations
    drafted: int = 0          # speculative draft tokens scored
    accepted: int = 0         # draft tokens accepted into outputs
    dispatches: int = 0       # decode-side dispatches run
    host_syncs: int = 0       # pulls of sampled tokens to the host
    prefill_tokens: int = 0   # prompt tokens computed by a prefill program
    shared_tokens: int = 0    # prompt tokens served from shared pages
    cow_pages: int = 0        # copy-on-write page copies
    fresh_kv_bytes: float = 0.0  # K/V bytes written this drain
    subpage_tokens: int = 0   # shared tokens that came by a boundary-page copy
    ttft_s: tuple[tuple[int, float], ...] = ()  # (rid, submit to first token) completed here
    spilled_pages: int = 0    # host tier (not ported)
    prefetched_pages: int = 0
    cold_hits: int = 0
    host_bytes: float = 0.0

    @property
    def accept_len_mean(self) -> Optional[float]:
        """Mean accepted draft length per verify sweep (None: no sweeps)."""
        if self.slot_steps == 0:
            return None
        return self.accepted / self.slot_steps

    @property
    def shared_frac(self) -> float:
        """Fraction of admitted prompt tokens served from shared pages."""
        total = self.prefill_tokens + self.shared_tokens
        return self.shared_tokens / total if total else 0.0


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: tuple[int, ...]   # kept for replay on recovery
    pages: list[int]          # LOCAL page ids in this slot's group
    n_cached: int             # tokens whose K/V are in the cache
    max_new: int
    last_token: int
    generated: list[int]
    pending: tuple[int, ...] = ()  # prompt tokens not yet prefilled (context admissions)
    stop: tuple[int, ...] = ()


def macro_clamp(scfg: ServeConfig) -> tuple[int, Optional[str]]:
    """(effective macro_steps, clamping field or None): nothing clamps, as
    in the JAX package (speculation composes with macro steps)."""
    return scfg.macro_steps, None


def validate_request(req: Request, scfg: ServeConfig) -> None:
    """The admission-independent request rules."""
    if req.max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {req.max_new}")
    if req.rid < 0:
        raise ValueError(f"rid must be >= 0, got {req.rid}")
    if not req.prompt:
        raise ValueError("empty prompt")
    if len(req.prompt) + req.max_new > scfg.max_seq:
        raise ValueError(f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                         f"{req.max_new} exceeds max_seq {scfg.max_seq}")
    if any(t < 0 or t >= scfg.vocab for t in req.prompt):
        raise ValueError(f"request {req.rid}: token id out of vocab")
    if any(t < 0 or t >= scfg.vocab for t in req.stop_tokens):
        raise ValueError(f"request {req.rid}: stop token id out of vocab")


def check_serve_config(scfg: ServeConfig) -> None:
    """The JAX engine's refusals of a ServeConfig, then the parts not
    ported yet."""
    if scfg.kv_dtype not in _KV_DTYPES:
        raise ValueError(f"kv_dtype {scfg.kv_dtype!r} not in {sorted(_KV_DTYPES)}")
    if scfg.fused_attention not in _FUSED_MODES:
        raise ValueError(f"fused_attention {scfg.fused_attention!r} not in "
                         f"{sorted(_FUSED_MODES)}")
    if scfg.spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {scfg.spec_k}")
    if scfg.spec_ngram < 1:
        raise ValueError(f"spec_ngram must be >= 1, got {scfg.spec_ngram}")
    if scfg.chunk_prefill < 0:
        raise ValueError(f"chunk_prefill must be >= 0, got {scfg.chunk_prefill}")
    if scfg.kv_host_pages < 0:
        raise ValueError(f"kv_host_pages must be >= 0, got {scfg.kv_host_pages}")
    if scfg.macro_steps < 1:
        raise ValueError(f"macro_steps must be >= 1, got {scfg.macro_steps}")
    if (scfg.prefix_share or scfg.chunk_prefill) and scfg.retry_budget:
        raise ValueError("retry_budget composes with the monolithic admission path only; "
                         "context-prefill admissions (prefix_share / chunk_prefill) keep "
                         "the legacy raise-through contract")
    if scfg.kv_host_pages:
        raise NotImplementedError(
            f"ServeConfig.kv_host_pages={scfg.kv_host_pages} (the host KV tier) is not ported "
            "to tpuscratch_torch yet (ROADMAP A14)")


def init_embed(seed: int, vocab: int, d_model: int, device=None) -> torch.Tensor:
    """Tied token embedding / unembedding table ``(V, d)``: the JAX
    package's draw (a float32 draw over a numpy float64 root, rounded to
    float32 once)."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((vocab, d_model)).astype(np.float32) / np.sqrt(d_model)
    return torch.from_numpy(np.asarray(e, np.float32)).to(resolve_device(device))


def _bucket(n: int) -> int:
    """Prompt shape bucket: next power of two, floor 8."""
    b = 8
    while b < n:
        b *= 2
    return b


@contextlib.contextmanager
def _the_sync(device: torch.device):
    """The pull of a dispatch's sampled tokens: the one host sync a
    dispatch makes, exempt from ``torch.cuda.set_sync_debug_mode`` so that
    a caller holding the engine to "error" catches any other."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class ServeEngine:
    """Sharded continuous-batching engine: ``submit`` queues requests,
    ``step`` runs one admission + decode tick, ``run`` drains.

    Slot ``s`` belongs to dp group ``s // (n_slots / dp_size)``, and its
    pages come from that group's own :class:`PageAllocator`. Everything
    runs on ``mesh.device``; ``params`` and ``embed`` default to the
    seeded draws of ``scfg.seed``. ``sink`` (default ``NullSink``) gets a
    ``serve/engine`` event, a ``serve/tick`` event a tick and a
    ``serve/report`` with a metrics snapshot a drain; ``self.metrics`` is
    the live registry; ``recorder`` (a fresh ``FlightRecorder`` by
    default) holds the prefill and decode spans of ``self.timeline``;
    ``chaos`` (an ``ft.ChaosPlan``) may fail the ``serve/prefill`` site."""

    def __init__(self, mesh: StackedMesh, cfg: TransformerConfig, scfg: ServeConfig,
                 params: Optional[dict] = None, embed: Optional[torch.Tensor] = None,
                 dp: str = "dp", sp: str = "sp", sink=None, chaos=None, recorder=None,
                 tracer=None):
        if tracer is not None:
            raise NotImplementedError("the per-request tracer (tracer=, obs.reqtrace) is not "
                                      "ported to tpuscratch_torch yet (ROADMAP A14)")
        check_serve_mesh(mesh, cfg, dp, sp)
        self._dp_size = _axis_len(mesh, dp)
        if scfg.n_slots % self._dp_size:
            raise ValueError(f"n_slots {scfg.n_slots} not divisible by dp size {self._dp_size}")
        if scfg.max_seq > scfg.n_pages * scfg.page_size:
            raise ValueError(f"max_seq {scfg.max_seq} exceeds one group's pool "
                             f"({scfg.n_pages} pages x {scfg.page_size})")
        check_serve_config(scfg)
        self.mesh, self.cfg, self.scfg = mesh, cfg, scfg
        self.device = mesh.device
        self._quantized = scfg.kv_dtype != "float32"
        self._fused = _FUSED_MODES[scfg.fused_attention]
        self.geom = CacheGeometry(cfg.n_layers, scfg.n_pages, scfg.page_size, cfg.n_heads,
                                  cfg.d_head)
        self.params = params if params is not None else init_params(scfg.seed, cfg, self.device)
        self.embed = (embed if embed is not None
                      else init_embed(scfg.seed, scfg.vocab, cfg.d_model, self.device))
        if tuple(self.embed.shape) != (scfg.vocab, cfg.d_model):
            raise ValueError(f"embed {tuple(self.embed.shape)} != ({scfg.vocab}, {cfg.d_model})")
        self._embed_np = self.embed.cpu().numpy()
        self._kv = self._fresh_kv()
        self._allocators = [PageAllocator(scfg.n_pages) for _ in range(self._dp_size)]
        self._slots: list[Optional[_Slot]] = [None] * scfg.n_slots
        self._slots_per_group = scfg.n_slots // self._dp_size
        self._queue: collections.deque[Request] = collections.deque()
        self._seen_rids: set[int] = set()
        self._chaos = chaos
        self._quarantined: dict[int, str] = {}
        # the rid whose admission raised through the last tick (retry_budget 0)
        self._poison_rid: Optional[int] = None
        # finishes of a tick that an admission raised through: emitted next tick
        self._finish_buf: list[tuple[int, tuple[int, ...]]] = []
        self._seed_key = key(scfg.seed, self.device)
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.timeline = Timeline(self.recorder)
        self.metrics = MetricsRegistry()
        self.sink = sink if sink is not None else NullSink()
        bind_sink(chaos, self.sink)
        self._tick = 0
        self._macro_T = macro_clamp(scfg)[0]
        self.metrics.gauge("serve/macro_steps").set(self._macro_T)
        self.sink.emit("serve/engine", n_slots=scfg.n_slots, n_pages=scfg.n_pages,
                       page_size=scfg.page_size, max_seq=scfg.max_seq, dp_size=self._dp_size,
                       n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_model=cfg.d_model,
                       kv_dtype=scfg.kv_dtype, spec_k=scfg.spec_k,
                       macro_steps=scfg.macro_steps, macro_steps_effective=self._macro_T)
        self.decode_counter = ProgramCounter()
        self.prefill_counter = ProgramCounter()
        common = dict(dp=dp, sp=sp, counter=self.decode_counter, quantized=self._quantized,
                      fused=self._fused)
        self._decode = self._decode_loop = self._spec_loop = None
        if self._macro_T > 1 and scfg.spec_k > 0:
            self._spec_loop = build_spec_decode_loop(
                mesh, cfg, self.geom, self._macro_T, scfg.spec_k, temperature=scfg.temperature,
                top_k=scfg.top_k, ngram=scfg.spec_ngram, **common)
        elif scfg.spec_k > 0:
            self._decode = build_verify_step(mesh, cfg, self.geom, scfg.spec_k, **common)
        elif self._macro_T > 1:
            self._decode_loop = build_decode_loop(mesh, cfg, self.geom, self._macro_T,
                                                  temperature=scfg.temperature,
                                                  top_k=scfg.top_k, **common)
        else:
            self._decode = build_decode_step(mesh, cfg, self.geom, **common)
        self._prefills: dict[int, object] = {}  # bucket len -> program
        self._dp, self._sp = dp, sp
        self._ctx_mode = scfg.prefix_share or scfg.chunk_prefill > 0
        self._chunk = scfg.chunk_prefill if scfg.chunk_prefill > 0 else scfg.page_size
        self._ctx = (build_context_prefill(mesh, cfg, self.geom, self._chunk, dp=dp, sp=sp,
                                           counter=self.prefill_counter,
                                           quantized=self._quantized, fused=self._fused)
                     if self._ctx_mode else None)
        self._tries: Optional[list[PrefixCache]] = (
            [PrefixCache(scfg.page_size) for _ in range(self._dp_size)]
            if scfg.prefix_share else None)
        self._decode_steps = 0
        self._prefill_count = 0
        self._tokens_generated = 0
        self._slot_steps = 0
        self._dispatches = 0
        self._host_syncs = 0
        self._decode_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._prefill_tokens = 0
        self._shared_tokens = 0
        self._fresh_tokens = 0
        self._cow_pages = 0
        self._subpage_tokens = 0
        self._ctx_sweeps = 0
        self._submit_t: dict[int, float] = {}
        self._ttft: dict[int, float] = {}

    # ---- introspection (tests + report) --------------------------------

    @property
    def decode_compiles(self) -> int:
        """Decode programs that have run (the JAX engine's compile count)."""
        return self.decode_counter.count

    @property
    def prefill_compiles(self) -> int:
        """Prefill programs (one per prompt bucket, or the context program)."""
        return self.prefill_counter.count

    def free_pages(self) -> list[int]:
        """Per-group free-page counts (the leak check reads this)."""
        return [a.n_free for a in self._allocators]

    @property
    def kv_cache_bytes(self) -> int:
        """Total cache-pool bytes (pages + quantization scales)."""
        return kv_cache_bytes(self._kv)

    @property
    def kv_bytes_per_token(self) -> float:
        """Cache bytes per token of pool capacity."""
        return self.kv_cache_bytes / (self._dp_size * self.geom.max_tokens)

    @property
    def cached_pages(self) -> int:
        """Pages the next decode sweep will read: over live slots,
        ceil(cached length / page_size)."""
        page = self.scfg.page_size
        return sum(-(-s.n_cached // page) for s in self._slots if s is not None)

    @property
    def tokens_generated(self) -> int:
        return self._tokens_generated

    @property
    def macro_steps_effective(self) -> int:
        """Token rounds a decode dispatch runs (1: the per-token program)."""
        return self._macro_T

    @property
    def dispatches(self) -> int:
        """Decode-side dispatches (steps, verify sweeps, macro loops):
        ``ceil(slot_steps / macro_steps)`` for a single stream."""
        return self._dispatches

    @property
    def host_syncs(self) -> int:
        """Decode-side pulls of sampled tokens to the host."""
        return self._host_syncs

    @property
    def decode_rounds(self) -> int:
        """Token rounds the bank has run: one a decode or verify tick, up
        to ``macro_steps`` a macro dispatch."""
        return self._decode_rounds

    @property
    def slot_steps(self) -> int:
        """Active-slot decode/verify invocations."""
        return self._slot_steps

    @property
    def spec_drafted(self) -> int:
        return self._spec_drafted

    @property
    def spec_accepted(self) -> int:
        return self._spec_accepted

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens computed through a prefill program."""
        return self._prefill_tokens

    @property
    def shared_tokens(self) -> int:
        """Prompt tokens served from shared pages."""
        return self._shared_tokens

    @property
    def cow_pages(self) -> int:
        """Copy-on-write page copies."""
        return self._cow_pages

    @property
    def subpage_tokens(self) -> int:
        """Shared tokens that came by a boundary-page copy."""
        return self._subpage_tokens

    @property
    def ctx_sweeps(self) -> int:
        """Context-prefill program calls (chunks of every prefilling slot)."""
        return self._ctx_sweeps

    @property
    def fresh_kv_bytes(self) -> float:
        """K/V bytes written into the pool (prefilled and generated
        tokens at the pool's bytes per token)."""
        return self._fresh_tokens * self.kv_bytes_per_token

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def _mark_first_token(self, rid: int) -> None:
        """Stamp TTFT at a request's first sampled token (once)."""
        t0 = self._submit_t.pop(rid, None)
        if rid not in self._ttft:
            self._ttft[rid] = time.perf_counter() - t0 if t0 is not None else 0.0
            if len(self._ttft) > 4096:
                self._ttft.pop(next(iter(self._ttft)))

    def prefix_match_tokens(self, prompt: Sequence[int]) -> int:
        """Longest prefix (in tokens) of ``prompt`` the prefix index can
        serve: the full-page chain plus the sub-page continuation; 0
        without ``prefix_share``."""
        if self._tries is None:
            return 0
        best = 0
        for g, trie in enumerate(self._tries):
            alloc = self._allocators[g]
            m = len(trie.match(prompt))
            _, n_sub = trie.match_tail(prompt, m, prefer=lambda p: alloc.refcount(p) > 0)
            best = max(best, m * self.scfg.page_size + n_sub)
        return best

    def take_poison_rid(self) -> Optional[int]:
        """Pop the rid whose admission raised through the last tick."""
        rid, self._poison_rid = self._poison_rid, None
        return rid

    def drop_queued(self, rid: int) -> bool:
        """Remove ``rid`` from the queue (True when found)."""
        for req in list(self._queue):
            if req.rid == rid:
                self._queue.remove(req)
                return True
        return False

    def is_quarantined(self, rid: int) -> bool:
        return rid in self._quarantined

    def quarantine(self, rid: int, reason: str, attempts: int = 1) -> None:
        """Mark ``rid`` quarantined: reported, never requeued."""
        self._quarantined[rid] = reason
        self._submit_t.pop(rid, None)
        self.metrics.counter("serve/quarantined").inc()
        self.sink.emit("ft/quarantine", rid=rid, attempts=attempts, error=reason)

    @property
    def quarantined(self) -> dict[int, str]:
        """{rid: last error} of requests dropped after the retry budget."""
        return dict(self._quarantined)

    def _group_of(self, slot: int) -> int:
        return slot // self._slots_per_group

    def _last_span_s(self) -> float:
        """Seconds of the span just recorded (the Timeline keeps a window)."""
        s = self.timeline.spans[-1].seconds
        if len(self.timeline.spans) > _MAX_SPANS:
            del self.timeline.spans[:-_MAX_SPANS]
        return s

    def _fresh_kv(self) -> dict:
        return init_kv_cache(self.geom, self._dp_size, _KV_DTYPES[self.scfg.kv_dtype],
                             self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; onto the card from pinned
        memory without waiting (no host sync)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _pull(self, *ts: torch.Tensor) -> list[np.ndarray]:
        """A dispatch's outputs on the host in ONE device-to-host copy (the
        dispatch's one host sync): int32 tensors, flattened together."""
        flat = torch.cat([t.reshape(-1).to(torch.int32) for t in ts])
        with _the_sync(self.device):
            host = flat.cpu().numpy()
        out, at = [], 0
        for t in ts:
            out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        return out

    def _free_slot_pages(self, slot: int, st: _Slot) -> None:
        """Drop this slot's holds; pages whose last holder left leave the
        prefix trie too (a dead page must never be matched)."""
        group = self._group_of(slot)
        released = self._allocators[group].free(st.pages)
        if self._tries is not None and released:
            self._tries[group].drop(released)

    def _recover_cache(self) -> None:
        """A device call raised mid-flight: reset the pool and requeue every
        in-flight request from its prompt (rids key the PRNG streams, so
        the replay regenerates the same tokens). The prefix trie clears
        with the pool."""
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            self._free_slot_pages(s, st)
            self._slots[s] = None
            self._queue.appendleft(Request(rid=st.rid, prompt=st.prompt, max_new=st.max_new,
                                           stop_tokens=st.stop))
        if self._tries is not None:
            for trie in self._tries:
                trie.clear()
        self._kv = self._fresh_kv()

    # ---- request lifecycle ---------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req`` (its TTFT clock starts here)."""
        validate_request(req, self.scfg)
        if req.rid in self._seen_rids:
            raise ValueError(f"request id {req.rid} already used")
        self._seen_rids.add(req.rid)
        self._submit_t[req.rid] = time.perf_counter()
        self._queue.append(req)

    def _share_plan(self, req: Request, group: int) -> tuple[list[int], bool, int]:
        """(shared pages, full_aligned, pages to allocate) for admitting
        ``req`` into ``group``: the refcount-aware arithmetic the watermark
        gate and ``_admit_ctx`` share. A whole-prompt page-aligned match
        re-scores the last prompt position, whose write needs a private
        copy of the last shared page: one page of the allocation."""
        n_tok = len(req.prompt)
        total = self.geom.pages_for(n_tok + req.max_new)
        if self._tries is None:
            return [], False, total
        shared = self._tries[group].match(req.prompt)
        m = len(shared)
        full_aligned = m > 0 and m * self.geom.page_size == n_tok
        return shared, full_aligned, total - m + (1 if full_aligned else 0)

    def _find_slot(self, req: Request) -> Optional[int]:
        needs: dict[int, int] = {}  # the plan depends only on the group
        for s, slot in enumerate(self._slots):
            if slot is None:
                group = self._group_of(s)
                if group not in needs:
                    needs[group] = self._share_plan(req, group)[2]
                if self._allocators[group].n_free >= needs[group]:
                    return s
        return None

    def _sample(self, keys, logits) -> torch.Tensor:
        return sample_batch(keys, logits, self.scfg.temperature, self.scfg.top_k)

    def _admit(self, req: Request, slot: int, finished: Optional[list] = None) -> bool:
        """Prefill ``req`` into ``slot``; True when the slot was taken.

        Context admissions (``prefix_share`` / ``chunk_prefill``) go
        through :meth:`_admit_ctx`. Otherwise the prompt's bucket program
        runs, and its first token is drawn from ``request_key(seed, rid,
        0)``. With ``retry_budget == 0`` a failure returns the grant,
        requeues the request at the head, recovers the cache and raises;
        with a budget, failed attempts retry in the engine (cache reset and
        replay between them) and a request that spends ``1 +
        retry_budget`` attempts is quarantined."""
        if self._ctx_mode:
            return self._admit_ctx(req, slot, finished)
        geom, scfg = self.geom, self.scfg
        group = self._group_of(slot)
        n_tok = len(req.prompt)
        pages = self._allocators[group].alloc(geom.pages_for(n_tok + req.max_new))
        if pages is None:
            raise RuntimeError(f"slot {slot}: the watermark admitted request {req.rid} "
                               "but its group is out of pages")
        bucket = _bucket(n_tok)
        if bucket not in self._prefills:
            self._prefills[bucket] = build_prefill(
                self.mesh, self.cfg, geom, dp=self._dp, sp=self._sp,
                counter=self.prefill_counter, quantized=self._quantized)
        x = np.zeros((bucket, self.cfg.d_model), np.float32)
        x[:n_tok] = self._embed_np[list(req.prompt)]
        page_rows = np.full((self._dp_size, scfg.max_pages), geom.n_pages, np.int32)
        page_rows[group, :len(pages)] = pages

        def attempt() -> int:
            if self._chaos is not None:
                self._chaos.maybe_fail("serve/prefill", key=req.rid, op="serve/prefill")
            with self.timeline.span("serve/prefill"):
                out, self._kv = self._prefills[bucket](self.params, self._kv, self._tensor(x),
                                                       self._tensor(page_rows), n_tok)
                logits = out[n_tok - 1][None] @ self.embed.T
                k0 = request_key(scfg.seed, req.rid, 0, self.device)[None]
                return int(self._sample(k0, logits)[0])

        if scfg.retry_budget == 0:
            try:
                tok = attempt()
            except Exception:
                self._allocators[group].free(pages)
                self._queue.appendleft(req)
                self._recover_cache()
                self._poison_rid = req.rid
                raise
        else:
            attempts = 1 + scfg.retry_budget
            for a in range(attempts):
                try:
                    tok = attempt()
                    break
                except Exception as exc:
                    self.metrics.counter("serve/prefill_failures").inc()
                    # every in-flight request replays; this one keeps its grant
                    self._recover_cache()
                    if a + 1 >= attempts:
                        self._allocators[group].free(pages)
                        self.quarantine(req.rid, f"{type(exc).__name__}: {exc}",
                                        attempts=attempts)
                        return False
                    if self.sink.enabled:
                        self.sink.emit("ft/prefill_retry", rid=req.rid, attempt=a + 1,
                                       error=f"{type(exc).__name__}: {exc}")
        self._prefill_s += self._last_span_s()
        self._prefill_count += 1
        self._tokens_generated += 1
        self._mark_first_token(req.rid)
        self._prefill_tokens += n_tok
        self._fresh_tokens += n_tok
        self._slots[slot] = _Slot(rid=req.rid, prompt=req.prompt, pages=pages, n_cached=n_tok,
                                  max_new=req.max_new, last_token=tok, generated=[tok],
                                  stop=req.stop_tokens)
        return True

    def _admit_ctx(self, req: Request, slot: int, finished: Optional[list] = None) -> bool:
        """Context-prefill admission: attach to the shared prefix pages the
        trie matched, allocate only the unshared footprint, and queue the
        unshared prompt tail as the slot's ``pending`` chunks. A
        whole-prompt page-aligned match copies the last shared page into
        the allocation first (the re-score of the last position writes
        there); a match ending mid-page takes the donor's boundary page by
        copy (:meth:`_subpage_attach`). Without a chunk budget the tail
        drains inside this call; with one it advances a chunk a tick.
        Failures keep the raise-through contract."""
        geom, scfg = self.geom, self.scfg
        group = self._group_of(slot)
        alloc = self._allocators[group]
        if self._chaos is not None:
            try:
                self._chaos.maybe_fail("serve/prefill", key=req.rid, op="serve/prefill")
            except Exception:
                self._queue.appendleft(req)
                self._poison_rid = req.rid
                raise
        n_tok = len(req.prompt)
        shared, full_aligned, need = self._share_plan(req, group)
        priv = alloc.alloc(need)
        if priv is None:
            raise RuntimeError(f"slot {slot}: the watermark admitted request {req.rid} "
                               "but its group is out of pages")
        if shared:
            alloc.share(shared)
        if full_aligned:
            # copy-on-write: the re-score writes position n_tok - 1, in the last shared page
            self._copy_page(group, shared[-1], priv[0])
            if self._tries is not None:
                self._tries[group].drop(alloc.free([shared[-1]]))
            pages = shared[:-1] + priv
            n_cached = n_tok - 1
            self._cow_pages += 1
        else:
            pages = shared + priv
            n_cached = len(shared) * geom.page_size
            n_cached += self._subpage_attach(req, group, len(shared), priv[0])
        self._shared_tokens += n_cached
        self._slots[slot] = _Slot(rid=req.rid, prompt=req.prompt, pages=pages, n_cached=n_cached,
                                  max_new=req.max_new, last_token=0, generated=[],
                                  pending=req.prompt[n_cached:], stop=req.stop_tokens)
        self._prefill_count += 1
        if scfg.chunk_prefill == 0:
            while self._slots[slot] is not None and self._slots[slot].pending:
                self._ctx_sweep([slot], finished)
        return True

    def _subpage_attach(self, req: Request, group: int, m: int, target: int) -> int:
        """Sub-page sharing at the admission boundary: a prompt whose match
        continues mid-page past ``m`` full pages copies the donor's
        boundary page into its own first private page ``target``. Returns
        the tokens attached (capped so the tail re-scores at least one
        position), 0 when no live donor continues the match. The donor
        is copied, never refcounted: it keeps writing its own page."""
        if self._tries is None:
            return 0
        alloc = self._allocators[group]
        donor, n_sub = self._tries[group].match_tail(req.prompt, m,
                                                     prefer=lambda p: alloc.refcount(p) > 0)
        n_sub = min(n_sub, len(req.prompt) - 1 - m * self.geom.page_size)
        if donor is None or n_sub <= 0 or alloc.refcount(donor) < 1:
            return 0
        self._copy_page(group, donor, target)
        self._cow_pages += 1
        self._subpage_tokens += n_sub
        self.metrics.counter("serve/subpage_tokens").inc(n_sub)
        return n_sub

    def _ensure_private(self, slot: int, page_index: int) -> None:
        """Copy-on-write guard of the write paths: a slot about to write
        into table entry ``page_index`` must hold that page alone; a shared
        page is copied into a fresh one, the entry swapped and this
        slot's hold on the shared page dropped."""
        st = self._slots[slot]
        group = self._group_of(slot)
        alloc = self._allocators[group]
        page = st.pages[page_index]
        if alloc.refcount(page) <= 1:
            return
        fresh = alloc.alloc(1)
        if fresh is None:
            raise RuntimeError(f"copy-on-write of shared page {page} (slot {slot}) found an "
                               "empty pool: admission reserved too little")
        self._copy_page(group, page, fresh[0])
        st.pages[page_index] = fresh[0]
        released = alloc.free([page])
        if self._tries is not None:
            self._tries[group].drop(released)
        self._cow_pages += 1

    def _copy_page(self, group: int, src: int, dst: int) -> None:
        """Copy one page's K/V (and, on int8 and fp8 pools, its scale rows)
        between group-local page ids, on the device."""
        off = group * self.geom.n_pages
        for buf in self._kv.values():
            buf[:, off + dst] = buf[:, off + src]

    def _ctx_k_of(self, s: int) -> int:
        """Tokens the next context sweep advances for slot ``s``."""
        return max(1, min(self._chunk, len(self._slots[s].pending)))

    def _ctx_sweep(self, slots: list[int], finished: Optional[list]) -> None:
        """One context-prefill chunk for every prefilling slot in ``slots``
        (one wave: the untiered pool seats the whole bank). Each advances
        up to ``chunk`` pending prompt tokens through the context program.
        A slot whose tail drains samples its first token
        (``request_key(seed, rid, 0)``), registers its prompt pages in the
        prefix trie and joins the decode bank, or is evicted here when its
        budget was one token."""
        scfg, geom = self.scfg, self.geom
        n, C = scfg.n_slots, self._chunk
        x = np.zeros((n, C, self.cfg.d_model), np.float32)
        tables = np.full((n, scfg.max_pages), geom.n_pages, np.int32)
        write_pages = np.full((n, C), geom.n_pages, np.int32)
        write_offs = np.zeros((n, C), np.int32)
        seq_lens = np.zeros((n,), np.int32)
        takes: dict[int, int] = {}
        for s in slots:
            st = self._slots[s]
            take = min(C, len(st.pending))
            takes[s] = take
            # the copy-on-write guard before the tables snapshot
            for pi in range(st.n_cached // geom.page_size,
                            (st.n_cached + take - 1) // geom.page_size + 1):
                self._ensure_private(s, pi)
        for s in slots:
            st = self._slots[s]
            take = takes[s]
            x[s, :take] = self._embed_np[list(st.pending[:take])]
            tables[s, :len(st.pages)] = st.pages
            for j in range(take):
                pos = st.n_cached + j
                write_pages[s, j] = st.pages[pos // geom.page_size]
                write_offs[s, j] = pos % geom.page_size
            seq_lens[s] = st.n_cached + 1
        done = [s for s in slots if takes[s] == len(self._slots[s].pending)]
        try:
            with self.timeline.span("serve/prefill"):
                out, self._kv = self._ctx(self.params, self._kv, self._tensor(x),
                                          self._tensor(tables), self._tensor(write_pages),
                                          self._tensor(write_offs), self._tensor(seq_lens))
                if done:
                    # the whole bank at fixed shapes; idle rows draw and are discarded
                    last = np.zeros((n,), np.int64)
                    rids = np.zeros((n,), np.int64)
                    for s in done:
                        last[s] = takes[s] - 1
                        rids[s] = self._slots[s].rid
                    rows = out[torch.arange(n, device=self.device), self._tensor(last)]
                    keys = (request_keys(self._seed_key, self._tensor(rids),
                                         torch.zeros(n, dtype=torch.int64, device=self.device))
                            if scfg.temperature > 0 else None)
                    (first,) = self._pull(self._sample(keys, rows @ self.embed.T))
        except Exception:
            self._recover_cache()
            raise
        self._prefill_s += self._last_span_s()
        self._ctx_sweeps += 1
        for s in slots:
            st = self._slots[s]
            take = takes[s]
            st.n_cached += take
            st.pending = st.pending[take:]
            self._prefill_tokens += take
            self._fresh_tokens += take
        for s in done:
            st = self._slots[s]
            tok = int(first[s])
            st.last_token = tok
            st.generated = [tok]
            self._tokens_generated += 1
            self._mark_first_token(st.rid)
            if self._tries is not None:
                self._tries[self._group_of(s)].insert(st.prompt, st.pages)
            if self._done(st):
                pair = self._evict(s)
                if finished is not None:
                    finished.append(pair)

    def _done(self, st: _Slot) -> bool:
        """Budget exhausted, or the last token is one of the request's stop
        tokens (emitted, then the slot finishes)."""
        return (len(st.generated) >= st.max_new
                or bool(st.stop and st.generated and st.generated[-1] in st.stop))

    def _evict(self, slot: int) -> tuple[int, tuple[int, ...]]:
        st = self._slots[slot]
        self._free_slot_pages(slot, st)
        self._slots[slot] = None
        return st.rid, tuple(st.generated)

    # ---- the tick ------------------------------------------------------

    def step(self) -> list[tuple[int, tuple[int, ...]]]:
        """One engine tick: admit what fits, advance every prefilling slot
        a chunk and every decoding slot a dispatch, evict what finished.
        Returns the finished ``(rid, tokens)`` pairs."""
        t0 = time.perf_counter()
        self._poison_rid = None
        prefills0, tokens0 = self._prefill_count, self._tokens_generated
        accepted0, ptok0 = self._spec_accepted, self._prefill_tokens
        finished = self._tick_inner()
        self._observe_tick(time.perf_counter() - t0, inserted=self._prefill_count - prefills0,
                           evicted=len(finished), tokens=self._tokens_generated - tokens0,
                           accepted=self._spec_accepted - accepted0,
                           prefill_tokens=self._prefill_tokens - ptok0)
        return finished

    def _observe_tick(self, tick_s: float, inserted: int, evicted: int, tokens: int,
                      accepted: int = 0, prefill_tokens: int = 0) -> None:
        m = self.metrics
        self._tick += 1
        free_min = min(a.n_free for a in self._allocators)
        m.histogram("serve/tick_s").observe(tick_s)
        m.gauge("serve/queue_depth").set(self.n_queued)
        m.gauge("serve/active_slots").set(self.n_active)
        m.gauge("serve/free_pages").set(free_min)
        m.counter("serve/inserts").inc(inserted)
        m.counter("serve/evictions").inc(evicted)
        m.counter("serve/tokens").inc(tokens)
        if prefill_tokens:
            m.histogram("serve/prefill_tokens_tick").observe(prefill_tokens)
        if self.scfg.spec_k > 0:
            m.counter("serve/accepted").inc(accepted)
        m.gauge("serve/decode_compiles").set(self.decode_counter.count)
        m.gauge("serve/prefill_compiles").set(self.prefill_counter.count)
        if self.sink.enabled:
            self.sink.emit("serve/tick", tick=self._tick, tick_s=round(tick_s, 6),
                           queue_depth=self.n_queued, active=self.n_active,
                           free_pages_min=free_min, inserted=inserted, evicted=evicted,
                           tokens=tokens, accepted=accepted, prefill_tokens=prefill_tokens,
                           decode_compiles=self.decode_counter.count,
                           prefill_compiles=self.prefill_counter.count)

    def _tick_inner(self) -> list[tuple[int, tuple[int, ...]]]:
        # finishes live on the engine until the tick returns: an admission
        # that raises through must not lose requests evicted earlier
        finished = self._finish_buf
        while self._queue:
            slot = self._find_slot(self._queue[0])
            if slot is None:
                break
            req = self._queue.popleft()
            if not self._admit(req, slot, finished):
                continue  # quarantined: the slot stays free
            st = self._slots[slot]
            if st is not None and not st.pending and st.generated and self._done(st):
                finished.append(self._evict(slot))
        prefilling = [s for s, st in enumerate(self._slots) if st is not None and st.pending]
        if prefilling:
            self._ctx_sweep(prefilling, finished)
        active = [s for s, st in enumerate(self._slots)
                  if st is not None and not st.pending and st.generated]
        if active:  # one wave: the untiered pool seats the whole bank
            if self._macro_T > 1:
                self._decode_rounds += self._macro_sweep(active, finished)
            else:
                (self._spec_sweep if self.scfg.spec_k > 0 else self._decode_sweep)(active,
                                                                                   finished)
                self._decode_rounds += 1
        self._finish_buf = []
        return finished

    def _decode_sweep(self, active: list[int], finished: list) -> None:
        """One decode step: one token for every active slot (the others
        masked idle), then one pull of the sampled tokens."""
        scfg, geom = self.scfg, self.geom
        n = scfg.n_slots
        x = np.zeros((n, self.cfg.d_model), np.float32)
        tables = np.full((n, scfg.max_pages), geom.n_pages, np.int32)
        write_page = np.full((n,), geom.n_pages, np.int32)
        write_off = np.zeros((n,), np.int32)
        seq_lens = np.zeros((n,), np.int32)
        rids = np.zeros((n,), np.int64)       # idle slots draw under (0, 0), discarded
        positions = np.zeros((n,), np.int64)
        for s in active:
            if self._tries is not None:  # the copy-on-write guard on the write target
                self._ensure_private(s, self._slots[s].n_cached // geom.page_size)
        for s in active:
            st = self._slots[s]
            x[s] = self._embed_np[st.last_token]
            tables[s, :len(st.pages)] = st.pages
            write_page[s] = st.pages[st.n_cached // geom.page_size]
            write_off[s] = st.n_cached % geom.page_size
            seq_lens[s] = st.n_cached + 1
            rids[s] = st.rid
            positions[s] = len(st.generated)
        try:
            with self.timeline.span("serve/decode"):
                out, self._kv = self._decode(self.params, self._kv, self._tensor(x),
                                             self._tensor(tables), self._tensor(write_page),
                                             self._tensor(write_off), self._tensor(seq_lens))
                # greedy consumes no key: the threefry chain runs only for a draw
                keys = (request_keys(self._seed_key, self._tensor(rids),
                                     self._tensor(positions))
                        if scfg.temperature > 0 else None)
                (toks,) = self._pull(self._sample(keys, out @ self.embed.T))
        except Exception:
            self._recover_cache()
            raise
        self._decode_s += self._last_span_s()
        self._decode_steps += 1
        self._dispatches += 1
        self._host_syncs += 1
        self._slot_steps += len(active)
        self._fresh_tokens += len(active)
        for s in active:
            st = self._slots[s]
            st.n_cached += 1
            st.last_token = int(toks[s])
            st.generated.append(st.last_token)
            self._tokens_generated += 1
            if self._done(st):
                finished.append(self._evict(s))

    def _macro_k_of(self, s: int) -> int:
        """Tokens a macro dispatch can advance slot ``s``'s frontier:
        ``min(T * (spec_k + 1), remaining budget)``."""
        st = self._slots[s]
        return min(self._macro_T * (self.scfg.spec_k + 1), st.max_new - len(st.generated))

    def _macro_sweep(self, active: list[int], finished: list) -> int:
        """One macro tick: up to T token rounds (speculation rounds under
        ``spec_k``) for every active slot in one dispatch and one host
        sync. The loop carries page tables,
        frontiers, lengths, sampling positions and budget/stop masks (and
        under speculation the token history) on the device. Under
        ``async_macro`` (plain path, nothing for the host to decide between
        dispatches: no prefix index, empty queue, no prefilling slot, no
        stop tokens) every remaining dispatch runs back to back on the
        previous one's device carry, and their tokens are pulled once.
        Returns the rounds the bank ran."""
        scfg, geom = self.scfg, self.geom
        n, T = scfg.n_slots, self._macro_T
        spec = self._spec_loop is not None
        tables = np.full((n, scfg.max_pages), geom.n_pages, np.int32)
        n_cached = np.zeros((n,), np.int32)
        rids = np.zeros((n,), np.int32)
        positions = np.zeros((n,), np.int32)
        budgets = np.zeros((n,), np.int32)
        last_tok = np.zeros((n,), np.int32)
        stop_mask = np.zeros((n, scfg.vocab), bool)
        stopped0 = np.zeros((n,), bool)
        emitted0 = np.zeros((n,), np.int32)
        hist = np.zeros((n, scfg.max_seq), np.int32) if spec else None
        for s in active:
            st = self._slots[s]
            if self._tries is not None:
                # the copy-on-write guard over the dispatch's whole write span
                for pi in range(st.n_cached // geom.page_size,
                                (st.n_cached + self._macro_k_of(s) - 1) // geom.page_size + 1):
                    self._ensure_private(s, pi)
        for s in active:
            st = self._slots[s]
            tables[s, :len(st.pages)] = st.pages
            n_cached[s] = st.n_cached
            rids[s] = st.rid
            positions[s] = len(st.generated)
            budgets[s] = st.max_new - len(st.generated)
            last_tok[s] = st.last_token
            for t in st.stop:
                stop_mask[s, t] = True
            if spec:
                ctx = st.prompt + tuple(st.generated)
                hist[s, :len(ctx)] = ctx
        n_scans = 1
        up = self._tensor
        try:
            with self.timeline.span("serve/decode"):
                if spec:
                    toks_d, emit_d, dlen_d, self._kv = self._spec_loop(
                        self.params, self._kv, self.embed, self._seed_key, up(tables),
                        up(n_cached), up(rids), up(positions), up(budgets), up(last_tok),
                        up(hist), up(stop_mask), up(stopped0))
                    toks, n_emit, dlen = self._pull(toks_d, emit_d, dlen_d)
                else:
                    chain = (scfg.async_macro and self._tries is None and not self._queue
                             and not any(st is not None and st.pending for st in self._slots)
                             and all(not self._slots[s].stop for s in active))
                    if chain:
                        n_scans = max(-(-int(budgets[s]) // T) for s in active)
                    nc, po, lt = up(n_cached), up(positions), up(last_tok)
                    em, sp_ = up(emitted0), up(stopped0)
                    tables_d, rids_d, budg_d, stop_d = up(tables), up(rids), up(budgets), \
                        up(stop_mask)
                    parts = []
                    for _ in range(n_scans):
                        (toks_d, mask_d, self._kv, nc, po, lt, em, sp_) = self._decode_loop(
                            self.params, self._kv, self.embed, self._seed_key, tables_d, nc,
                            rids_d, po, budg_d, lt, stop_d, sp_, em)
                        parts += [toks_d, mask_d]
                    # one pull, after every dispatch of the chain
                    host = self._pull(*parts)
                    toks = np.concatenate(host[0::2], axis=0)
                    mask = np.concatenate(host[1::2], axis=0).astype(bool)
        except Exception:
            self._recover_cache()
            raise
        self._decode_s += self._last_span_s()
        self._decode_steps += n_scans
        self._dispatches += n_scans
        # a chain's blocks come up in one copy, but count one pull a
        # dispatch, as the JAX engine's do
        self._host_syncs += n_scans
        if spec:
            accept_hist = self.metrics.histogram("serve/accept_len")
            rounds, _ = macro_occupancy(n_emit > 0)
            for s in active:
                st = self._slots[s]
                for r in range(n_emit.shape[0]):
                    ne = int(n_emit[r, s])
                    if ne == 0:
                        break  # active is monotone: later rounds are idle
                    out = [int(t) for t in toks[r, s, :ne]]
                    st.generated.extend(out)
                    st.last_token = out[-1]
                    st.n_cached += ne
                    accept_hist.observe(ne - 1)
                    self._spec_drafted += int(dlen[r, s])
                    self._spec_accepted += ne - 1
                    self._slot_steps += 1
                    self._fresh_tokens += ne
                    self._tokens_generated += ne
                if self._done(st):
                    finished.append(self._evict(s))
        else:
            rounds, occ = macro_occupancy(mask)
            for s in active:
                st = self._slots[s]
                steps = int(occ[s])
                out = [int(t) for t in toks[:steps, s]]
                st.n_cached += steps
                st.generated.extend(out)
                if out:
                    st.last_token = out[-1]
                self._slot_steps += steps
                self._fresh_tokens += steps
                self._tokens_generated += steps
                if self._done(st):
                    finished.append(self._evict(s))
        return rounds

    def _spec_sweep(self, active: list[int], finished: list) -> None:
        """One speculative sweep: every slot proposes up to ``spec_k``
        self-drafted tokens (``propose_draft`` on its prompt + generated
        history, clamped to its remaining budget less one), the one verify
        program scores the bank, and ``accept_speculative`` keeps the
        accepted prefix plus the terminal token. Rejected positions leave
        K/V past the accepted frontier that the length masks hide and the
        next sweep's writes cover."""
        scfg, geom = self.scfg, self.geom
        n, k = scfg.n_slots, scfg.spec_k
        K = k + 1
        x = np.zeros((n, K, self.cfg.d_model), np.float32)
        tables = np.full((n, scfg.max_pages), geom.n_pages, np.int32)
        write_pages = np.full((n, K), geom.n_pages, np.int32)
        write_offs = np.zeros((n, K), np.int32)
        seq_lens = np.zeros((n,), np.int32)
        drafts: dict[int, tuple[int, ...]] = {}
        for s in active:
            st = self._slots[s]
            remaining = st.max_new - len(st.generated)
            draft = propose_draft(st.prompt + tuple(st.generated), k,
                                  scfg.spec_ngram)[:remaining - 1]
            drafts[s] = draft
            if self._tries is not None:  # the copy-on-write guard on the write targets
                for pi in range(st.n_cached // geom.page_size,
                                (st.n_cached + len(draft)) // geom.page_size + 1):
                    self._ensure_private(s, pi)
        for s in active:
            st = self._slots[s]
            toks = (st.last_token,) + drafts[s]
            x[s, :len(toks)] = self._embed_np[list(toks)]
            tables[s, :len(st.pages)] = st.pages
            for j in range(len(toks)):
                pos = st.n_cached + j
                write_pages[s, j] = st.pages[pos // geom.page_size]
                write_offs[s, j] = pos % geom.page_size
            seq_lens[s] = st.n_cached + 1
        try:
            with self.timeline.span("serve/decode"):
                out, self._kv = self._decode(self.params, self._kv, self._tensor(x),
                                             self._tensor(tables), self._tensor(write_pages),
                                             self._tensor(write_offs), self._tensor(seq_lens))
                logits = out @ self.embed.T
                with _the_sync(self.device):
                    logits = logits.cpu().numpy()
        except Exception:
            self._recover_cache()
            raise
        self._decode_s += self._last_span_s()
        self._decode_steps += 1
        self._dispatches += 1
        self._host_syncs += 1
        self._slot_steps += len(active)
        accept_hist = self.metrics.histogram("serve/accept_len")
        for s in active:
            st = self._slots[s]
            a, toks = accept_speculative(scfg.seed, st.rid, len(st.generated), logits[s],
                                         drafts[s], scfg.temperature, scfg.top_k)
            if st.stop:
                # the device rule mirrored: truncate at the first stop hit (kept)
                for j, t in enumerate(toks):
                    if t in st.stop:
                        toks = toks[:j + 1]
                        break
            a_eff = len(toks) - 1
            accept_hist.observe(a_eff)
            self._spec_drafted += len(drafts[s])
            self._spec_accepted += a_eff
            self._fresh_tokens += a_eff + 1
            st.n_cached += a_eff + 1
            st.generated.extend(toks)
            st.last_token = toks[-1]
            self._tokens_generated += len(toks)
            if self._done(st):
                finished.append(self._evict(s))

    def run(self, requests: Sequence[Request] = (), max_steps: int = 100_000) -> GenerateReport:
        """Submit ``requests`` and drain queue + slots to empty. Counters in
        the report are this drain's deltas; the program counts are
        engine-lifetime."""
        base = dict(tokens=self._tokens_generated, decode=self._decode_steps,
                    prefill=self._prefill_count, prefill_s=self._prefill_s,
                    decode_s=self._decode_s, slot=self._slot_steps,
                    drafted=self._spec_drafted, accepted=self._spec_accepted,
                    ptok=self._prefill_tokens, stok=self._shared_tokens,
                    fresh=self._fresh_tokens, cow=self._cow_pages, sub=self._subpage_tokens,
                    disp=self._dispatches, hs=self._host_syncs)
        quarantined0 = set(self._quarantined)
        for r in requests:
            self.submit(r)
        outputs: dict[int, tuple[int, ...]] = {}
        steps = 0
        while self._queue or self.n_active:
            if steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps "
                                   f"({self.n_queued} queued, {self.n_active} active)")
            for rid, toks in self.step():
                outputs[rid] = toks
            steps += 1
        ttft = tuple((rid, self._ttft.pop(rid)) for rid in sorted(outputs) if rid in self._ttft)
        report = GenerateReport(
            completed=len(outputs),
            tokens_generated=self._tokens_generated - base["tokens"],
            decode_steps=self._decode_steps - base["decode"],
            prefills=self._prefill_count - base["prefill"],
            decode_compiles=self.decode_compiles,
            prefill_compiles=self.prefill_compiles,
            prefill_s=self._prefill_s - base["prefill_s"],
            decode_s=self._decode_s - base["decode_s"],
            outputs=tuple(sorted(outputs.items())),
            quarantined=tuple(sorted(set(self._quarantined) - quarantined0)),
            slot_steps=self._slot_steps - base["slot"],
            drafted=self._spec_drafted - base["drafted"],
            accepted=self._spec_accepted - base["accepted"],
            dispatches=self._dispatches - base["disp"],
            host_syncs=self._host_syncs - base["hs"],
            prefill_tokens=self._prefill_tokens - base["ptok"],
            shared_tokens=self._shared_tokens - base["stok"],
            cow_pages=self._cow_pages - base["cow"],
            fresh_kv_bytes=(self._fresh_tokens - base["fresh"]) * self.kv_bytes_per_token,
            subpage_tokens=self._subpage_tokens - base["sub"],
            ttft_s=ttft,
        )
        self.sink.emit("serve/report", completed=report.completed,
                       tokens_generated=report.tokens_generated,
                       decode_steps=report.decode_steps, prefills=report.prefills,
                       decode_compiles=report.decode_compiles,
                       prefill_compiles=report.prefill_compiles,
                       prefill_s=round(report.prefill_s, 6), decode_s=round(report.decode_s, 6),
                       quarantined=len(report.quarantined), slot_steps=report.slot_steps,
                       dispatches=report.dispatches, host_syncs=report.host_syncs,
                       drafted=report.drafted, accepted=report.accepted,
                       prefill_tokens=report.prefill_tokens, shared_tokens=report.shared_tokens,
                       cow_pages=report.cow_pages,
                       fresh_kv_bytes=round(report.fresh_kv_bytes, 3))
        emit_phase_totals(self.sink, self.recorder)
        self.sink.emit_metrics(self.metrics.snapshot(), scope=self.metrics.id)
        self.sink.flush()
        return report
