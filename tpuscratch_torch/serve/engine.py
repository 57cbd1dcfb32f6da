"""Continuous-batching generation engine over the sharded decode stack.

The twin of ``tpuscratch.serve.engine``'s default path: a fixed bank of
``n_slots`` decode slots runs one decode step per tick, and requests are
inserted into and evicted from slots between ticks. Admission is a
free-page watermark: a request enters only when its slot's dp group can
cover its whole page footprint (prompt + budgeted new tokens). The decode
step always sees all slots (idle ones masked by ``seq_len == 0`` and
sentinel page ids) and prompts pad to power-of-two buckets, so the engine
builds one decode program and one prefill program per bucket, the counts
the JAX engine reports as compiles. Scheduling is host-side Python
between device steps; each tick pulls the sampled tokens to the host once.

The levers the default path does not take raise ``NotImplementedError``
naming ROADMAP item A14: speculation (``spec_k``), macro and async decode
(``macro_steps``, ``async_macro``), prefix sharing and chunked prefill
(``prefix_share``, ``chunk_prefill``), the host KV tier
(``kv_host_pages``) and in-engine prefill retries (``retry_budget``). The
obs sinks, tracer, chaos and flight recorder (ROADMAP A10) are not taken.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpuscratch_torch.models.transformer import TransformerConfig, init_params
from tpuscratch_torch.runtime.mesh import StackedMesh, resolve_device
from tpuscratch_torch.serve.decode import (
    ProgramCounter,
    _axis_len,
    build_decode_step,
    build_prefill,
    check_serve_mesh,
)
from tpuscratch_torch.serve.kvcache import (
    CacheGeometry,
    PageAllocator,
    init_kv_cache,
    kv_cache_bytes,
)
from tpuscratch_torch.serve.sampling import key, request_key, request_keys, sample_batch

#: ServeConfig.kv_dtype spellings -> cache dtype (the fp32 / int8 / fp8 ladder)
_KV_DTYPES = {"float32": torch.float32, "int8": torch.int8, "fp8": torch.float8_e4m3fn}

#: ServeConfig.fused_attention spellings -> the ops.attention ``fused``
#: argument: "auto" routes by device (the kernel on the card, the plain
#: version on the CPU), "on" demands the kernel, "off" forces the plain one
_FUSED_MODES = {"auto": None, "on": True, "off": False}


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
    retry_budget: int = 0     # in-engine prefill retries (not ported: A14)
    kv_dtype: str = "float32"  # "float32", "int8" or "fp8" (e4m3)
    fused_attention: str = "auto"  # "auto", "on" or "off"
    spec_k: int = 0           # speculative draft tokens (not ported: A14)
    spec_ngram: int = 2
    prefix_share: bool = False  # (not ported: A14)
    chunk_prefill: int = 0    # (not ported: A14)
    macro_steps: int = 1      # (not ported: A14)
    async_macro: bool = False  # (not ported: A14)
    kv_host_pages: int = 0    # (not ported: A14)

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
    """What a drain produced: the JAX package's fields that its default
    path fills (the speculation, sharing, tier and TTFT fields come with
    their levers)."""

    completed: int
    tokens_generated: int
    decode_steps: int
    prefills: int
    decode_compiles: int
    prefill_compiles: int
    prefill_s: float
    decode_s: float
    outputs: tuple[tuple[int, tuple[int, ...]], ...]  # (rid, tokens) by rid
    slot_steps: int = 0       # active-slot decode invocations
    dispatches: int = 0       # decode steps run
    host_syncs: int = 0       # pulls of sampled tokens to the host
    prefill_tokens: int = 0   # prompt tokens computed by prefill
    fresh_kv_bytes: float = 0.0  # K/V bytes written this drain


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: tuple[int, ...]
    pages: list[int]          # LOCAL page ids in this slot's group
    n_cached: int             # tokens whose K/V are in the cache
    max_new: int
    last_token: int
    generated: list[int]
    stop: tuple[int, ...] = ()


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


#: the ServeConfig levers the port does not take yet, with their defaults
_NOT_PORTED = {"spec_k": 0, "macro_steps": 1, "async_macro": False, "prefix_share": False,
               "chunk_prefill": 0, "kv_host_pages": 0, "retry_budget": 0}


class ServeEngine:
    """Sharded continuous-batching engine: ``submit`` queues requests,
    ``step`` runs one admission + decode tick, ``run`` drains.

    Slot ``s`` belongs to dp group ``s // (n_slots / dp_size)``, and its
    pages come from that group's own :class:`PageAllocator`. Everything
    runs on ``mesh.device``; ``params`` and ``embed`` default to the
    seeded draws of ``scfg.seed``."""

    def __init__(self, mesh: StackedMesh, cfg: TransformerConfig, scfg: ServeConfig,
                 params: Optional[dict] = None, embed: Optional[torch.Tensor] = None,
                 dp: str = "dp", sp: str = "sp"):
        for name, default in _NOT_PORTED.items():
            if getattr(scfg, name) != default:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(scfg, name)!r} is not ported to "
                    "tpuscratch_torch yet (ROADMAP A14); the default path serves "
                    f"{name}={default!r}")
        check_serve_mesh(mesh, cfg, dp, sp)
        self._dp_size = _axis_len(mesh, dp)
        if scfg.n_slots % self._dp_size:
            raise ValueError(f"n_slots {scfg.n_slots} not divisible by dp size {self._dp_size}")
        if scfg.max_seq > scfg.n_pages * scfg.page_size:
            raise ValueError(f"max_seq {scfg.max_seq} exceeds one group's pool "
                             f"({scfg.n_pages} pages x {scfg.page_size})")
        if scfg.kv_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_dtype {scfg.kv_dtype!r} not in {sorted(_KV_DTYPES)}")
        if scfg.fused_attention not in _FUSED_MODES:
            raise ValueError(f"fused_attention {scfg.fused_attention!r} not in "
                             f"{sorted(_FUSED_MODES)}")
        self.mesh, self.cfg, self.scfg = mesh, cfg, scfg
        self.device = mesh.device
        self._quantized = scfg.kv_dtype != "float32"
        self.geom = CacheGeometry(cfg.n_layers, scfg.n_pages, scfg.page_size, cfg.n_heads,
                                  cfg.d_head)
        self.params = params if params is not None else init_params(scfg.seed, cfg, self.device)
        self.embed = (embed if embed is not None
                      else init_embed(scfg.seed, scfg.vocab, cfg.d_model, self.device))
        if tuple(self.embed.shape) != (scfg.vocab, cfg.d_model):
            raise ValueError(f"embed {tuple(self.embed.shape)} != ({scfg.vocab}, {cfg.d_model})")
        self._embed_np = self.embed.cpu().numpy()
        self._kv = init_kv_cache(self.geom, self._dp_size, _KV_DTYPES[scfg.kv_dtype], self.device)
        self._allocators = [PageAllocator(scfg.n_pages) for _ in range(self._dp_size)]
        self._slots: list[Optional[_Slot]] = [None] * scfg.n_slots
        self._slots_per_group = scfg.n_slots // self._dp_size
        self._queue: collections.deque[Request] = collections.deque()
        self._seen_rids: set[int] = set()
        self._seed_key = key(scfg.seed, self.device)
        self.decode_counter = ProgramCounter()
        self.prefill_counter = ProgramCounter()
        self._decode = build_decode_step(mesh, cfg, self.geom, dp=dp, sp=sp,
                                         counter=self.decode_counter,
                                         quantized=self._quantized,
                                         fused=_FUSED_MODES[scfg.fused_attention])
        self._prefills: dict[int, object] = {}  # bucket len -> program
        self._dp, self._sp = dp, sp
        self._decode_steps = 0
        self._prefill_count = 0
        self._tokens_generated = 0
        self._slot_steps = 0
        self._dispatches = 0
        self._host_syncs = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._prefill_tokens = 0
        self._fresh_tokens = 0

    # ---- introspection (tests + report) --------------------------------

    @property
    def decode_compiles(self) -> int:
        """Decode programs that have run (the JAX engine's compile count)."""
        return self.decode_counter.count

    @property
    def prefill_compiles(self) -> int:
        """Prefill programs (one per prompt bucket) that have run."""
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
    def dispatches(self) -> int:
        """Decode-side device steps run."""
        return self._dispatches

    @property
    def host_syncs(self) -> int:
        """Decode-side pulls of sampled tokens to the host."""
        return self._host_syncs

    @property
    def slot_steps(self) -> int:
        """Active-slot decode invocations."""
        return self._slot_steps

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def _group_of(self, slot: int) -> int:
        return slot // self._slots_per_group

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---- request lifecycle ---------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req``."""
        validate_request(req, self.scfg)
        if req.rid in self._seen_rids:
            raise ValueError(f"request id {req.rid} already used")
        self._seen_rids.add(req.rid)
        self._queue.append(req)

    def _find_slot(self, req: Request) -> Optional[int]:
        need = self.geom.pages_for(len(req.prompt) + req.max_new)
        for s, slot in enumerate(self._slots):
            if slot is None and self._allocators[self._group_of(s)].n_free >= need:
                return s
        return None

    def _sample(self, keys, logits) -> torch.Tensor:
        return sample_batch(keys, logits, self.scfg.temperature, self.scfg.top_k)

    def _admit(self, req: Request, slot: int) -> None:
        """Prefill ``req`` into ``slot`` at its prompt bucket and sample its
        first token from ``request_key(seed, rid, 0)``."""
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
        t0 = time.perf_counter()
        out, self._kv = self._prefills[bucket](self.params, self._kv, self._tensor(x),
                                               self._tensor(page_rows), n_tok)
        logits = out[n_tok - 1][None] @ self.embed.T
        k0 = request_key(scfg.seed, req.rid, 0, self.device)[None]
        tok = int(self._sample(k0, logits)[0])
        self._prefill_s += time.perf_counter() - t0
        self._prefill_count += 1
        self._tokens_generated += 1
        self._prefill_tokens += n_tok
        self._fresh_tokens += n_tok
        self._slots[slot] = _Slot(rid=req.rid, prompt=req.prompt, pages=pages, n_cached=n_tok,
                                  max_new=req.max_new, last_token=tok, generated=[tok],
                                  stop=req.stop_tokens)

    def _done(self, st: _Slot) -> bool:
        """Budget exhausted, or the last token is one of the request's stop
        tokens (emitted, then the slot finishes)."""
        return (len(st.generated) >= st.max_new
                or bool(st.stop and st.generated and st.generated[-1] in st.stop))

    def _evict(self, slot: int) -> tuple[int, tuple[int, ...]]:
        st = self._slots[slot]
        self._allocators[self._group_of(slot)].free(st.pages)
        self._slots[slot] = None
        return st.rid, tuple(st.generated)

    # ---- the tick ------------------------------------------------------

    def step(self) -> list[tuple[int, tuple[int, ...]]]:
        """One engine tick: admit what fits, decode one token for every
        active slot, evict what finished. Returns the finished ``(rid,
        tokens)`` pairs."""
        finished = []
        while self._queue:
            slot = self._find_slot(self._queue[0])
            if slot is None:
                break
            req = self._queue.popleft()
            self._admit(req, slot)
            if self._done(self._slots[slot]):
                finished.append(self._evict(slot))
        active = [s for s, st in enumerate(self._slots) if st is not None]
        if active:
            self._decode_tick(active, finished)
        return finished

    def _decode_tick(self, active: list[int], finished: list) -> None:
        """One decode tick: without a host tier the whole bank is one wave."""
        self._decode_sweep(active, finished)

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
            st = self._slots[s]
            x[s] = self._embed_np[st.last_token]
            tables[s, :len(st.pages)] = st.pages
            write_page[s] = st.pages[st.n_cached // geom.page_size]
            write_off[s] = st.n_cached % geom.page_size
            seq_lens[s] = st.n_cached + 1
            rids[s] = st.rid
            positions[s] = len(st.generated)
        t0 = time.perf_counter()
        out, self._kv = self._decode(self.params, self._kv, self._tensor(x),
                                     self._tensor(tables), self._tensor(write_page),
                                     self._tensor(write_off), self._tensor(seq_lens))
        # greedy consumes no key: the threefry chain (a few hundred small
        # integer ops) runs only when a draw needs it
        keys = (request_keys(self._seed_key, self._tensor(rids), self._tensor(positions))
                if scfg.temperature > 0 else None)
        toks = self._sample(keys, out @ self.embed.T).cpu().numpy()
        self._decode_s += time.perf_counter() - t0
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

    def run(self, requests: Sequence[Request] = (), max_steps: int = 100_000) -> GenerateReport:
        """Submit ``requests`` and drain queue + slots to empty. Counters in
        the report are this drain's deltas; the program counts are
        engine-lifetime."""
        tokens0 = self._tokens_generated
        decode0, prefill0 = self._decode_steps, self._prefill_count
        prefill_s0, decode_s0 = self._prefill_s, self._decode_s
        slot0, ptok0, fresh0 = self._slot_steps, self._prefill_tokens, self._fresh_tokens
        disp0, hs0 = self._dispatches, self._host_syncs
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
        return GenerateReport(
            completed=len(outputs),
            tokens_generated=self._tokens_generated - tokens0,
            decode_steps=self._decode_steps - decode0,
            prefills=self._prefill_count - prefill0,
            decode_compiles=self.decode_compiles,
            prefill_compiles=self.prefill_compiles,
            prefill_s=self._prefill_s - prefill_s0,
            decode_s=self._decode_s - decode_s0,
            outputs=tuple(sorted(outputs.items())),
            slot_steps=self._slot_steps - slot0,
            dispatches=self._dispatches - disp0,
            host_syncs=self._host_syncs - hs0,
            prefill_tokens=self._prefill_tokens - ptok0,
            fresh_kv_bytes=(self._fresh_tokens - fresh0) * self.kv_bytes_per_token,
        )
