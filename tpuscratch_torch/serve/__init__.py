"""Sharded autoregressive inference (the default path of ``tpuscratch.serve``).

A block-paged KV cache split over the (dp, sp) mesh with page refcounts and
a prefix trie (``kvcache``), cached decode / verify / prefill steps whose
attention runs the paged-attention kernel on the card and device-resident
macro-step loops of T ticks (``decode``), per-request threefry sampling
and the speculative accept rule, drawing the JAX package's tokens
(``sampling``), and the continuous-batching engine with
free-page-watermark admission, speculation, macro decode, prefix sharing,
chunked prefill and in-engine retries (``engine``).
"""

from tpuscratch_torch.serve.decode import (  # noqa: F401
    ProgramCounter,
    build_context_prefill,
    build_decode_loop,
    build_decode_step,
    build_prefill,
    build_verify_step,
    propose_draft,
)
from tpuscratch_torch.serve.engine import (  # noqa: F401
    GenerateReport,
    Request,
    ServeConfig,
    ServeEngine,
    init_embed,
    validate_request,
)
from tpuscratch_torch.serve.kvcache import (  # noqa: F401
    CacheGeometry,
    PageAllocator,
    PrefixCache,
    dequantize_pages,
    init_kv_cache,
    quantize_pages,
)
from tpuscratch_torch.serve.sampling import (  # noqa: F401
    accept_speculative,
    request_key,
    request_keys,
    sample_batch,
    sample_logits,
    target_probs,
)
