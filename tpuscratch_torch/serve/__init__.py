"""Sharded autoregressive inference (the default path of ``tpuscratch.serve``).

A block-paged KV cache split over the (dp, sp) mesh (``kvcache``), cached
decode / verify / prefill steps whose attention runs the paged-attention
kernel on the card (``decode``), per-request threefry sampling that draws
the JAX package's tokens (``sampling``), and the continuous-batching
engine with free-page-watermark admission (``engine``).
"""

from tpuscratch_torch.serve.decode import (  # noqa: F401
    ProgramCounter,
    build_context_prefill,
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
    dequantize_pages,
    init_kv_cache,
    quantize_pages,
)
from tpuscratch_torch.serve.sampling import (  # noqa: F401
    request_key,
    request_keys,
    sample_batch,
    sample_logits,
)
