"""Parallel layers over the stacked mesh (``scores``: the shared attention
score math; ``expert``: the routed MoE feed-forward; ``ring``: the
rotate-and-combine pipeline; ``ring_attention`` and ``ulysses``: attention
over a sequence split across ranks; ``pipeline``: GPipe stages over a mesh
axis; ``ssm``: the sequence-parallel linear recurrence; ``plan``: the
ShardingPlan naming the dp / sp / pp (/ ep) axes; ``fft``: the pencil
2D and 3D FFT, local transforms around an all_to_all transpose)."""

from tpuscratch_torch.parallel.fft import (  # noqa: F401
    complex_supported,
    fft2_sharded,
    fft2_sharded_pair,
    fft3_sharded,
    fft3_sharded_pair,
    ifft2_from_pencil,
    ifft2_from_pencil_pair,
    ifft2_sharded,
    ifft3_from_pencil,
    ifft3_from_pencil_pair,
    ifft3_restore_pair,
    resolve_method,
)
from tpuscratch_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction,
    gpipe_scan,
    pipeline_apply,
)
from tpuscratch_torch.parallel.plan import ShardingPlan  # noqa: F401
from tpuscratch_torch.parallel.ssm import ssm_scan  # noqa: F401
