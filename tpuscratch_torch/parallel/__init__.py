"""Parallel layers over the stacked mesh (``scores``: the shared attention
score math; ``expert``: the routed MoE feed-forward; ``ring``: the
rotate-and-combine pipeline; ``ring_attention`` and ``ulysses``: attention
over a sequence split across ranks; ``pipeline``: GPipe stages over a mesh
axis; ``ssm``: the sequence-parallel linear recurrence; ``plan``: the
ShardingPlan naming the dp / sp / pp (/ ep) axes)."""

from tpuscratch_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction,
    gpipe_scan,
    pipeline_apply,
)
from tpuscratch_torch.parallel.plan import ShardingPlan  # noqa: F401
from tpuscratch_torch.parallel.ssm import ssm_scan  # noqa: F401
