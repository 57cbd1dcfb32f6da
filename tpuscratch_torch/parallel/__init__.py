"""Parallel layers over the stacked mesh (``scores``: the shared attention
score math; ``expert``: the routed MoE feed-forward; ``ring``: the
rotate-and-combine pipeline; ``ring_attention`` and ``ulysses``: attention
over a sequence split across ranks)."""
