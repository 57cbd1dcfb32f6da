"""Parallel layers over the stacked mesh (``scores``: the shared attention
score math; ``expert``: the routed MoE feed-forward, forward only)."""
