"""Timing harnesses: the stencil headline, the dot product, pingpong, decode, training, flash attention and the BASELINE configs."""
