"""Timing harnesses: the stencil headline, the dot product, pingpong and the BASELINE configs."""
