"""Timing harnesses: the stencil headline, the dot product, pingpong, decode, training, flash attention, the pair FFT, the 3D multigrid's smoothers and the BASELINE configs."""
