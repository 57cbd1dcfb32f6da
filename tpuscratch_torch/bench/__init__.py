"""Timing harnesses and the stencil headline."""
