"""Topology and the stacked-tile mesh."""
