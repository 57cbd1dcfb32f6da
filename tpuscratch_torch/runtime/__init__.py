"""Topology, the stacked mesh, and the runtime layer (context, errors, memory)."""
