"""Topology, the stacked mesh, and the runtime layer (context, errors,
memory, config, logging, host environment)."""

from tpuscratch_torch.runtime.config import Config  # noqa: F401
from tpuscratch_torch.runtime.log import RankLogger  # noqa: F401
