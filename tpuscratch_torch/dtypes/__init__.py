"""Structured slice specs (the subarray spec of the halo path)."""

from tpuscratch_torch.dtypes.specs import SubarraySpec  # noqa: F401
