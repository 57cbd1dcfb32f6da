"""A selective state-space (SSM) block: the second model family.

The twin of ``tpuscratch.models.ssm``: a minimal Mamba-shaped layer over the
sequence-parallel recurrence (``parallel.ssm``). Input-dependent decay
``a_t = sigmoid(x_t W_a + c)``, drive ``b_t = x_t W_b``, the hidden scan
``h_t = a_t h_{t-1} + b_t`` carried across sequence shards by ``ssm_scan``,
and a readout with residual. Plain torch ops, so autograd flows through the
distributed scan unchanged.

``init_params`` draws from numpy with the transformer's recipe (a float32
standard normal times a float64 scale, rounded to float32 once). The JAX
package draws this block's weights with ``jax.random``, which the port does
not reproduce: cross its parameters with
``models.transformer.params_from_numpy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuscratch_torch.models.transformer import params_from_numpy
from tpuscratch_torch.parallel.ssm import local_scan, ssm_scan

__all__ = ["SSMConfig", "init_params", "ssm_block"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int = 16
    d_state: int = 32


def init_params(seed: int, cfg: SSMConfig, device=None) -> dict:
    """The block's parameters on ``device`` (the card unless the caller asks
    for the CPU), drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)

    def dense(*shape, scale):
        return np.asarray(rng.standard_normal(shape).astype(np.float32) * scale, np.float32)

    s_in = cfg.d_model ** -0.5
    return params_from_numpy({
        "w_a": dense(cfg.d_model, cfg.d_state, scale=s_in),
        # start decays near 1 (long memory): sigmoid(2) ~ 0.88
        "c_a": np.full((cfg.d_state,), 2.0, np.float32),
        "w_b": dense(cfg.d_model, cfg.d_state, scale=s_in),
        "w_out": dense(cfg.d_state, cfg.d_model, scale=cfg.d_state ** -0.5),
    }, device)


def ssm_block(params: dict, x: torch.Tensor, seq_axis: str | None) -> torch.Tensor:
    """The block on a ``(*lead, T_local, d_model)`` sequence shard, params
    carrying the same leading dims (inside ``run_spmd`` both are stacked).

    ``seq_axis`` names the mesh axis the sequence is split over; None runs
    the local scan (the single-device oracle path)."""
    a = torch.sigmoid(x @ params["w_a"] + params["c_a"].unsqueeze(-2))
    b = x @ params["w_b"]
    if seq_axis is None:
        (_, h), _ = local_scan(a, b, dim=-2)  # inclusive scan from h_{-1} = 0
    else:
        h = ssm_scan(a, b, seq_axis)
    return x + h @ params["w_out"]
