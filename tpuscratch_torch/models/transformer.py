"""The MoE transformer's configuration and parameters (serving subset).

The twin of ``tpuscratch.models.transformer``'s parts the serving path
reads: ``TransformerConfig``, ``init_params`` (the same numpy draws, so a
seed gives the same arrays as the JAX package), ``param_spec`` (expert
leaves split over "dp" on their expert axis, the rest replicated),
``_rms_norm``, and ``params_from_numpy``, which carries a parameter tree
made elsewhere (the JAX package's, as numpy arrays) onto a device. The
forward pass, the training steps and the pipeline wait for the training
slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuscratch_torch.comm.spmd import P
from tpuscratch_torch.runtime.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 32
    n_heads: int = 2
    n_experts: int = 4          # total; must divide by the dp axis size
    d_ff: int = 64
    n_layers: int = 1
    causal: bool = True
    capacity_factor: float = 2.0
    aux_coef: float = 0.01
    attn_impl: str = "xla"      # the training forward's attention (not ported yet)
    compute_dtype: str = "float32"

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads


EXPERT_LEAVES = ("w_in", "w_out")  # the leaves split over "dp"
#: every per-layer parameter name
LAYER_LEAVES = ("wq", "wk", "wv", "wo", "ln1", "ln2", "gate", "w_in", "w_out")


def params_from_numpy(tree, device=None):
    """A parameter tree (nested dicts and lists of arrays, e.g. the JAX
    package's ``init_params`` through ``np.asarray``) as torch tensors on
    ``device`` (the card unless the caller asks for the CPU), bit for bit."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)


def _init_numpy(seed: int, cfg: TransformerConfig) -> dict:
    # the JAX package's draws, in its order and arithmetic: a float32 draw
    # times a numpy float64 scale is float64, rounded to float32 once
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return np.asarray(rng.standard_normal(shape).astype(np.float32) * scale, np.float32)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense(d, d),
            "wk": dense(d, d),
            "wv": dense(d, d),
            "wo": dense(d, d),
            "ln1": np.ones((d,), np.float32),
            "ln2": np.ones((d,), np.float32),
            "gate": dense(d, e, scale=0.02),
            "w_in": dense(e, d, f, scale=1.0 / np.sqrt(d)),
            "w_out": dense(e, f, d, scale=1.0 / np.sqrt(f)),
        })
    return {"layers": layers}


def init_params(seed: int, cfg: TransformerConfig, device=None) -> dict:
    """Parameter tree for ``cfg`` on ``device``; expert leaves have a
    leading ``(n_experts,)`` axis, the dim split over "dp"."""
    return params_from_numpy(_init_numpy(seed, cfg), device)


def param_spec(cfg: TransformerConfig, dp: str = "dp") -> dict:
    """PartitionSpec tree: expert leaves split over ``dp`` on their expert
    axis, everything else replicated."""
    layer = {name: P(dp) if name in EXPERT_LEAVES else P() for name in LAYER_LEAVES}
    return {"layers": [dict(layer) for _ in range(cfg.n_layers)]}


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale
