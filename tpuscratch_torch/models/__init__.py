"""The models the port serves and trains (``transformer``: the MoE
transformer's configuration, parameters, forward and training steps;
``zero``: its ZeRO and plan-composed steps; ``ssm``: the selective
state-space block)."""

from tpuscratch_torch.models.ssm import SSMConfig, ssm_block  # noqa: F401
from tpuscratch_torch.models.ssm import init_params as init_ssm_params  # noqa: F401
