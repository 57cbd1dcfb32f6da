"""The models the port serves and trains (``transformer``: the MoE
transformer's configuration, parameters, forward and training steps)."""
