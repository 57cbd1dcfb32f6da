"""The models the port serves (``transformer``: the MoE transformer's
configuration, parameters and the shared norm)."""
