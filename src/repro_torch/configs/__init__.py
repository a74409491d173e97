"""Configurations (counterpart of ``repro.configs``): so far the paper's own
workload, ``tda_ego``.  The LM configs and their registry come with the LM
stack."""
from repro_torch.configs.tda_ego import TDAConfig, config

__all__ = ["TDAConfig", "config"]
