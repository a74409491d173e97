"""Configurations (counterpart of ``repro.configs``): one module per model
architecture of the LM zoo, looked up by ``registry.get_config`` (and cut to
a tiny same-family model by ``registry.reduced_config``), and the paper's
own workload, ``tda_ego``."""
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.configs.tda_ego import TDAConfig, config

__all__ = ["ARCHS", "TDAConfig", "config", "get_config", "reduced_config"]
