"""The paper's own workload as a config (counterpart of
``repro.configs.tda_ego``): batched ego-net persistence (CoralTDA + PrunIT
+ bit-packed GF(2) PH), §6.2 of the paper, sharded over a serve mesh with
``graphs_per_device`` ego nets a shard.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class TDAConfig:
    name: str = "tda_ego"
    n_pad: int = 64          # padded vertices per ego-net
    graphs_per_device: int = 64
    max_dim: int = 1
    edge_cap: int = 512
    tri_cap: int = 1024
    sublevel: bool = False   # degree + superlevel (paper Fig 5 setting)


def config() -> TDAConfig:
    return TDAConfig()
