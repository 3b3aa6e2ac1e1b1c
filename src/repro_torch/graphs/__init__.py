from repro_torch.graphs.csr import Graph
from repro_torch.graphs.generators import (
    make_road_network,
    make_tree,
    make_synthetic,
    make_power_law,
    make_dataset,
    DATASET_SPECS,
)
from repro_torch.graphs import reference

__all__ = [
    "Graph",
    "make_road_network",
    "make_tree",
    "make_synthetic",
    "make_power_law",
    "make_dataset",
    "DATASET_SPECS",
    "reference",
]
