from repro_torch.kernels.frontier.frontier import frontier_relax_cuda
from repro_torch.kernels.frontier.ops import (BlockedGraph, UpdateDelta,
                                              build_blocks,
                                              blocked_graph_from_numpy,
                                              frontier_relax,
                                              frontier_relax_torch,
                                              tile_activity)

__all__ = ["BlockedGraph", "UpdateDelta", "build_blocks",
           "blocked_graph_from_numpy", "frontier_relax",
           "frontier_relax_cuda", "frontier_relax_torch", "tile_activity"]
