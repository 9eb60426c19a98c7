"""Distributed GNN training (port of `herald_tpu/gnn/`): the GCN over the
ranks of a process group, its aggregation through K1 and K3."""

from .gcn import GCN, GCNConfig, gcn_forward, init_gcn_params
from .graph import (Graph, HaloPlan, ShardedGraph, locality_reorder,
                    normalize_edges, partition_edges, plan_halo_exchange,
                    relabel_graph, shard_node_array, synthetic_sbm)

__all__ = [
    "GCN", "GCNConfig", "gcn_forward", "init_gcn_params", "Graph",
    "HaloPlan", "ShardedGraph", "locality_reorder", "normalize_edges",
    "partition_edges", "plan_halo_exchange", "relabel_graph",
    "shard_node_array", "synthetic_sbm",
]
