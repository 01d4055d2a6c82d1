from repro_torch.graph.csr import (
    DeviceGraph,
    TemporalGraph,
    build_temporal_graph,
    csr_row_offsets,
)
from repro_torch.graph.partition import PartitionPlan, partition_edges

__all__ = [
    "TemporalGraph",
    "DeviceGraph",
    "build_temporal_graph",
    "csr_row_offsets",
    "partition_edges",
    "PartitionPlan",
]
