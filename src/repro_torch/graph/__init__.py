from repro_torch.graph.csr import (
    DeviceGraph,
    TemporalGraph,
    build_temporal_graph,
    csr_row_offsets,
)

__all__ = ["TemporalGraph", "DeviceGraph", "build_temporal_graph", "csr_row_offsets"]
