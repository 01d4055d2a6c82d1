from repro_torch.kernels.intersect_count.ops import intersect_count
from repro_torch.kernels.intersect_count.ref import intersect_count_ref

__all__ = ["intersect_count", "intersect_count_ref"]
