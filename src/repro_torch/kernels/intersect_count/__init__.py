from repro_torch.kernels.intersect_count.ops import intersect_count, pair_step
from repro_torch.kernels.intersect_count.ref import intersect_count_ref, pair_step_ref

__all__ = ["intersect_count", "intersect_count_ref", "pair_step", "pair_step_ref"]
