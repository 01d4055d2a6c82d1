from repro_torch.kernels.hist_update.ops import error_bound, hist_update
from repro_torch.kernels.hist_update.ref import hist_update_ref

__all__ = ["hist_update", "hist_update_ref", "error_bound"]
