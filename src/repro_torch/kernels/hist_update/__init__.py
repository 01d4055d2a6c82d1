from repro_torch.kernels.hist_update.ops import error_bound, error_bound_rows, hist_update, hist_update_rows
from repro_torch.kernels.hist_update.ref import fixed_point_ref, hist_update_ref, hist_update_rows_ref

__all__ = [
    "hist_update",
    "hist_update_rows",
    "hist_update_ref",
    "hist_update_rows_ref",
    "fixed_point_ref",
    "error_bound",
    "error_bound_rows",
]
