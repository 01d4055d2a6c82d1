from repro_torch.kernels.window_search.ops import (
    count_id_in_window,
    count_id_in_window_pos,
    count_window,
    count_window_pos,
    describe,
    intersect_step,
)
from repro_torch.kernels.window_search.ref import (
    count_id_in_window_pos_ref,
    count_id_in_window_ref,
    count_window_pos_ref,
    count_window_ref,
    intersect_step_ref,
)

__all__ = [
    "count_window",
    "count_window_pos",
    "count_id_in_window",
    "count_id_in_window_pos",
    "intersect_step",
    "describe",
    "count_window_ref",
    "count_window_pos_ref",
    "count_id_in_window_ref",
    "count_id_in_window_pos_ref",
    "intersect_step_ref",
]
