from repro_torch.kernels.window_degree.ops import PAD_T, window_degree
from repro_torch.kernels.window_degree.ref import window_degree_ref

__all__ = ["window_degree", "window_degree_ref", "PAD_T"]
