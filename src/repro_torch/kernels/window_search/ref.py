"""Plain PyTorch version of the window_search kernel: the eager searches
of :mod:`repro_torch.core.ops`, where they stay (``tests/test_torch_ops.py``
holds them to the JAX package's ``repro.core.ops``).

The CPU tests run them, the wrapper takes them for tensors on the CPU, the
compiled and fused plans' ``"torch"`` backend calls them, and
``chip_smoke.py`` holds the CUDA kernel to them bit for bit on the card."""
from __future__ import annotations

from repro_torch.core.ops import count_id_in_window as count_id_in_window_ref
from repro_torch.core.ops import count_id_in_window_pos as count_id_in_window_pos_ref
from repro_torch.core.ops import count_window as count_window_ref
from repro_torch.core.ops import count_window_pos as count_window_pos_ref

__all__ = ["count_window_ref", "count_window_pos_ref", "count_id_in_window_ref", "count_id_in_window_pos_ref"]
