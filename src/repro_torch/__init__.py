"""BlazingAML on PyTorch + CUDA: the port of the JAX package ``repro``.

Module paths mirror ``repro`` (``repro_torch.core.compiler`` is the
counterpart of ``repro.core.compiler``, and so on).  The package imports
torch and numpy, never jax and nothing of ``repro``: the framework-free
modules it needs (specs, DSL, pattern library, tracer, graph host half,
synthetic data) are kept as copies.  Entry points run on the CUDA card by
default and on the CPU only when asked (``device="cpu"``); see
:mod:`repro_torch.device`.  The hand-written kernels live under
:mod:`repro_torch.kernels` with their CUDA sources in ``csrc/``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
