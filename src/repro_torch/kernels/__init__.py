"""Hand-written Hopper kernels of the port, one package per kernel:
``ref.py`` (the plain PyTorch version), ``ops.py`` (the dispatching
wrapper with its launch count) and a CUDA source under
``src/repro_torch/csrc/`` built by :mod:`repro_torch.kernels.build`.

Ported so far: ``intersect_count`` (the JAX package's
``kernels/intersect_count`` Pallas kernel).  ``window_degree``,
``hist_update`` and ``flash_attention`` are still to be ported
(ROADMAP.md, items B2-B4)."""
