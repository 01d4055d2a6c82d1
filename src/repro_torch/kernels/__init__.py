"""Hand-written Hopper kernels of the port, one package per kernel:
``ref.py`` (the plain PyTorch version), ``ops.py`` (the dispatching
wrapper with its launch count) and a CUDA source under
``src/repro_torch/csrc/`` built by :mod:`repro_torch.kernels.build`.

Ported so far: ``intersect_count``, ``hist_update`` and ``window_degree``
(the JAX package's ``kernels/*`` Pallas kernels of the same names).
``flash_attention`` is still to be ported (ROADMAP.md, item B4)."""
