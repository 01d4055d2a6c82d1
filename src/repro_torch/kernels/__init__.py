"""Hand-written Hopper kernels of the port, one package per kernel:
``ref.py`` (the plain PyTorch version), ``ops.py`` (the dispatching
wrapper with its launch count) and a CUDA source under
``src/repro_torch/csrc/`` built by :mod:`repro_torch.kernels.build`.

Ported: ``intersect_count``, ``hist_update``, ``window_degree`` and
``flash_attention``, every Pallas kernel of the JAX package's
``kernels/*`` (the same names).  Added: ``window_search``, the mining
compiler's windowed searches and its whole bs1 / bs2 intersect steps,
which the JAX package runs as ``fori_loop`` searches inside its jitted
bucket programs."""
