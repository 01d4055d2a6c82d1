"""The JAX package's five example scripts (``examples/*.py``) as entry
points of the port, one module each, named after the script:

* :mod:`~repro_torch.examples.quickstart` — a pattern portfolio mined in
  one session, a DSL pattern held to the oracle, the detection pipeline;
* :mod:`~repro_torch.examples.streaming_detection` — the detection
  service over a feed in time order, its counters and alerts a tick;
* :mod:`~repro_torch.examples.train_aml_pipeline` — the detection
  pipeline over five feature sets, and FraudGT trained and scored;
* :mod:`~repro_torch.examples.serve_lm` — greedy serving of two smoke
  LMs (an attention arch and an xLSTM) through the decode path;
* :mod:`~repro_torch.examples.trace_capture` — Chrome traces of a
  sharded 8-part mine and of six streaming ticks, and the metrics.

Each runs as ``PYTHONPATH=src python -m repro_torch.examples.<name>``
with the script's flags, on the CUDA card unless ``--device cpu`` is
given (without a card and without it, it raises).  Each module has
``main(argv=None) -> dict``, which draws the inputs, prints the script's
lines in its order and format, and returns the numbers it printed, and a
function that takes the inputs (the dataset, the model's parameters, the
FraudGT instance), so that other weights or data can be fed in.
"""
