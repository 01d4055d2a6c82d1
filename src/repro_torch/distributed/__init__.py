"""Distributed-state helpers of the port: checkpointing, liveness and
stragglers (``fault_tolerance``), and the AdamW optimizer that FraudGT's
fit runs (``optimizer``)."""
