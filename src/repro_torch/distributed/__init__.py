"""Distributed-state helpers of the port: checkpointing, liveness and
stragglers (``fault_tolerance``), the AdamW optimizer that FraudGT's fit
runs (``optimizer``) and the LM's opt-in flags (``opts``)."""
