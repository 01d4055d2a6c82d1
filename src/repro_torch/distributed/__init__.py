"""Distributed-state helpers of the port (so far: checkpointing)."""
