"""Model layers of the port (the parts of the JAX package's
``repro.models`` that FraudGT runs)."""
