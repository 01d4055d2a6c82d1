"""Launchers of the port: the triage server (``serve``), the partitioned
and sharded mining launcher (``mine``), the shard device list (``mesh``)
and the LM serving launcher (``decode_lm``)."""
