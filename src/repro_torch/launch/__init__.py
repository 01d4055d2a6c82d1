"""Launchers of the port: the triage server (``serve``), the partitioned
and sharded mining launcher (``mine``) and the shard device list
(``mesh``)."""
