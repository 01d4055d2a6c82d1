"""Launchers of the port: the triage server (``serve``)."""
