"""Offline tools of the port: the recorder CLI."""
