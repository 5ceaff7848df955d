"""Simulation models of the port (N-body only in this slice)."""
