"""Simulation models of the port: N-body and boids."""
