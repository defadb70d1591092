"""Trajectory evaluation for the port (numpy only)."""
