"""Sequence generation for the port (numpy only)."""
