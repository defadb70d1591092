"""Batched robust least squares: pose-only optimisation and windowed
Schur-complement bundle adjustment."""
