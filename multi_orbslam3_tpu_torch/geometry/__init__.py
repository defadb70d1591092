"""Manifold geometry + camera models (plain torch, batched over leading axes)."""

from multi_orbslam3_tpu_torch.geometry import so3, se3, sim3, camera, triangulation  # noqa: F401
