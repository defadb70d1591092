"""Robust kernels + chi-squared thresholds (counterpart of
multi_orbslam3_tpu/opt/robust.py). Float32 matmul precision is set once
for the whole package (``multi_orbslam3_tpu_torch/__init__.py``)."""

from __future__ import annotations

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
