"""ORB front end: pyramid, FAST (kernel K1), orientation, BRIEF-256 and
Hamming matching (kernel K2)."""

from multi_orbslam3_tpu_torch.frontend.extractor import extract_features, FrameFeatures  # noqa: F401
from multi_orbslam3_tpu_torch.frontend import matcher  # noqa: F401
