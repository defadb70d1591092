"""Tracking, two-view initialization, local mapping, loop closing and the
host state machines of the six sensor modes:

- monocular           ``MonoSlam``            (system.py)
- stereo              ``StereoSlam``          (stereo_system.py)
- RGB-D               ``RGBDSlam``            (stereo_system.py)
- mono-inertial       ``MonoInertialSlam``    (inertial_system.py)
- stereo-inertial     ``StereoInertialSlam``  (stereo_inertial_system.py)
- RGB-D-inertial      ``RGBDInertialSlam``    (stereo_inertial_system.py)
"""

from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam
from multi_orbslam3_tpu_torch.pipeline.stereo_inertial_system import (
    RGBDInertialSlam, StereoInertialSlam)
from multi_orbslam3_tpu_torch.pipeline.stereo_system import RGBDSlam, StereoSlam
from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam, TrackState

__all__ = ["MonoSlam", "StereoSlam", "RGBDSlam", "MonoInertialSlam",
           "StereoInertialSlam", "RGBDInertialSlam", "TrackState"]
