"""Single-agent monocular SLAM runner (thin wrapper over the port's
run_slam; counterpart of apps/run_mono.py).

Kept for compatibility with existing scripts: ``--inertial`` maps to
``--sensor mono_inertial``. See apps/run_slam.py for the full
multi-sensor runner (the reference's per-sensor client nodes,
ros/src/ClientNode.cc + MonoInertialNode.cc).

Usage:
    python -m multi_orbslam3_tpu_torch.apps.run_mono --out /tmp/run1 \\
        [--inertial] [--frames 80] [--device cpu]
"""

from __future__ import annotations

import sys

from multi_orbslam3_tpu_torch.apps import run_slam


def main() -> None:
    argv = []
    sensor = "mono"
    for a in sys.argv[1:]:
        if a == "--inertial":
            sensor = "mono_inertial"
        else:
            argv.append(a)
    sys.argv = [sys.argv[0]] + argv + ["--sensor", sensor]
    run_slam.main()


if __name__ == "__main__":
    main()
