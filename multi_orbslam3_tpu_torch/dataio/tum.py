"""TUM-format trajectory IO (counterpart of multi_orbslam3_tpu/dataio/tum.py):
one line per keyframe, "t x y z qx qy qz qw", world-from-camera convention."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from multi_orbslam3_tpu_torch.geometry import so3


def write_tum(path: str, trajectory: Iterable[Tuple[float, np.ndarray]]) -> None:
    """trajectory: iterable of (timestamp, T_cw 4x4). Writes T_wc (inverted)."""
    lines = []
    for ts, T_cw in trajectory:
        T_cw = np.asarray(T_cw)
        R_wc = T_cw[:3, :3].T
        t_wc = -R_wc @ T_cw[:3, 3]
        q = so3.to_quaternion(torch.from_numpy(np.array(R_wc))).numpy()  # (w, x, y, z)
        lines.append(f"{ts:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, x, y, z, qx, qy, qz, qw = [float(v) for v in line.split()][:8]
            T_wc = np.eye(4)
            T_wc[:3, :3] = so3.from_quaternion(
                torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
            T_wc[:3, 3] = [x, y, z]
            out.append((ts, np.linalg.inv(T_wc).astype(np.float32)))
    return out
