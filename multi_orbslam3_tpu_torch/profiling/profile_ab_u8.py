"""A/B of the frame upload: uint8 against float32 (counterpart of the JAX
package's profiling/profile_ab_u8.py).

    python -m multi_orbslam3_tpu_torch.profiling.profile_ab_u8 [--device cpu]

bench_mono's sequence (752x480, 120 frames, 1,500 points, seed 5,
forward) through MonoSlam.process_frame with loop closing on, twice: with
the port's default MonoSlam.to_device, which rounds a frame to uint8 and
uploads 1 byte a pixel, and with a to_device that uploads float32, as the
JAX script's override does. Each arm is a warm-up pass and a timed pass on
a fresh system; fps and stats of the timed pass, so whether the uint8
quantisation costs tracking robustness shows in frames_lost. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.profiling import common


def float32_upload(device: torch.device):
    """A MonoSlam.to_device that uploads a frame as float32."""
    def to_device(img):
        if isinstance(img, torch.Tensor):
            return img.to(device)
        return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
    return to_device


def run_arm(u8: bool, config=None, n_frames: int = 120, warmup: bool = True,
            device=None) -> dict:
    """One arm: {"u8", "fps", "wall_s", "stats"} of the timed pass."""
    device = devices.resolve(device, "profile_ab_u8")
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import benchmarks as B
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
    c = config if config is not None else B._euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1500, seed=5,
                                  trajectory="forward")
    for _ in range(2 if warmup else 1):
        slam = MonoSlam(c, enable_loop_closing=True, device=device)
        if not u8:
            slam.to_device = float32_upload(device)
        common.sync(device)
        t0 = time.perf_counter()
        for i in range(n_frames):
            slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        common.sync(device)
        wall = time.perf_counter() - t0
    return {"u8": u8, "fps": n_frames / wall, "wall_s": wall, "warmup": warmup,
            "stats": dict(slam.stats)}


def run(config=None, n_frames: int = 120, warmup: bool = True, device=None,
        u8_arm: Optional[dict] = None) -> dict:
    """Both arms, uint8 first. u8_arm, where given, is a uint8 timed pass
    of the same run made elsewhere (profile_mono's timed pass is one), and
    is taken in place of running that arm again."""
    device = devices.resolve(device, "profile_ab_u8")
    arms = [u8_arm if u8_arm is not None else
            run_arm(True, config, n_frames, warmup, device),
            run_arm(False, config, n_frames, warmup, device)]
    return {"profile": "ab_u8", "device": common.card_name(device), "arms": arms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    out = run(device=ap.parse_args(argv).device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
