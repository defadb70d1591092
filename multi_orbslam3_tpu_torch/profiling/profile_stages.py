"""One call of each pipeline stage on a mature map (counterpart of the
JAX package's profiling/profile_stages.py).

    python -m multi_orbslam3_tpu_torch.profiling.profile_stages [--device cpu]

Builds the map by running MonoSlam (loop closing on) over the bench_mono
sequence's first 60 frames (752x480, 1,500 points, seed 5, forward) and
adopting the pending mapping result, then times each stage on it: the
launch round trip of a tiny op, the upload of one frame, the fused
extract + track, extraction alone, tracking alone, the landmark statistics
update, the mapping chain's triangulation and fusion, the local BA (16 + 8
keyframes, 4,096 points, 10 iterations), the covisibility row, the BoW
query and insert, and the reference-keyframe fallback. Each row has wall
ms a call (synchronised), CUDA-event ms a call, and the device launches and
device busy ms of one traced call (None on the CPU). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.profiling import common

# calls timed for each row, as the JAX script times them
REPS = {"tiny_roundtrip": 50, "process_new_keyframe": 5, "local_bundle_adjustment": 5}
DEFAULT_REPS = 20


def run(config=None, n_frames: int = 60, n_points: int = 1500, seed: int = 5,
        reps: Optional[int] = None, device=None) -> dict:
    """The stage table; config None is the bench camera
    (eval/benchmarks.py::_euroc_scale_config). reps overrides every row's
    number of timed calls."""
    device = devices.resolve(device, "profile_stages")
    from multi_orbslam3_tpu_torch.bow import database as dbm
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import benchmarks as B
    from multi_orbslam3_tpu_torch.frontend import extractor
    from multi_orbslam3_tpu_torch.map import mapstate as ms
    from multi_orbslam3_tpu_torch.pipeline import local_mapping, tracking
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam

    c = config if config is not None else B._euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=n_points,
                                  seed=seed, trajectory="forward")
    slam = MonoSlam(c, enable_loop_closing=True, device=device)
    for i in range(n_frames):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    slam._adopt_pending(force=True)
    m, K, o = slam.m, slam.K, c.orb
    k = int(m.n_kf) - 1
    kt = torch.tensor(k, device=device)
    img = slam.to_device(seq.images[0])
    T_pred = torch.from_numpy(slam.T_cur).to(device)
    feats = extractor.extract_features(img, c)
    lc = slam.loop_closer
    desc, fv = m.kf_desc[k], m.kf_feat_valid[k]
    excl = torch.zeros(m.max_kf, dtype=torch.bool, device=device)
    x = torch.zeros((8, 128), device=device)

    def tiny():
        x + 1
        common.sync(device)

    stages = {
        "tiny_roundtrip": tiny,
        "upload_frame": lambda: slam.to_device(seq.images[0]),
        "extract_and_track": lambda: tracking.extract_and_track(m, img, T_pred, c),
        "extract_features": lambda: extractor.extract_features(img, c),
        "track_frame": lambda: tracking.track_frame(
            m, feats, T_pred, K, width=c.camera.width, height=c.camera.height,
            scale_factor=o.scale_factor, n_levels=o.n_levels),
        "update_found_visible": lambda: ms.update_found_visible(m, m.kf_mp[0], m.mp_valid),
        "process_new_keyframe": lambda: local_mapping.process_new_keyframe(
            m, kt, K, n_neighbors=c.local_mapping.triangulation_neighbors,
            width=c.camera.width, height=c.camera.height,
            scale_factor=o.scale_factor, n_levels=o.n_levels),
        "local_bundle_adjustment": lambda: local_mapping.local_bundle_adjustment(
            m, kt, K, n_window=16, n_fixed=8, n_points=4096,
            scale_factor=o.scale_factor, iters=10),
        "covisibility_row": lambda: ms.covisibility_row(m, kt),
        "bow_query": lambda: dbm.query(lc.db, lc.voc, desc, fv, excl),
        "bow_add": lambda: dbm.add_keyframe_bow(lc.db, lc.voc, kt, desc, fv),
        "track_reference_kf": lambda: tracking.track_reference_kf(
            m, slam.ref_kf, feats, T_pred, K, scale_factor=o.scale_factor),
    }
    rows = {}
    for name, fn in stages.items():
        n = reps if reps is not None else REPS.get(name, DEFAULT_REPS)
        rows[name] = {**common.timeit(fn, n, device), "calls": n,
                      **common.device_profile(fn, device)}
    return {"profile": "stages", "device": common.card_name(device),
            "map_kfs": int(m.n_kf), "map_mps": int(m.n_mp), "stages": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    out = run(device=ap.parse_args(argv).device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
