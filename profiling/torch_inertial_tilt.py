"""Where the gravity tilt of chip_smoke.py's collab_inertial phase comes from.

    python3 profiling/torch_inertial_tilt.py [--frames 90] [--small] [--dump DIR]

Runs, on one card and under chip_smoke.reproducible:
1. the phase's mono-inertial sequence through a standalone MonoInertialSlam
   (loop closing off, as the collaborative client runs it);
2. the collab_inertial phase itself, recording after every server cycle the
   VI client's live gravity tilt and the events of that cycle (correction
   batches and gauges applied on the client, merges, GBA adoptions and joint
   inertial solves on the server).
The tilt of a frame is the angle between the world's z axis seen from the
estimated camera and from the true one (yaw-free; tests/test_collab_inertial.py
gates its mean after the init frame + 2). --small runs both at the JAX
test's size (320x240, 256 features, 4 levels, 64 keyframes) instead of
synthetic_mono's full width. --dump DIR writes the standalone run's inputs
and outputs of each inertial_init call (body poses, flat preintegration
rows, keyframe timestamps, the true camera poses of those keyframes' frames)
to DIR/inertial_init_<n>.npz, so the initialisation can be replayed on the
CPU through both packages. Prints one JSON line per run. Needs one NVIDIA
GPU and nvcc.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def tilt_deg(T_e, T_g) -> float:
    z = np.array([0.0, 0.0, 1.0])
    a, b = T_e[:3, :3] @ z, T_g[:3, :3] @ z
    return float(np.degrees(np.arccos(np.clip(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
                                              -1.0, 1.0))))


def summary(tilts, init_f):
    t = np.asarray(tilts[init_f + 2:])
    return {"imu_init_frame": init_f, "tilt_mean": float(t.mean()),
            "tilt_head": float(t[:8].mean()), "tilt_tail": float(t[-8:].mean()),
            "tilt_by_10_frames": [round(float(t[i:i + 10].mean()), 3)
                                  for i in range(0, len(t), 10)]}


def config(small: bool):
    from multi_orbslam3_tpu_torch import config as cfgm
    if not small:
        return cs.collab_inertial_config()
    c = cfgm.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfgm.ORBConfig(n_features=256, n_levels=4),
        map=cfgm.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                           max_obs_per_kf=256),
        local_mapping=cfgm.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                              local_ba_points=1024, local_ba_iters=8),
        loop=cfgm.LoopConfig(min_map_kfs=6, event_interval_kfs=2))


def dump_inertial_init(slam, seq, out_dir):
    """Wrap opt.inertial_init.inertial_init to save each call's inputs and
    result (see the module doc)."""
    from multi_orbslam3_tpu_torch.imu import preintegration as pre
    from multi_orbslam3_tpu_torch.opt import inertial_init
    inner = inertial_init.inertial_init
    ts0 = float(seq.timestamps[0])

    def wrapped(R_wb, p_wb, preints, **kw):
        res = inner(R_wb, p_wb, preints, **kw)
        n = len(getattr(wrapped, "calls", []))
        _, own, ts = slam._own_slots()
        frames = [int(round((float(ts[k]) - 0.0) * slam.cfg.camera.fps)) for k in own]
        flat = np.stack([pre.preint_to_flat(pre.index_preintegrated(preints, i))
                         for i in range(R_wb.shape[0])])
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"inertial_init_{n}.npz"),
                 R_wb=R_wb.cpu().numpy(), p_wb=p_wb.cpu().numpy(), preint_flat=flat,
                 kf_ts=np.asarray([float(ts[k]) for k in own]), frames=np.asarray(frames),
                 T_cw_gt=seq.T_cw[np.clip(frames, 0, len(seq.T_cw) - 1)],
                 T_bc=slam.T_bc, G=kw.get("G"), fix_scale=kw.get("fix_scale"),
                 pose_sigma=np.asarray(kw.get("pose_sigma")), R_wg=res.R_wg.cpu().numpy(),
                 scale=float(res.scale), chi2=float(res.chi2), ts0=ts0)
        wrapped.calls = getattr(wrapped, "calls", []) + [n]
        return res
    inertial_init.inertial_init = wrapped
    return inner


@cs.reproducible()
def standalone(c, F, dump=None) -> dict:
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.opt import inertial_init
    from multi_orbslam3_tpu_torch.pipeline import MonoInertialSlam
    seq = synthetic.make_sequence(c, n_frames=F, n_points=1200, seed=31, trajectory="forward",
                                  imu=True, lateral=0.8, sway_freq=0.15)
    slam = MonoInertialSlam(c, 0, enable_loop_closing=False, device="cuda")
    inner = dump_inertial_init(slam, seq, dump) if dump else None
    refined_at = None
    for i in range(F):
        slam.process_frame_imu(seq.images[i], float(seq.timestamps[i]), seq.imu_acc[i],
                               seq.imu_gyro[i], cs.imu_dt(seq, i, c.imu.rate_hz))
        if refined_at is None and slam._refined:
            refined_at = i
    if inner is not None:
        inertial_init.inertial_init = inner
    tilts = [tilt_deg(T, seq.T_cw[i]) for i, (_, T) in enumerate(slam.trajectory)]
    return {"run": "standalone", "imu_init_scale": slam.stats.get("imu_init_scale"),
            "refined_at_frame": refined_at,
            **summary(tilts, slam.stats.get("imu_init_frame", F - 3))}


class Events:
    def __init__(self):
        self.rows, self.prev = [], None

    def __call__(self, i, server, clients, seqs):
        cl = clients[0]
        st = server.stats
        ev = (cl.stats["corrections_applied"], cl.stats.get("gauges_applied", 0),
              st["merges"], st["gba_runs"], st.get("vi_solves", 0))
        row = {"frame": i, "tilt": round(tilt_deg(cl.slam.T_cur, seqs[0].T_cw[i]), 3)}
        if self.prev is not None and ev != self.prev:
            row["events"] = dict(zip(("corrections", "gauges", "merges", "gba_runs",
                                      "vi_solves"), ev))
        self.prev = ev
        self.rows.append(row)


def collab(c, F) -> dict:
    ev = Events()
    try:
        with cs.reproducible():
            res, _ = cs.phase_collab_inertial(n_frames=F, config=c, on_cycle=ev)
        failed = None
    except AssertionError as e:
        failed, res = str(e), {}
    return {"run": "collab_inertial", "failed": failed,
            **{k: res.get(k) for k in ("imu_init_frame", "imu_init_scale", "tilt_mean_deg",
                                       "tilt_head_deg", "tilt_tail_deg", "vi_ate_rmse",
                                       "mono_ate_rmse", "span")},
            "events": [r for r in ev.rows if "events" in r],
            "tilt_by_frame": [r["tilt"] for r in ev.rows]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--dump", default=None, metavar="DIR")
    args = ap.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    c = config(args.small)
    size = "small" if args.small else "full"
    print(json.dumps({"size": size, **standalone(c, args.frames, args.dump)}), flush=True)
    print(json.dumps({"size": size, **collab(c, args.frames)}), flush=True)
    print(card["smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
