"""tests/test_collab_inertial.py's drill at the test's own size, on the port.

    python3 profiling/torch_collab_inertial_test_size.py [--runs N] [--device cuda]

The JAX test's drill (320x240, 256 features over 4 levels, 64 keyframes
and 2048 landmarks an agent, 70 frames, 600 points, seed 31; a
mono-inertial CollabClient, a mono one at phase 0.3, a CollabServer with
GBA on events) through the port's modules, N times in each of two modes:

- "as_is": every random draw on the run's device;
- "cpu_draws": the mono agent's two-view initializer draws its RANSAC
  hypotheses on the CPU (the monkeypatch of
  tests/test_torch_cuda.py::test_monoslam_on_the_card_tracks_like_the_cpu),
  while the VI agent keeps the device's draws.

Each run prints one JSON line: the test's gates (chip_smoke.collab_inertial_gates),
each agent's frames OK, the first frame it tracked OK and the maps it
created. Then one `summary` line a mode. A failed gate is reported, not
raised. Needs one NVIDIA GPU unless --device cpu.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

import torch  # noqa: E402


def drill_config():
    """tests/test_collab_inertial.py::_config, from the port's config."""
    from multi_orbslam3_tpu_torch import config as cm
    return cm.synthetic_mono(width=320, height=240).replace(
        orb=cm.ORBConfig(n_features=256, n_levels=4),
        map=cm.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                         max_obs_per_kf=256),
        local_mapping=cm.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                            local_ba_points=1024, local_ba_iters=8),
        loop=cm.LoopConfig(min_map_kfs=6, event_interval_kfs=2))


@contextlib.contextmanager
def hypotheses_on_the_cpu():
    """The two-view initializer's RANSAC samples drawn by a CPU generator
    with the device generator's seed, then moved to the device."""
    from multi_orbslam3_tpu_torch.pipeline import initializer
    sample = initializer.sample_hypotheses

    def sample_on_cpu(match_valid, n_hyp, k, generator):
        g = torch.Generator().manual_seed(generator.initial_seed())
        return sample(match_valid.cpu(), n_hyp, k, g).to(match_valid.device)

    initializer.sample_hypotheses = sample_on_cpu
    try:
        yield
    finally:
        initializer.sample_hypotheses = sample


def run_drill(device: str, mono_cpu_draws: bool, F: int = 70) -> dict:
    from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer
    from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    c = drill_config()
    kw = dict(n_frames=F, n_points=600, seed=31, trajectory="forward", lateral=0.8,
              sway_freq=0.15)
    seq_vi = synthetic.make_sequence(c, imu=True, **kw)
    seq_m = synthetic.make_sequence(c, phase=0.3, **kw)
    tr = InProcessTransport()
    cl_vi = CollabClient(c, 0, tr, inertial=True, device=device)
    cl_m = CollabClient(c, 1, tr, device=device)
    server = CollabServer(c, tr, n_agents=2, device=device)
    mono_draws = hypotheses_on_the_cpu if mono_cpu_draws else contextlib.nullcontext
    sent_before, states = 0, [[], []]
    for i in range(F):
        states[0].append(cl_vi.process_frame_imu(
            seq_vi.images[i], float(seq_vi.timestamps[i]), seq_vi.imu_acc[i],
            seq_vi.imu_gyro[i], cs.imu_dt(seq_vi, i, c.imu.rate_hz)))
        with mono_draws():
            states[1].append(cl_m.process_frame(seq_m.images[i], float(seq_m.timestamps[i])))
        if not cl_vi.slam.inertial_ready:
            sent_before = cl_vi.stats["deltas_sent"]
        cl_vi.comm_cycle()
        cl_m.comm_cycle()
        server.comm_cycle(run_gba_on_events=True)
    gates, problems = cs.collab_inertial_gates(server, [cl_vi, cl_m], [seq_vi, seq_m], F,
                                               sent_before)
    ok = [[s == TrackState.OK for s in st] for st in states]
    return {"device": device, "mono_cpu_draws": mono_cpu_draws,
            "frames_ok": [int(sum(o)) for o in ok],
            "first_ok": [o.index(True) if any(o) else None for o in ok],
            "maps_created": [cl.slam.stats.get("maps_created", 0) for cl in (cl_vi, cl_m)],
            "map_resets": [cl.slam.stats.get("map_resets", 0) for cl in (cl_vi, cl_m)],
            "merges": server.stats["merges"], "vi_solves": server.stats.get("vi_solves", 0),
            **gates, "passed": not problems, "problems": problems}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        cs.phase_device()
        cs.phase_build()
    for mode in ("as_is", "cpu_draws"):
        outs = []
        for r in range(args.runs):
            out = run_drill(args.device, mode == "cpu_draws")
            outs.append(out)
            print(json.dumps({"mode": mode, "run": r, **out}, default=float), flush=True)
        print(json.dumps({"summary": mode, "passed": sum(o["passed"] for o in outs),
                          "runs": len(outs),
                          "mono_frames_ok": [o["frames_ok"][1] for o in outs],
                          "vi_frames_ok": [o["frames_ok"][0] for o in outs],
                          "merges": [o["merges"] for o in outs]}), flush=True)


if __name__ == "__main__":
    main()
