"""A/B of one of the PyTorch port's bench paths between checkouts, on one
GPU within one process tree, so that both sides see the same card and host:

    python3 profiling/torch_ab_slice.py [--mode MODE] PARENT_DIR . . PARENT_DIR

Each positional argument is the root of a checkout that holds
``chip_smoke.py`` and the port. For each, in the order given, a fresh
interpreter started in that directory imports its ``chip_smoke``, renders
the mode's bench sequence and runs the mode's phase with that checkout's
own gates:

- ``mono`` (the default): ``phase_slice(cfg, seq, loop_closing=True)``, a
  warm-up pass and then the timed pass of bench_mono;
- ``stereo``: ``phase_stereo`` (bench_stereo, one timed pass);
- ``mono_inertial``: ``phase_mono_inertial`` (bench_mono_inertial, one
  timed pass);
- ``collab``: ``phase_collab`` (bench_collab's two agents and the server)
  twice under ``reproducible`` with the server's ``deterministic`` flag;
  the second run's numbers (server cycle percentiles, the global BA's
  Gauss-Newton step, fps, each agent's ATE) are printed.

Prints one JSON line a run (fps, frame-time percentiles, frames OK, ATE,
peak memory, kernel launches, and the mode's own stage times) and a last
line with the card's nvidia-smi name and power limit. Host-bound numbers
swing between machines; compare only within one invocation, and alternate
the sides.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

PRELUDE = """
import json
import torch
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
"""

FINISH = """
out = {k: res[k] for k in keep if k in res}
out["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
print("AB_RESULT " + json.dumps(out), flush=True)
"""

RUN_MONO = """
try:
    from multi_orbslam3_tpu_torch.dataio import synthetic
except ImportError:          # a checkout from before the port had its own copy
    from multi_orbslam3_tpu.dataio import synthetic
cfg = cs.euroc_scale_config()
seq = synthetic.make_sequence(cfg, n_frames=120, n_points=1500, seed=5,
                              trajectory="forward")
res, _ = cs.phase_slice(cfg, seq, loop_closing=True)
keep = ("fps", "wall_s", "frame_ms_p50", "frame_ms_p90", "frame_ms_p99",
        "frames_ok", "ate_over_span", "pr_step_ms_median", "cascades",
        "cascade_ms", "launches")
"""

RUN_STEREO = """
from multi_orbslam3_tpu_torch.dataio import synthetic
cfg = cs.euroc_scale_config(baseline=0.11).replace(sensor="stereo")
seq = synthetic.make_sequence(cfg, n_frames=80, n_points=1200, seed=9,
                              trajectory="forward")
res, _ = cs.phase_stereo(cfg, seq)
keep = ("fps", "wall_s", "frame_ms_p50", "frame_ms_p90", "frame_ms_p99",
        "frames_ok", "ate_over_span", "kf_inserted", "launches")
"""

RUN_MONO_INERTIAL = """
res = cs.phase_mono_inertial()
keep = ("fps", "wall_s", "frame_ms_p50", "frame_ms_p90", "frame_ms_p99",
        "frames_ok", "ate_rmse", "span", "imu_init_frame", "imu_init_scale",
        "kf_evaluated", "stages", "launches")
"""

RUN_COLLAB = """
with cs.reproducible():
    cs.phase_collab(deterministic=True)
    res, _ = cs.phase_collab(deterministic=True)
keep = ("total_fps_wall", "wall_s", "comm_cycle_ms_p50", "comm_cycle_ms_p90",
        "comm_cycle_ms_p99", "gn_step_ms", "gn_step_ms_all", "merges", "gba_runs",
        "obs_valid", "agent0", "agent1", "launches")
"""

MODES = {"mono": RUN_MONO, "stereo": RUN_STEREO, "mono_inertial": RUN_MONO_INERTIAL,
         "collab": RUN_COLLAB}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="mono")
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args(argv)
    if not args.trees:
        print(__doc__)
        return 2
    program = PRELUDE + MODES[args.mode] + FINISH
    for i, tree in enumerate(args.trees):
        proc = subprocess.run([sys.executable, "-c", program], cwd=tree,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": i, "mode": args.mode, "tree": tree,
                          **json.loads(lines[-1][len("AB_RESULT "):])}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
