"""A/B of the PyTorch port's bench_mono slice between checkouts, on one GPU
within one process tree, so that both sides see the same card and host:

    python3 profiling/torch_ab_slice.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout that holds ``chip_smoke.py`` and
the port. For each, in the order given, a fresh interpreter started in that
directory imports its ``chip_smoke``, renders the bench sequence and runs
``phase_slice(cfg, seq, loop_closing=True)`` (a warm-up pass, then the
timed pass, with that checkout's own gates). Prints one JSON line a run
(fps, frame-time percentiles, frames OK, ATE, peak memory, cascade and
place-recognition times, kernel launches) and a last line with the card's
nvidia-smi name and power limit. Host-bound numbers swing between
machines; compare only within one invocation, and alternate the sides.
"""

from __future__ import annotations

import json
import subprocess
import sys

RUN_SLICE = """
import json
import torch
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
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
out = {k: res[k] for k in keep}
out["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
print("AB_RESULT " + json.dumps(out), flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    for i, tree in enumerate(argv):
        proc = subprocess.run([sys.executable, "-c", RUN_SLICE], cwd=tree,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": i, "tree": tree,
                          **json.loads(lines[-1][len("AB_RESULT "):])}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
