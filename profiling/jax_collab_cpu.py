"""The JAX package's bench_collab on the CPU, with the merge record.

    python profiling/jax_collab_cpu.py --seed 31 [--server-deterministic]
                                       [--frames 150] --out FILE.json

Builds bench_collab's run as multi_orbslam3_tpu/eval/benchmarks.py:186-287
builds it: synthetic_mono() (640x480; arena 1,024 keyframes, 32,768
landmarks), 2 agents x 150 frames of a circular orbit of 1,200 points from
--seed, phase 1.1 + 0.55 a, arc 2.3 pi, each frame both clients'
process_frame and comm_cycle then the server's comm_cycle (GBA on
events), drain_gba at the end; one pass (the bench's warm-up pass only
fills XLA's caches). --server-deterministic sets the server's
`deterministic` flag: one GBA step a cycle and adoption on a fixed cycle,
instead of stepping only when the previous step is ready on the device.
JAX on the CPU sums in one order, so with the flag a run repeats; without
it the GBA's timing follows the host's speed. The matmul precision is
"highest", as the JAX test suite sets it.

Writes one JSON object to --out: the scored result (each agent's
server-arena keyframe ATE / span and the phase's gate, as
chip_smoke.phase_collab scores the port), the server's counters, the
seconds, and the merge record (profiling/collab_merge_record.py: every
Sim3-verified cascade with its inliers, n_proj and Sim3 error against
ground truth, each client frame's own / foreign inliers, every cycle's
ATEs, corrections, gauges and GBA adoptions). A run takes 12-16 minutes
on an 8-core host with two running at once, and up to about 12 GiB; run
it in the background, two at a time.
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import collab_merge_record as cmr  # noqa: E402


def run(seed: int, server_deterministic: bool, n_frames: int = 150) -> dict:
    from multi_orbslam3_tpu import config as cfg
    from multi_orbslam3_tpu.collab.client import CollabClient
    from multi_orbslam3_tpu.collab.server import CollabServer
    from multi_orbslam3_tpu.collab.transport import InProcessTransport
    from multi_orbslam3_tpu.dataio import synthetic
    from multi_orbslam3_tpu.pipeline import loop_closing
    from multi_orbslam3_tpu.pipeline.system import TrackState
    c = cfg.synthetic_mono()
    n_agents = 2
    seqs = [synthetic.make_sequence(c, n_frames=n_frames, n_points=1200, seed=seed,
                                    trajectory="circle", phase=1.1 + 0.55 * a,
                                    arc=2.3 * np.pi) for a in range(n_agents)]
    tr = InProcessTransport()
    clients = [CollabClient(c, a, tr) for a in range(n_agents)]
    server = CollabServer(c, tr, n_agents=n_agents)
    server.deterministic = server_deterministic
    rec = cmr.MergeRecord(loop_closing)
    rec.install(server, clients, seqs)
    states = [[] for _ in range(n_agents)]
    t0 = time.perf_counter()
    try:
        for i in range(n_frames):
            for a, cl in enumerate(clients):
                states[a].append(cl.process_frame(seqs[a].images[i],
                                                  float(seqs[a].timestamps[i])))
                cl.comm_cycle()
            server.comm_cycle()
            rec(i, server, clients, seqs)
        server.drain_gba()
        rec(n_frames, server, clients, seqs)
    finally:
        rec.close()
    wall = time.perf_counter() - t0
    res = cmr.score(server, seqs, states, TrackState.OK)
    st = server.stats
    res.update(package="jax", backend=jax.default_backend(), seed=seed,
               server_deterministic=server_deterministic, frames=n_frames,
               merges=st["merges"], loops=st["loops"], gba_runs=st["gba_runs"],
               gba_rejected=st.get("gba_rejected", 0), gba_aborted=st.get("gba_aborted", 0),
               seconds=wall, total_fps_wall=n_agents * n_frames / wall, server=dict(st),
               merge_summary=rec.summary(), record=rec.to_json())
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--server-deterministic", action="store_true")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    res = run(args.seed, args.server_deterministic, args.frames)
    with open(args.out, "w") as f:
        json.dump(res, f, default=float)
    brief = {k: res[k] for k in ("package", "seed", "server_deterministic", "merges", "loops",
                                 "gba_runs", "failed", "failed_agents", "seconds")}
    brief.update({a: res[a] for a in ("agent0", "agent1")}, merge=res["merge_summary"])
    print(json.dumps(brief, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
