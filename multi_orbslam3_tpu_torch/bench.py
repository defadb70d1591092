"""Benchmark of the port: full-system accuracy + throughput across the
BASELINE configs (counterpart of the repository's bench.py).

    python -m multi_orbslam3_tpu_torch.bench

Runs on the CUDA device and fails where there is none. Prints ONE JSON
line on stdout, re-printed after every core config (the last line is the
whole result): the primary metric is tracked frames/s/chip of the mono
config (vs_baseline = fps / the reference's 20 fps real-time envelope,
BASELINE.md), and ``configs`` carries each config's full-system results:

- mono / stereo / mono_inertial / collab_2agent: ATE RMSE (Sim3-aligned;
  SE3 for stereo) over OK-tracked frames of a synthetic ground-truth
  sequence, plus fps over the WHOLE pipeline (keyframe insertion,
  triangulation, fusion, local BA, loop closing included). mono, stereo
  and mono_inertial run two passes (the first warms the kernel build, the
  allocator and every path's first use; the second is timed). The collab
  configs run a single pass and report both fps definitions:
  total_fps_wall (frames/wall) and total_fps_tail (steady state over the
  tail two-thirds; collab's headline total_fps);
- mini_asl (the EuRoC-layout ingest drill), gba_large (global BA at
  1,024 keyframes / 32,768 landmarks), collab_4agent and vocab (the
  place-recognition selectivity of the two bundled vocabularies), in that
  order, each recorded as {"error": ...} if it raises.

With MO3_BENCH_FULL=1 the heavier studies follow on stderr (stdout stays
one JSON line a config): global-BA iters/s on the 2-agent arena, the
kernel micro-bench (each hand-written kernel against its plain version),
the sharded GBA over 1/2/4/8 shards of the card (eval/gba_scaling.py) and
EuRoC, if a dataset exists (EUROC_ROOT).

Every number comes from this run on this device; none is carried over
from the JAX package's TPU runs.
"""

from __future__ import annotations

import json
import os
import sys
import traceback


def main() -> None:
    from multi_orbslam3_tpu_torch.eval import benchmarks as B

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    configs = {}

    def emit():
        fps = configs.get("mono", {}).get("fps", 0.0)
        print(json.dumps({
            "metric": "tracked_frames_per_s_per_chip",
            "value": fps,
            "unit": "frames/s",
            "vs_baseline": round(fps / 20.0, 3),
            "configs": configs,
        }), flush=True)

    def guarded(fn, *args, **kw):
        """The config's result, or {"error": ...} with the traceback on
        stderr: one failed study does not lose the ones after it."""
        try:
            return fn(*args, **kw)
        except Exception as e:  # noqa: BLE001
            log(traceback.format_exc())
            return {"error": f"{type(e).__name__}: {e}"[:300]}

    log("bench: mono (full system, loop closing on)...")
    configs["mono"] = B.bench_mono()
    log(f"  -> {configs['mono']}")
    emit()
    log("bench: stereo...")
    configs["stereo"] = B.bench_stereo()
    log(f"  -> {configs['stereo']}")
    emit()
    log("bench: mono_inertial (EuRoC T_bc)...")
    configs["mono_inertial"] = B.bench_mono_inertial()
    log(f"  -> {configs['mono_inertial']}")
    emit()
    log("bench: mini-ASL (EuRoC-layout dataset-ingest drill)...")
    configs["mini_asl"] = guarded(B.bench_mini_asl)
    log(f"  -> {configs['mini_asl']}")
    emit()
    log("bench: collab 2-agent (150 frames, GBA on, single pass)...")
    configs["collab_2agent"], server = B.bench_collab(n_agents=2, warmup=False)
    log(f"  -> {configs['collab_2agent']}")
    emit()
    log("bench: global BA at arena scale (1024 KF / 32k MP)...")
    configs["gba_large"] = guarded(B.bench_gba_large)
    log(f"  -> {configs['gba_large']}")
    emit()
    log("bench: collab 4-agent (BASELINE config #5, 100 frames)...")
    res = guarded(B.bench_collab, n_agents=4, n_frames=100, warmup=False)
    configs["collab_4agent"] = res[0] if isinstance(res, tuple) else res
    log(f"  -> {configs['collab_4agent']}")
    emit()
    log("bench: vocabulary selectivity (10k vs 100k words)...")
    configs["vocab"] = guarded(B.bench_vocab_selectivity)
    log(f"  -> {configs['vocab']}")
    emit()

    if os.environ.get("MO3_BENCH_FULL") != "1":
        return

    # ---- full mode: extra studies, results on stderr only -------------
    extra = {}
    log("bench[full]: global BA iters/s (2-agent arena)...")
    extra["gba"] = B.bench_gba(server)
    log(f"  -> {extra['gba']}")
    log("bench[full]: hand-written kernels against their plain versions...")
    extra["kernels"] = B.bench_kernels()
    log(f"  -> {extra['kernels']}")
    log("bench[full]: sharded GBA over 1/2/4/8 shards of the card...")
    extra["gba_scaling"] = _gba_scaling_sweep()
    log(f"  -> {extra['gba_scaling']}")
    euroc_root = os.environ.get(
        "EUROC_ROOT", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "datasets", "euroc", "MH01"))
    euroc = B.bench_euroc(euroc_root)
    if euroc:
        extra["euroc_mono"] = euroc
    log("FULL_RESULTS " + json.dumps(extra))


def _gba_scaling_sweep(shard_counts=(1, 2, 4, 8)) -> dict:
    """The sharded global BA (eval/gba_scaling.py's arena: 48 keyframes,
    3,072 landmarks, 2 agents) over N shards of one card, N = 1, 2, 4, 8,
    in this process, beside the unsharded solve. The shards share the
    card, so this measures what sharding costs on one device (each shard
    launches its own observation-side kernels, and the camera-side
    partials meet in a plain sum), not a speed-up; across cards see
    ``python -m multi_orbslam3_tpu_torch.eval.gba_scaling --across-cards``."""
    from multi_orbslam3_tpu_torch.eval import gba_scaling
    out = {}
    single = gba_scaling.measure_gba(gba_scaling.make_server_arena(), force_shard=False)
    out["device"] = single["device"]
    out["single_path_iters_per_s"] = single["gba_iters_per_s"]
    for n in shard_counts:
        rec = gba_scaling.measure_gba(gba_scaling.make_server_arena(), devices=["cuda"] * n)
        out[f"iters_per_s_{n}_shards"] = rec["gba_iters_per_s"]
        out[f"rate_vs_1_shard_{n}"] = rec["gba_iters_per_s"] / out["iters_per_s_1_shards"]
    out["shard_overhead_1"] = out["single_path_iters_per_s"] / out["iters_per_s_1_shards"]
    return out


if __name__ == "__main__":
    main()
