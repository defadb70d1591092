"""K2's two fused matchers against their earlier designs, in turns on one
card.

    python profiling/k2_matchers_ab.py --parent DIR [--cases FILE] [--out FILE] [--rounds 2]

DIR is a checkout of the port before the compacted and grid-indexed
designs (e.g. `git archive` of that commit, unpacked under the git-ignored
_checkout/): its frontend/kernels.py still takes `inner=` ("popc": the
all-columns __popc walk of csrc/hamming.cu; "mma": the 1-bit MMA walk of
csrc/hamming_mma.cu). The script loads that kernels.py as a module of its
own, which builds DIR's sources with nvcc, beside this checkout's kernels
(kernels.build()) and, through each one's wrappers, host checks included,
runs on the same inputs:
- the validity match: the earlier walk (its wrapper's three launches: the
  column keys filled, the walk, their low words), the earlier MMA walk
  (the same three), and the compacted tensor-core search;
- the projection match: the earlier walk and the grid-indexed search;
at every shape and case of chip_smoke.py's check_k2_fused and
check_k2_arena, and on the captured inputs of FILE (torch.save of
{"tracking_coarse": kwargs, "triangulation": kwargs}, as
profiling/k2_matcher_shapes.py writes them). Every arm is held equal to
the plain version, and the new one issues no more device launches a call
than the earlier walk (else the exit code is 1). Each arm is timed `--rounds` times in turns (earlier,
new, new, earlier, ...): device_ms is the device time of the arm's own
kernels a call, from torch.profiler over 50 calls (10 at map x map);
call_device_ms a call replayed from a CUDA graph of as many calls (its
small ops and the gaps between launches, not the host); call_ms one call
between two CUDA events, synchronised after each (chip_smoke.call_ms: the
host's launch latency included, as the host-bound loops see it).
device_launches are the kernels, memcpys and memsets of one call, counted
as the nodes of a CUDA graph of the call (profiling.common.graph_launches)
and, beside them, by torch.profiler (device_launches_profiler). One JSON
line a shape and case, with the bound as chip_smoke.py counts it (what the
inputs need: the flags of every row and column, the records of the valid
ones; the outputs; the distances of the valid pairs, or for the projection
match of the pairs inside the windows) and the card's nvidia-smi name and
power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (blocks jax and the JAX package on import)
from multi_orbslam3_tpu_torch.frontend import kernels  # noqa: E402
from multi_orbslam3_tpu_torch.profiling import common  # noqa: E402

# the kernels of each arm, as torch.profiler names them (a substring)
ARM_KERNELS = {"earlier": "best_two_popc_kernel", "earlier_mma": "best_two_mma_kernel",
               "new_valid": chip_smoke.MATCHER_KERNELS["hamming_best_two_valid"][0],
               "new_projection": chip_smoke.MATCHER_KERNELS["hamming_best_two_projection"][0]}


def load_parent(parent: Path):
    """The parent's frontend/kernels.py as a module of its own: its
    wrappers, host checks included, over its csrc/ built into its _build/
    (its build(): one nvcc a source)."""
    import importlib.util
    path = parent / "multi_orbslam3_tpu_torch" / "frontend" / "kernels.py"
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def own_ms(fn, calls: int, name: str) -> float:
    """The device time of the kernels whose name contains `name`, a call,
    from torch.profiler's device events over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e[2] for e in common._device_events(prof) if name in e[0]) / 1e6 / calls


MEASURES = ("device_ms", "call_device_ms", "call_ms")


def in_turns(arms: dict, rounds: int, calls: int) -> dict:
    """Each arm timed `rounds` times, in the order a, b, ..., ..., b, a:
    device_ms, its own kernels' time a call; call_device_ms, a call
    replayed from a CUDA graph (chip_smoke.graph_ms: the wrapper's small
    ops and the gaps between launches, not the host); call_ms, the median
    of 15 calls each between two events and synchronised (the host's
    launch latency included)."""
    names = list(arms)
    times = {k: {m: [] for m in MEASURES} for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            fn, kernel_name = arms[k]
            times[k]["device_ms"].append(own_ms(fn, calls, kernel_name))
            times[k]["call_device_ms"].append(chip_smoke.graph_ms(fn, calls))
            times[k]["call_ms"].append(chip_smoke.call_ms(fn))
    return times


def launch_counts(arms: dict, dev) -> dict:
    """Each arm's device launches a call: from a CUDA graph of one call, and
    from torch.profiler."""
    return {"device_launches": {k: common.graph_launches(fn, dev)
                                for k, (fn, _) in arms.items()},
            "device_launches_profiler": {k: common.launches(fn, dev)
                                         for k, (fn, _) in arms.items()}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = chip_smoke.phase_device()
    kernels.build()
    pk = load_parent(Path(args.parent))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lines = []

    def emit(**kw):
        line = json.dumps({"card": card["smi"], **kw})
        print(line, flush=True)
        lines.append(line)

    def run_valid(d1, v1, d2, v2, shape, inputs):
        n, m = shape
        want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=2048)
        arms = {"earlier": (lambda: pk.hamming_best_two_valid(d1, v1, d2, v2),
                            ARM_KERNELS["earlier"]),
                "earlier_mma": (lambda: pk.hamming_best_two_valid(d1, v1, d2, v2, inner="mma"),
                                ARM_KERNELS["earlier_mma"]),
                "new": (lambda: kernels.hamming_best_two_valid(d1, v1, d2, v2),
                        ARM_KERNELS["new_valid"])}
        exact = {k: all(bool(torch.equal(g, w)) for g, w in zip(fn(), want))
                 for k, (fn, _) in arms.items()}
        del want
        launches = launch_counts(arms, dev)
        times = in_turns(arms, args.rounds, 10 if n * m > 2 ** 26 else 50)
        emit(kernel="hamming_best_two_valid", shape=[n, m], inputs=inputs, exact=exact,
             valid_rows=int(v1.sum()), valid_cols=int(v2.sum()),
             valid_pairs=float(v1.sum()) * float(v2.sum()), **launches, **times_flat(times),
             **chip_smoke.valid_bound(card, v1, v2))

    def run_projection(c, inputs):
        n, m = c["mp_desc"].shape[0], c["feat_desc"].shape[0]
        want = kernels.hamming_best_two_projection_ref(**c)
        arms = {"earlier": (lambda: pk.hamming_best_two_projection(**c),
                            ARM_KERNELS["earlier"]),
                "new": (lambda: kernels.hamming_best_two_projection(**c),
                        ARM_KERNELS["new_projection"])}
        exact = {k: all(bool(torch.equal(g, w)) for g, w in zip(fn(), want))
                 for k, (fn, _) in arms.items()}
        launches = launch_counts(arms, dev)
        times = in_turns(arms, args.rounds, 50)
        emit(kernel="hamming_best_two_projection", shape=[n, m], inputs=inputs, exact=exact,
             valid_rows=int(c["proj_valid"].sum()), valid_cols=int(c["feat_valid"].sum()),
             window_pairs=chip_smoke.window_pairs(c), **launches,
             **times_flat(times), **chip_smoke.projection_bound(card, c))

    cfg = chip_smoke.euroc_scale_config()
    P = cfg.map.max_mappoints
    for n, m in chip_smoke.k2_shapes(cfg):
        for kind in ("random", "full") + (("sparse",) if n == m == P else ()):
            case = chip_smoke.match_case(n, m, gen, dev, kind, 752, 480)
            run_valid(*case["valid"], (n, m), kind)
            if n * m <= 2 ** 26:
                run_projection(case["projection"], kind)
            del case
            torch.cuda.empty_cache()
    from multi_orbslam3_tpu_torch import config as cfgm
    c_arena = cfgm.synthetic_mono()
    PA = 2 * c_arena.map.max_mappoints
    for kind in ("sparse", "random"):
        case = chip_smoke.match_case(PA, PA, gen, dev, kind, 640, 480)
        run_valid(*case["valid"], (PA, PA), kind)
        del case
        torch.cuda.empty_cache()
    run_projection(chip_smoke.match_case(PA, c_arena.orb.n_features, gen, dev, "random",
                                         640, 480)["projection"], "random")
    if args.cases:
        cases = torch.load(args.cases)
        to = lambda c: {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                        for k, v in c.items()}
        run_projection(to(cases["tracking_coarse"]), "captured: coarse tracking, frame 60")
        t = to(cases["triangulation"])
        run_valid(t["d1"], t["valid1"], t["d2"], t["valid2"],
                  (t["d1"].shape[0], t["d2"].shape[0]), "captured: keyframe-pair triangulation")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    rows = [json.loads(ln) for ln in lines]
    ok = all(all(r["exact"].values())
             and r["device_launches"]["new"] <= r["device_launches"]["earlier"] for r in rows)
    return 0 if ok else 1


def times_flat(times: dict) -> dict:
    """{arm: [turns]} and the mean of each arm, for both measures."""
    out = {}
    for measure in MEASURES:
        out[measure] = {k: float(np.mean(v[measure])) for k, v in times.items()}
        out[measure + "_turns"] = {k: v[measure] for k, v in times.items()}
    return out


if __name__ == "__main__":
    sys.exit(main())
