"""K2's matrix writer and stereo match against their earlier designs and
against cuBLASLt's int8 product, in turns on one card.

    python profiling/k2_redesign_ab.py --parent DIR [--out FILE] [--rounds 2]

DIR is a checkout of the port whose multi_orbslam3_tpu_torch/csrc/hamming.cu
still holds the __popc matrix writer (64 x 64 tiles) and the stereo mask
of the all-columns walk (mo3_hamming_matrix and mo3_hamming_best_two_stereo
with the C arguments of today's entry points). The script builds that file
with nvcc, loads it beside this checkout's kernels (kernels.build()) and,
on the same inputs:
- the matrix at chip_smoke.py's shapes (16,384 x 1,024, 1,024^2, 16,384^2):
  the earlier writer, the tensor-core writer and torch._int_mm on the
  descriptors unpacked once to +-1 int8 (which gives 256 - 2 x the
  distance), each held equal to the plain version;
- the stereo match at 1,024^2 on chip_smoke.py's random and on-the-
  tolerance cases and at 4,096^2 on a 1241 x 376 frame: the earlier walk
  and the row-band search, both held equal to the plain version.
Each is timed `--rounds` times in turns (earlier, new, [library,] [library,]
new, earlier): the device time of a call is the sum of the device events
(kernels, memcpys, memsets) of 50 calls (10 at 16,384^2) from torch.profiler,
over the calls. One JSON line a shape and case, with bound_ms and
popc_bound_ms as chip_smoke.bound counts them, the card's nvidia-smi name
and power limit beside every line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (blocks jax and the JAX package on import)
from multi_orbslam3_tpu_torch.frontend import kernels  # noqa: E402
from multi_orbslam3_tpu_torch.profiling import common  # noqa: E402


def build_parent(parent: Path) -> ctypes.CDLL:
    src = parent / "multi_orbslam3_tpu_torch" / "csrc" / "hamming.cu"
    out = parent / "multi_orbslam3_tpu_torch" / "_build" / "libmo3_parent_hamming.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mo3_hamming_matrix.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.mo3_hamming_best_two_stereo.argtypes = [
        vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, ci, cf, cf, ci, vp, vp, vp, vp]
    lib.mo3_hamming_matrix.restype = ci
    lib.mo3_hamming_best_two_stereo.restype = ci
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def parent_matrix(lib, d1, d2):
    out = torch.empty((d1.shape[0], d2.shape[0]), dtype=torch.int32, device=d1.device)
    assert lib.mo3_hamming_matrix(d1.data_ptr(), d2.data_ptr(), out.data_ptr(),
                                  d1.shape[0], d2.shape[0], stream()) == 0
    return out


def parent_stereo(lib, c):
    n, m, dev = c["descL"].shape[0], c["descR"].shape[0], c["descL"].device
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty(n, dtype=torch.int32, device=dev)
    assert lib.mo3_hamming_best_two_stereo(
        c["descL"].data_ptr(), c["uvL"].data_ptr(), c["validL"].data_ptr(),
        c["tol"].data_ptr(), c["levelL"].data_ptr(), n, c["descR"].data_ptr(),
        c["uvR"].data_ptr(), c["validR"].data_ptr(), c["levelR"].data_ptr(), m,
        kernels.STEREO_MIN_DISPARITY, float(c["max_disparity"]), kernels.STEREO_LEVEL_SLACK,
        idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream()) == 0
    return idx, best, second


def device_ms(fn, calls: int) -> float:
    """Sum of the device events of `calls` calls of fn, over the calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = common._device_events(prof)
    if len(events) < calls:
        raise RuntimeError(f"the profiler saw {len(events)} device events for {calls} calls")
    return sum(e[2] for e in events) / 1e6 / calls


def in_turns(arms: dict, rounds: int, calls: int) -> dict:
    """Each arm timed `rounds` times, in the order a, b, ..., ..., b, a."""
    names = list(arms)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(device_ms(arms[k], calls))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = chip_smoke.phase_device()
    kernels.build()
    lib = build_parent(Path(args.parent))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lines = []

    def emit(**kw):
        line = json.dumps({"card": card["smi"], **kw})
        print(line, flush=True)
        lines.append(line)

    for n, m in ((16384, 1024), (1024, 1024), (16384, 16384)):
        d1, d2 = chip_smoke.random_words(n, gen, dev), chip_smoke.random_words(m, gen, dev)
        ref = kernels.hamming_matrix_ref(d1, d2)
        a_pm1, b_pm1 = kernels.unpack_pm1(d1), kernels.unpack_pm1(d2)
        arms = {"earlier": lambda: parent_matrix(lib, d1, d2),
                "tensor_core": lambda: kernels.hamming_matrix(d1, d2),
                "int_mm": lambda: torch._int_mm(a_pm1, b_pm1.t())}
        exact = {k: bool(torch.equal(fn() if k != "int_mm"
                                     else kernels.hamming_from_pm1_dot(fn()), ref))
                 for k, fn in arms.items()}
        del ref
        torch.cuda.empty_cache()
        times = in_turns(arms, args.rounds, 10 if n * m > 2 ** 26 else 50)
        emit(kernel="hamming_matrix", shape=[n, m], exact=exact, device_ms=times,
             **chip_smoke.bound(card, 32.0 * (n + m) + 4.0 * n * m, hamming_pairs=float(n) * m))
        del a_pm1, b_pm1
        torch.cuda.empty_cache()

    cases = [(1024, 1024, 752, 480, "random"), (1024, 1024, 752, 480, "tolerance"),
             (4096, 4096, 1241, 376, "random")]
    for n, m, w, h, kind in cases:
        c = chip_smoke.stereo_case(n, m, gen, dev, kind, w, h)
        want = kernels.hamming_best_two_stereo_ref(**c)
        arms = {"earlier": lambda: parent_stereo(lib, c),
                "band": lambda: kernels.hamming_best_two_stereo(**c)}
        exact = {k: all(bool(torch.equal(g, w_)) for g, w_ in zip(fn(), want))
                 for k, fn in arms.items()}
        both = c["validL"][:, None] & c["validR"][None, :]
        dv = (c["uvL"][:, None, 1] - c["uvR"][None, :, 1]).abs()
        disp = c["uvL"][:, None, 0] - c["uvR"][None, :, 0]
        in_band = (dv <= c["tol"][:, None]) & both
        passing = float((in_band & (disp > 0.3) & (disp < 128.0)
                         & ((c["levelL"][:, None] - c["levelR"][None, :]).abs() <= 1)).sum())
        band = float(in_band.sum())
        times = in_turns(arms, args.rounds, 50)
        emit(kernel="hamming_best_two_stereo", shape=[n, m], image=[w, h], inputs=kind,
             exact=exact, band_pairs=band, window_pairs=passing, device_ms=times,
             **chip_smoke.bound(card, 49.0 * n + 45.0 * m + 16.0 * n, hamming_pairs=passing,
                                fp32_instr=3.0 * band, minmax_instr=3.0 * band))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    ok = all(all(json.loads(ln)["exact"].values()) for ln in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
