"""Local-BA assembly at the mapping chain's shapes: index_add against
one-hot matmuls, and bundle_adjust with either assembly (counterpart of
the JAX package's profiling/profile_scatter.py).

    python -m multi_orbslam3_tpu_torch.profiling.profile_scatter [--device cpu]

Kw=24 window keyframes x N=1,024 observations each, Pw=4,096 landmarks,
inputs drawn from RandomState(0) in the JAX script's order, so both
packages see the same arrays. Times E (24,4096,6,3) and Hpp (4096,3,3) by
index_add and by one-hot matmuls with bf16 operands and float32
accumulation (the JAX script's precision), then bundle_adjust at iters
1/2/10 and with grouped=True at iters 1/2/8/10. Reports how far the
one-hot assemblies lie from index_add's, and the grouped solve from the
scatter one on tests/test_opt.py's converging window (seed 4, 8
iterations; the timed problem's random measurements have no solution, so
its LM steps part ways on the last bit of a sum). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.opt import local_ba
from multi_orbslam3_tpu_torch.profiling import common

KW, N, PW = 24, 1024, 4096
BA_ITERS = (1, 2, 10)
GROUPED_ITERS = (1, 2, 8, 10)


def inputs(Kw: int = KW, N: int = N, Pw: int = PW) -> dict:
    """The JAX script's arrays, drawn in its order: landmark index, E and
    Hpp products of each observation, then landmarks and measurements."""
    O = Kw * N
    rng = np.random.RandomState(0)
    out = {"pt": rng.randint(0, Pw, (O,)).astype(np.int32),
           "kf": np.repeat(np.arange(Kw, dtype=np.int32), N),
           "prod_E": rng.randn(O, 6, 3).astype(np.float32),
           "prod_Hpp": rng.randn(O, 3, 3).astype(np.float32)}
    out["points"] = np.asarray(rng.randn(Pw, 3) + [0, 0, 5], np.float32)
    out["uv"] = np.asarray(rng.rand(O, 2) * 400, np.float32)
    return out


def scatter_E(kf: torch.Tensor, pt: torch.Tensor, prod: torch.Tensor, Kw: int, Pw: int):
    """E (Kw,Pw,6,3) by index_add over the observations."""
    return torch.zeros((Kw * Pw, 6, 3), dtype=prod.dtype, device=prod.device).index_add(
        0, kf.long() * Pw + pt.long(), prod).reshape(Kw, Pw, 6, 3)


def scatter_Hpp(pt: torch.Tensor, prod: torch.Tensor, Pw: int):
    """Hpp (Pw,3,3) by index_add over the observations."""
    return torch.zeros((Pw, 3, 3), dtype=prod.dtype, device=prod.device).index_add(
        0, pt.long(), prod)


def onehot_blocks(pt: torch.Tensor, prod: torch.Tensor, Kw: int, Pw: int,
                  operand: torch.dtype) -> torch.Tensor:
    """(Kw,Pw,C): each window keyframe's one-hot (N,Pw) transposed times its
    (N,C) products. float32 operands: local_ba.onehot_blocks, the grouped
    assembly itself. bf16 operands (the JAX script's): the same blocks of
    keyframes with float32 accumulation, on the card through bmm's float32
    output, on the CPU as float32 products of the bf16-rounded operands,
    which are exact."""
    n = pt.shape[0] // Kw
    pt_k = pt.reshape(Kw, n)
    pr = prod.reshape(Kw, n, -1)
    if operand == torch.float32:
        return local_ba.onehot_blocks(pt_k, pr, Pw)
    pr = pr.to(operand)
    cols = torch.arange(Pw, device=pt.device)
    c = max(1, local_ba._ONEHOT_ELEMS // (n * Pw))
    out = []
    for k in range(0, Kw, c):
        oh = (pt_k[k:k + c, :, None] == cols).to(operand).transpose(1, 2)
        if pt.device.type == "cuda":
            out.append(torch.bmm(oh, pr[k:k + c], out_dtype=torch.float32))
        else:
            out.append(torch.bmm(oh.float(), pr[k:k + c].float()))
    return torch.cat(out)


def onehot_E(pt, prod, Kw: int, Pw: int, operand=torch.bfloat16):
    return onehot_blocks(pt, prod, Kw, Pw, operand).reshape(Kw, Pw, 6, 3)


def onehot_Hpp(pt, prod, Kw: int, Pw: int, operand=torch.bfloat16):
    return onehot_blocks(pt, prod, Kw, Pw, operand).sum(0).reshape(Pw, 3, 3)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error relative to the largest entry of want."""
    return float((got - want).abs().max() / want.abs().max())


def ba_problem(arrays: dict, Kw: int, Pw: int, device):
    """The JAX script's bundle_adjust inputs: identity poses, keyframe 0
    fixed, pinhole (458, 457, 376, 240)."""
    from multi_orbslam3_tpu_torch.geometry import camera
    t = lambda a: torch.from_numpy(a).to(device)
    K = camera.PinholeK(*[torch.tensor(v, device=device) for v in (458.0, 457.0, 376.0, 240.0)])
    O = arrays["pt"].shape[0]
    obs = local_ba.BAObservations(
        kf=t(arrays["kf"]).long(), pt=t(arrays["pt"]).long(), uv=t(arrays["uv"]),
        inv_sigma2=torch.ones(O, device=device),
        valid=torch.ones(O, dtype=torch.bool, device=device))
    poses = torch.eye(4, device=device).repeat(Kw, 1, 1)
    fixed = torch.zeros(Kw, dtype=torch.bool, device=device)
    fixed[0] = True
    return poses, fixed, t(arrays["points"]), obs, K


def opt_window(device, n_kf: int = 4, n_pts: int = 100, noise_pose: float = 0.02,
               noise_pt: float = 0.05, seed: int = 4):
    """tests/test_opt.py::TestBundleAdjust._window: every keyframe of a
    4-keyframe window sees every landmark of a random scene, keyframe 0
    fixed, the other poses and the landmarks perturbed. Returns the
    bundle_adjust arguments (poses0, fixed, points0, obs, K)."""
    from multi_orbslam3_tpu_torch.geometry import camera, se3
    rng = np.random.RandomState(seed)
    srng = np.random.RandomState(seed)
    pts = torch.from_numpy(np.stack([
        srng.uniform(-2, 2, n_pts), srng.uniform(-1.5, 1.5, n_pts),
        srng.uniform(3.0, 7.0, n_pts)], axis=1).astype(np.float32)).to(device)
    K = camera.PinholeK(*[torch.tensor(v, device=device) for v in (400.0, 400.0, 320.0, 240.0)])
    poses = se3.exp(torch.tensor([[0.0, 0.01 * i, 0.0, 0.3 * i, 0.0, 0.0]
                                  for i in range(n_kf)], device=device))
    kf = torch.arange(n_kf, device=device).repeat_interleave(n_pts)
    pt = torch.arange(n_pts, device=device).repeat(n_kf)
    obs = local_ba.BAObservations(
        kf=kf, pt=pt, uv=camera.project(K, se3.apply(poses[kf], pts[pt])),
        inv_sigma2=torch.ones(n_kf * n_pts, device=device),
        valid=torch.ones(n_kf * n_pts, dtype=torch.bool, device=device))
    noise = [torch.from_numpy((rng.randn(6) * noise_pose).astype(np.float32)).to(device)
             for _ in range(1, n_kf)]
    poses0 = torch.stack([poses[0]] + [se3.retract(poses[i], noise[i - 1])
                                       for i in range(1, n_kf)])
    pts0 = pts + torch.from_numpy((rng.randn(n_pts, 3) * noise_pt).astype(np.float32)).to(device)
    fixed = torch.arange(n_kf, device=device) == 0
    return poses0, fixed, pts0, obs, K


def run(Kw: int = KW, N: int = N, Pw: int = PW, reps: int = 20, ba_reps: int = 5,
        ba_iters=BA_ITERS, grouped_iters=GROUPED_ITERS, device=None) -> dict:
    device = devices.resolve(device, "profile_scatter")
    a = inputs(Kw, N, Pw)
    kf, pt = (torch.from_numpy(a[k]).to(device) for k in ("kf", "pt"))
    pE, pH = (torch.from_numpy(a[k]).to(device) for k in ("prod_E", "prod_Hpp"))
    fns = {
        "scatter_E": lambda: scatter_E(kf, pt, pE, Kw, Pw),
        "onehot_E": lambda: onehot_E(pt, pE, Kw, Pw),
        "scatter_Hpp": lambda: scatter_Hpp(pt, pH, Pw),
        "onehot_Hpp": lambda: onehot_Hpp(pt, pH, Kw, Pw),
    }
    rows = {name: {**common.timeit(fn, reps, device), "launches": common.launches(fn, device)}
            for name, fn in fns.items()}
    E, H = fns["scatter_E"](), fns["scatter_Hpp"]()
    E32, H32 = (onehot_E(pt, pE, Kw, Pw, torch.float32), onehot_Hpp(pt, pH, Kw, Pw, torch.float32))
    agreement = {
        "onehot_bf16_E_rel": rel_err(fns["onehot_E"](), E),
        "onehot_bf16_Hpp_rel": rel_err(fns["onehot_Hpp"](), H),
        "onehot_f32_E_max_abs": float((E32 - E).abs().max()),
        "onehot_f32_Hpp_max_abs": float((H32 - H).abs().max()),
        "onehot_f32_allclose": bool(torch.allclose(E32, E, rtol=1e-5, atol=1e-5)
                                    and torch.allclose(H32, H, rtol=1e-5, atol=1e-5))}
    problem = ba_problem(a, Kw, Pw, device)
    ba = {}
    for grouped, iters in [(False, i) for i in ba_iters] + [(True, i) for i in grouped_iters]:
        fn = lambda: local_ba.bundle_adjust(*problem, iters=iters, grouped=grouped)
        ba[f"{'grouped' if grouped else 'scatter'}_iters{iters}"] = {
            **common.timeit(fn, ba_reps, device), "iters": iters,
            "launches": common.launches(fn, device)}
    window = opt_window(device)
    rs = local_ba.bundle_adjust(*window, iters=8)
    rg = local_ba.bundle_adjust(*window, iters=8, grouped=True)
    agreement.update(window_poses_max_abs=float((rs.poses - rg.poses).abs().max()),
                     window_points_max_abs=float((rs.points - rg.points).abs().max()))
    return {"profile": "scatter", "device": common.card_name(device),
            "shape": {"Kw": Kw, "N": N, "Pw": Pw}, "assembly": rows,
            "bundle_adjust": ba, "agreement": agreement}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    out = run(device=ap.parse_args(argv).device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
