"""Covisibility formulations at the map's shape (counterpart of the JAX
package's profiling/profile_covis.py), and the chunked covisibility matrix
at the 4-agent arena's.

    python -m multi_orbslam3_tpu_torch.profiling.profile_covis [--device cpu]

K=512 keyframes x N=1,024 features, P=16,384 landmarks, inputs drawn
from RandomState(0) in the JAX script's order (about half the slots hold
a landmark, 90% of features valid). Times the shared-landmark counts of
keyframe 5 against every keyframe four ways: the (K,P) observation mask
and a matvec, a bool membership gather, a float32 membership gather, and
a one-hot matmul scanned over keyframes (5 calls), plus the port's
mapstate.covisibility_row on a MapState holding the same arrays.

The mask counts each shared landmark once; the gathers, the scan and
covisibility_row count each feature that holds one, so they differ where
a keyframe's random row names a landmark twice (a map never does). The
agreement check holds each formulation, exactly, to a numpy count of its
own kind (covisibility_row without keyframe 5's own entry, which it sets
to 0) and reports the rows where the two kinds differ.

Then mapstate.covisibility_matrix on an arena of 2,048 keyframes x 1,024
features and 65,536 landmarks (about half the slots filled) with the
default chunk of 8,192 landmarks and with one chunk: ms a call, the peak
device memory above what the map holds, and whether the two agree.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.profiling import common

K, N, P = 512, 1024, 16384
QUERY = 5
ARENA = (2048, 1024, 65536)


def inputs(K: int = K, N: int = N, P: int = P) -> dict:
    """The JAX script's arrays: kf_mp (K,N) with -1 for an empty slot and
    the feature validity fv (K,N)."""
    rng = np.random.RandomState(0)
    kf_mp = np.where(rng.rand(K, N) < 0.5, rng.randint(0, P, (K, N)), -1).astype(np.int32)
    fv = rng.rand(K, N) < 0.9
    return {"kf_mp": kf_mp, "fv": fv}


def mask_matvec(kf_mp, fv, kv, mv, kf: int):
    """(K,P) bool observation mask, then its float32 product with the row."""
    Kn, Nn = kf_mp.shape
    P_ = mv.shape[0]
    valid = (kf_mp >= 0) & fv & kv[:, None]
    rows = torch.arange(Kn, device=kf_mp.device).repeat_interleave(Nn)
    obs = torch.zeros((Kn, P_ + 1), dtype=torch.bool, device=kf_mp.device).index_put(
        (rows, torch.where(valid, kf_mp, P_).reshape(-1).long()),
        torch.ones(Kn * Nn, dtype=torch.bool, device=kf_mp.device))[:, :P_] & mv[None, :]
    return (obs.float() @ obs[kf].float()).to(torch.int32)


def _member(kf_mp, fv, kf: int, P_: int, dtype):
    """(P+1,) membership of keyframe kf's landmarks; slot P is the sink."""
    row, row_ok = kf_mp[kf], (kf_mp[kf] >= 0) & fv[kf]
    member = torch.zeros(P_ + 1, dtype=dtype, device=kf_mp.device)
    member[torch.where(row_ok, row, P_).long()] = True if dtype == torch.bool else 1.0
    member[P_] = 0
    return member


def _slots(kf_mp, fv, kv, P_: int):
    ok = (kf_mp >= 0) & fv & kv[:, None]
    return torch.where(ok, kf_mp, P_).long(), ok


def gather_bool(kf_mp, fv, kv, mv, kf: int):
    """Bool membership of the query row, gathered at every keyframe's slots."""
    P_ = mv.shape[0]
    slot, _ = _slots(kf_mp, fv, kv, P_)
    return _member(kf_mp, fv, kf, P_, torch.bool)[slot].sum(1).to(torch.int32)


def gather_f32(kf_mp, fv, kv, mv, kf: int):
    """The same with a float32 membership and a float32 row sum."""
    P_ = mv.shape[0]
    slot, _ = _slots(kf_mp, fv, kv, P_)
    return _member(kf_mp, fv, kf, P_, torch.float32)[slot].sum(1).to(torch.int32)


def onehot_scan(kf_mp, fv, kv, mv, kf: int):
    """For each keyframe in turn, its (N,P) one-hot times the membership."""
    P_ = mv.shape[0]
    member = _member(kf_mp, fv, kf, P_, torch.float32)[:P_]
    slot, ok = _slots(kf_mp, fv, kv, P_)
    cols = torch.arange(P_, device=kf_mp.device)
    return torch.stack([(((s[:, None] == cols) & o[:, None]).float() @ member).sum()
                        for s, o in zip(slot, ok)]).to(torch.int32)


FORMULATIONS = {"mask_matvec": mask_matvec, "gather_bool": gather_bool,
                "gather_f32": gather_f32, "onehot_scan": onehot_scan}
REPS = {"onehot_scan": 5}


def as_map(kf_mp: torch.Tensor, fv: torch.Tensor, P_: int) -> ms.MapState:
    """A MapState whose keyframes and landmarks are all valid and whose
    associations are kf_mp."""
    Kn, Nn = kf_mp.shape
    m = ms.empty_map(Kn, P_, Nn, kf_mp.device)
    return m._replace(kf_mp=kf_mp, kf_feat_valid=fv,
                      kf_valid=torch.ones(Kn, dtype=torch.bool, device=kf_mp.device),
                      mp_valid=torch.ones(P_, dtype=torch.bool, device=kf_mp.device))


def reference_counts(kf_mp: np.ndarray, fv: np.ndarray, P_: int, kf: int) -> tuple:
    """numpy (per feature, distinct) shared-landmark counts of keyframe kf."""
    ok = (kf_mp >= 0) & fv
    slot = np.where(ok, kf_mp, P_)
    member = np.zeros(P_ + 1, bool)
    member[slot[kf]] = True
    member[P_] = False
    obs = np.zeros((kf_mp.shape[0], P_ + 1), bool)
    obs[np.repeat(np.arange(kf_mp.shape[0]), kf_mp.shape[1]), slot.reshape(-1)] = True
    obs = obs[:, :P_]
    return member[slot].sum(1), (obs & obs[kf]).sum(1)


def _arena(device, Kn: int, Nn: int, P_: int) -> ms.MapState:
    g = torch.Generator(device=device)
    g.manual_seed(0)
    filled = torch.rand((Kn, Nn), generator=g, device=device) < 0.5
    kf_mp = torch.where(filled, torch.randint(0, P_, (Kn, Nn), generator=g, device=device),
                        -1).to(torch.int32)
    return as_map(kf_mp, torch.ones((Kn, Nn), dtype=torch.bool, device=device), P_)


def _peak_mib(fn, device) -> tuple:
    """(result, peak device MiB above what was allocated before the call)."""
    if device.type != "cuda":
        return fn(), None
    common.sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    common.sync(device)
    return out, (torch.cuda.max_memory_allocated(device) - base) / 2 ** 20


def run(K: int = K, N: int = N, P: int = P, reps: int = 30, arena=ARENA,
        device=None) -> dict:
    device = devices.resolve(device, "profile_covis")
    a = inputs(K, N, P)
    kf_mp = torch.from_numpy(a["kf_mp"]).to(device)
    fv = torch.from_numpy(a["fv"]).to(device)
    kv = torch.ones(K, dtype=torch.bool, device=device)
    mv = torch.ones(P, dtype=torch.bool, device=device)
    m = as_map(kf_mp, fv, P)
    fns = {name: (lambda f=f: f(kf_mp, fv, kv, mv, QUERY)) for name, f in FORMULATIONS.items()}
    fns["covisibility_row"] = lambda: ms.covisibility_row(m, QUERY)
    rows = {name: {**common.timeit(fn, REPS.get(name, reps), device),
                   "calls": REPS.get(name, reps), "launches": common.launches(fn, device)}
            for name, fn in fns.items()}
    per_feature, distinct = reference_counts(a["kf_mp"], a["fv"], P, QUERY)
    others = np.arange(K) != QUERY
    got = {name: fn().cpu().numpy() for name, fn in fns.items()}
    agree = {name: bool(np.array_equal(got[name], distinct if name == "mask_matvec"
                                       else per_feature))
             for name in FORMULATIONS}
    agree["covisibility_row"] = bool(np.array_equal(got["covisibility_row"][others],
                                                    per_feature[others]))
    out = {"profile": "covis", "device": common.card_name(device),
           "shape": {"K": K, "N": N, "P": P, "query": QUERY}, "formulations": rows,
           "agree": agree, "all_agree": all(agree.values()),
           "rows_where_kinds_differ": int((per_feature != distinct).sum())}
    arena_map = _arena(device, *arena)
    mats = {}
    for name, chunk in (("chunk_8192", 8192), ("one_chunk", arena[2])):
        mats[name], peak = _peak_mib(lambda: ms.covisibility_matrix(arena_map, chunk), device)
        out.setdefault("covisibility_matrix_arena", {"shape": list(arena)})[name] = {
            **common.timeit(lambda: ms.covisibility_matrix(arena_map, chunk), 3, device),
            "peak_mib": peak}
    out["covisibility_matrix_arena"]["chunks_agree"] = bool(
        torch.equal(mats["chunk_8192"], mats["one_chunk"]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    out = run(device=ap.parse_args(argv).device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
