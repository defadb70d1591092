"""Essential-graph invariant auditor (counterpart of
multi_orbslam3_tpu/map/audit.py): numpy over a host copy of the port's
MapState, with the JAX version's checks, messages and summary dict.

After merges and culls the spanning forest must stay a forest (valid
parents, acyclic, a root per sub-map) and the association arrays must stay
in range.
"""

from __future__ import annotations

from typing import List

import numpy as np

from multi_orbslam3_tpu_torch.map.mapstate import NO_MP, MapState


class EssentialGraphError(AssertionError):
    pass


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def check_essential_graph(m: MapState, kf_map=None) -> dict:
    """Audit the spanning forest and the association invariants. Raises
    EssentialGraphError with a specific message on the first violation;
    returns summary stats when clean.

    kf_map: optional (K,) sub-map id per slot; when given, parents must
    live in the same sub-map as their child."""
    n = int(m.n_kf)
    valid = _np(m.kf_valid[:n])
    parent = _np(m.kf_parent[:n])
    problems: List[str] = []

    # 1) parents in range and valid
    for k in np.nonzero(valid)[0]:
        p = int(parent[k])
        if p < -1 or p >= n:
            problems.append(f"kf {k}: parent {p} out of range [0,{n})")
        elif p >= 0 and not valid[p]:
            problems.append(f"kf {k}: parent {p} is erased")
        elif p == k:
            problems.append(f"kf {k}: self-parent")
    if problems:
        raise EssentialGraphError("; ".join(problems[:5]))

    # 2) acyclic: walking parents from every node terminates at a root
    depth = np.full(n, -1, np.int64)
    for k in np.nonzero(valid)[0]:
        seen = set()
        cur = int(k)
        while cur >= 0:
            if cur in seen:
                raise EssentialGraphError(
                    f"spanning-forest cycle through kf {k} (at {cur})")
            seen.add(cur)
            if len(seen) > n:
                raise EssentialGraphError(f"parent chain from {k} > n")
            nxt = int(parent[cur]) if valid[cur] else -1
            if nxt < 0:
                depth[k] = len(seen)
                break
            cur = nxt

    # 3) per sub-map: parents stay inside the sub-map
    n_roots = 0
    if kf_map is not None:
        kf_map = _np(kf_map)[:n]
        for k in np.nonzero(valid)[0]:
            p = int(parent[k])
            if p >= 0 and kf_map[p] != kf_map[k]:
                raise EssentialGraphError(
                    f"kf {k} (map {kf_map[k]}) has parent {p} in map "
                    f"{kf_map[p]}")
        for mid in np.unique(kf_map[valid]):
            sel = valid & (kf_map == mid)
            roots = [k for k in np.nonzero(sel)[0] if parent[k] < 0]
            if len(roots) == 0:
                raise EssentialGraphError(f"sub-map {mid} has no root")
            n_roots += len(roots)
    else:
        n_roots = int(np.sum(valid & (parent < 0)))
        if np.any(valid) and n_roots == 0:
            raise EssentialGraphError("no root keyframe")

    # 4) associations point at landmark slots in range; associations to
    #    tombstoned landmarks are tolerated but counted
    kf_mp = _np(m.kf_mp[:n])
    mp_valid = _np(m.mp_valid)
    P = mp_valid.shape[0]
    bad_range = (kf_mp != NO_MP) & ((kf_mp < 0) | (kf_mp >= P))
    if bad_range.any():
        k, f = np.argwhere(bad_range)[0]
        raise EssentialGraphError(
            f"kf {k} feature {f}: landmark slot {kf_mp[k, f]} out of range")
    assoc = kf_mp[valid]
    assoc = assoc[assoc >= 0]
    n_dead = int((~mp_valid[assoc]).sum()) if len(assoc) else 0

    # 5) mp_ref_kf points at a keyframe slot in range
    n_mp = int(m.n_mp)
    ref = _np(m.mp_ref_kf[:n_mp])
    alive = mp_valid[:n_mp]
    bad_ref = alive & ((ref < 0) | (ref >= n))
    if bad_ref.any():
        i = int(np.nonzero(bad_ref)[0][0])
        raise EssentialGraphError(
            f"landmark {i}: reference kf {ref[i]} out of range")
    return {"n_kf": int(valid.sum()), "n_roots": n_roots,
            "max_depth": int(depth.max()) if n else 0,
            "dead_assoc": n_dead}
