"""profiling/collab_merge_replay.py on the CPU: one small merge state,
built on the port's server from handcrafted uplinks (as
tests/test_torch_collab_server.py builds its arenas), dumped by the
replay's Dumper with the cascade's S, LoopMatch and inliers, loaded into
both packages' servers and clients, and replayed through `_merge_maps` and
`fuse_and_weld` (landmark fusion and the welding BA on both sides of the
seam). Each stage is held to the replay's limits (LIMITS, here in the
world's metres).

The state: 60 world points seen by two agents' 12 keyframes each (0.3 px
of pixel noise, 1 cm on the landmarks), agent 1's map the world under a
known Sim3 (p_1 = S(p_0), the cascade's p_cur ~ S(p_cand)), 40 of the
points paired between the agents' landmarks."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "profiling"))
import collab_merge_replay as cmr  # noqa: E402

from multi_orbslam3_tpu_torch import config as tcfg  # noqa: E402
from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer, protocol  # noqa: E402
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport  # noqa: E402
from multi_orbslam3_tpu_torch.geometry import sim3  # noqa: E402
from multi_orbslam3_tpu_torch.pipeline import loop_closing  # noqa: E402

torch.set_num_threads(2)
N_FEAT, N_KF, N_PTS, N_PAIRED = 256, 12, 60, 40
ARENA = {"arena_kf": 32, "arena_mp": 512}


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def true_sim3():
    return 1.3, _rot_z(0.2), np.array([0.4, -0.2, 0.1])


def world(rng):
    pts = np.stack([rng.uniform(-1.0, 3.2, N_PTS), rng.uniform(-1.0, 1.0, N_PTS),
                    rng.uniform(4.0, 7.0, N_PTS)], 1)
    desc = rng.randint(0, 2 ** 32, (N_PTS, 8), dtype=np.uint64).astype(np.uint32)
    return pts, desc


def camera_poses(agent):
    """World-to-camera poses of an agent's keyframes in the world's frame:
    a sideways track, looking down +z."""
    T = np.tile(np.eye(4), (N_KF, 1, 1))
    for k in range(N_KF):
        T[k, :3, :3] = _rot_z(0.01 * k)
        T[k, :3, 3] = [-(0.2 * k + 0.1 * agent), 0.0, 0.0]
    return T


def to_agent_frame(T_w, p_w, agent):
    """Agent 1's map is the world under S: p_1 = s R p + t; its camera
    poses T_1 = T_w o S^-1 with the scale folded into the translation."""
    if agent == 0:
        return T_w, p_w
    s, R, t = true_sim3()
    T = T_w.copy()
    T[:, :3, :3] = T_w[:, :3, :3] @ R.T
    T[:, :3, 3] = s * T_w[:, :3, 3] - np.einsum("kij,j->ki", T[:, :3, :3], t)
    return T, (s * (R @ p_w.T)).T + t


def uplink(agent, cfg, pts, desc, rng):
    cam = cfg.camera
    T_w = camera_poses(agent)
    T, P = to_agent_frame(T_w, pts, agent)
    uv = np.zeros((N_KF, N_FEAT, 2), np.float32)
    fdesc = np.zeros((N_KF, N_FEAT, 8), np.uint32)
    fvalid = np.zeros((N_KF, N_FEAT), bool)
    mp_local = np.full((N_KF, N_FEAT), -1, np.int32)
    for k in range(N_KF):
        pc = (T_w[k, :3, :3] @ pts.T).T + T_w[k, :3, 3]
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        vis = np.nonzero((u > 10) & (u < cam.width - 10) & (v > 10) & (v < cam.height - 10))[0]
        n = len(vis)
        uv[k, :n] = np.stack([u[vis], v[vis]], 1) + 0.3 * rng.randn(n, 2)
        fdesc[k, :n] = desc[vis]
        fvalid[k, :n] = True
        mp_local[k, :n] = vis
    ids = np.arange(N_KF, dtype=np.int32)
    ref_ids = np.stack([ids - 1, ids - 2, ids - 1], 1).astype(np.int32)
    ref_ids[ref_ids < 0] = -1
    T_rel = np.zeros((N_KF, 3, 4, 4), np.float32)
    for k in range(N_KF):
        for r in range(3):
            if ref_ids[k, r] >= 0:
                T_rel[k, r] = T[k] @ np.linalg.inv(T[ref_ids[k, r]])
    P_noisy = P + 0.01 * (1.3 if agent else 1.0) * rng.randn(*P.shape)
    pos_rel = (T[0, :3, :3] @ P_noisy.T).T + T[0, :3, 3]
    kfs = protocol.KFPayload(
        agent=agent, local_id=ids, timestamp=ids * 0.5, ref_ids=ref_ids, T_rel=T_rel,
        T_abs=T.astype(np.float32), is_first=ids == 0, uv=uv, desc=fdesc,
        level=np.zeros((N_KF, N_FEAT), np.int32), angle=np.zeros((N_KF, N_FEAT), np.float32),
        feat_valid=fvalid, mp_local=mp_local)
    mps = protocol.MPPayload(agent=agent, local_id=np.arange(N_PTS, dtype=np.int32),
                             ref_kf_local=np.zeros(N_PTS, np.int32),
                             pos_rel=pos_rel.astype(np.float32),
                             pos_abs=P_noisy.astype(np.float32), desc=desc)
    return protocol.MapDelta(agent=agent, seq=1, kfs=kfs, mps=mps, closest_kf=N_KF - 1,
                             cam=np.asarray([cam.fx, cam.fy, cam.cx, cam.cy], np.float32))


def setup(M, seed):
    return M["config"].small_synthetic(), None, dict(ARENA)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """The merge state on the port's server, dumped as at a merge."""
    cfg = tcfg.small_synthetic()
    rng = np.random.RandomState(7)
    pts, desc = world(rng)
    tr = InProcessTransport()
    server = CollabServer(cfg, tr, n_agents=2, device="cpu", **ARENA)
    for a in (0, 1):
        d = protocol.MapDelta.from_bytes(uplink(a, cfg, pts, desc, rng).to_bytes())
        server._ingest_delta(a, d)
    server._resolve_pending_assoc()
    clients = [CollabClient(cfg, a, tr, device="cpu") for a in (0, 1)]
    b0, b1 = server.agents[0], server.agents[1]
    P = server.m.max_mp
    cur = np.full(P, -1, np.int32)
    cand = np.full(P, -1, np.int32)
    for j in rng.choice(N_PTS, N_PAIRED, replace=False):
        cur[b1.mp_l2s[int(j)]] = b0.mp_l2s[int(j)]
    valid = cur >= 0
    cand[valid] = cur[valid]
    cur[valid] = np.nonzero(valid)[0]
    lm = loop_closing.LoopMatch(
        cur_mp=torch.from_numpy(cur), cand_mp=torch.from_numpy(cand),
        valid=torch.from_numpy(valid), cur_region=torch.from_numpy(valid),
        cand_region=torch.from_numpy(np.isin(np.arange(P), cand[valid])))
    s, R, t = true_sim3()
    S = sim3.Sim3(R=torch.tensor(R, dtype=torch.float32), t=torch.tensor(t, dtype=torch.float32),
                  s=torch.tensor(s, dtype=torch.float32))
    casc = loop_closing.CascadeResult(ok=True, S=S, lm=lm, inliers=torch.from_numpy(valid),
                                      n_proj=N_PAIRED)
    out = str(tmp_path_factory.mktemp("merge_dump"))
    cmr.Dumper(out, seed=0)(server, clients, b1.kf_l2s[N_KF - 1], b0.kf_l2s[N_KF // 2], S, casc,
                            cycle=0)
    return out


@pytest.fixture(scope="module")
def replays(dump):
    return {pkg: cmr.replay(dump, pkg, "cpu" if pkg == "port" else None, until="fuse_weld",
                            log=lambda *_: None, setup=setup) for pkg in ("jax", "port")}


@pytest.mark.parametrize("stage", ["loaded", "merge_maps", "fuse_weld"])
def test_replay_stage_within_its_limit(replays, stage):
    d = cmr.diff(replays["jax"][stage], replays["port"][stage])["srv"]
    lim_kf, lim_mp = cmr.LIMITS[stage]
    assert d["n_kf"] == 2 * N_KF
    assert d["kf_valid_xor"] == 0 and d["mp_valid_xor"] == 0, d
    assert d["kf_max_m"] <= lim_kf and d["mp_p99_m"] <= lim_mp, d


def test_the_merge_moves_agent_1_onto_the_world(replays):
    """After _merge_maps by the true Sim3 agent 1's keyframes sit on their
    world centres (both packages), and the welding fused the paired
    landmarks (fewer valid landmarks after fuse_and_weld)."""
    for pkg, snaps in replays.items():
        snap = snaps["merge_maps"]
        sel = snap["srv.kf_valid"] & (snap["srv.kf_agent"] == 1)
        T = snap["srv.kf_pose"][sel].astype(np.float64)
        got = np.einsum("nji,nj->ni", -T[:, :3, :3], T[:, :3, 3])
        T_w = camera_poses(1)
        want = np.einsum("nji,nj->ni", -T_w[:, :3, :3], T_w[:, :3, 3])
        assert np.abs(got - want).max() < 1e-3, pkg
        n_before = int(snaps["merge_maps"]["srv.mp_valid"].sum())
        n_after = int(snaps["fuse_weld"]["srv.mp_valid"].sum())
        assert n_after <= n_before - N_PAIRED, (pkg, n_before, n_after)
