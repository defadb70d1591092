"""The collaborative run's first merge, replayed from one shared state
through both packages.

    python3 profiling/torch_collab_runs.py --runs 0 --deterministic-runs 1 \\
        --record DIR --dump DUMP                      # on the card: the dump
    python3 profiling/collab_merge_replay.py run DUMP --package port --device cuda \\
        --out card.npz                                # the port on the card
    python profiling/collab_merge_replay.py run DUMP --package port --out port.npz
    python profiling/collab_merge_replay.py run DUMP --package jax --out jax.npz
    python profiling/collab_merge_replay.py compare DUMP jax.npz port.npz [card.npz]

`Dumper` (an on_merge hook of collab_merge_record.MergeRecord) writes, at
the first accepted merge of a run and just before the server applies it,
the server's checkpoint (every MapState array, the database, the agent
books; both packages read it), the host state the checkpoint leaves out
(the books' streaks, gauges and downlink caches, the server's cycle and
epoch counters, the pending associations), the cascade's S, LoopMatch and
RANSAC inliers, and both clients' whole state (their maps, tracking state
and uplink books) into DUMP.

`run` loads the dump into one package's CollabServer and two
CollabClients (synthetic_mono, the run's seed) and replays from the same
S, snapshotting after each stage:
  loaded      the state as loaded;
  merge_maps  the server's _merge_maps(kf_cur, kf_cand, S);
  fuse_weld   the accepted cascade's landmark fusion and the welding BA on
              both sides of the seam (the server's fuse_and_weld);
  accept      the rest of the acceptance: the cross-agent fuse, the
              redirects, the corrected-pose locks, the event GBA started
              (20 steps, 40 CG iterations);
  gba         the GBA's steps and its adoption (one step a poll, the
              deterministic schedule), no ingest in between;
  downlink    the rest of the server's cycle and its downlink;
  clients     each client's comm_cycle (_ingest_corrections and uplink);
  track1..N   the next N frames (10): both clients track, comm_cycle, and
              the server's comm_cycle with its deterministic flag.
--reference-gba-rows gives the port's server the JAX server's global-BA
rows (observations of invalid landmarks kept; the port masks them on
purpose, ROADMAP C item 7), so the stages after the GBA can be held
against the reference's too.
Each snapshot holds the arena's and both clients' keyframe poses and
landmarks, their validity, each client's live pose and every frame's
inliers on own and foreign landmarks; `--out` writes them to an npz.

`compare A B [C]` prints one JSON line a stage: the largest difference of
the keyframe centres and of the landmarks between A and B (valid in both;
landmarks also at the 99th percentile; a client's own keyframes and landmarks
only, as foreign copies take their slots in downlink order) in metres (map units times the
ground-truth alignment's scale of A's arena or client map), the count of
keyframes and landmarks valid in one only, the live poses' difference, and
agent 1's own-landmark inliers of each; with C, the same between B and C
beside it (the port on the CPU against the card: float32 order of
summation). The JAX package draws RANSAC hypotheses from jax.random, the
port from torch.Generator: where the replay reaches a cascade (the
server's place recognition during track1..N), their draws differ.
"""

import argparse
import enum
import gzip
import json
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# attributes rebuilt by the constructors (devices, configs, vocabularies,
# generators, caches of device copies)
SKIP_CLIENT = {"transport", "slam", "cfg", "device", "_cam4"}
SKIP_SLAM = {"cfg", "K", "device", "reloc_voc", "loop_closer", "_gen", "_reloc_gen",
             "_rng_key", "_pipe", "_m_stats", "_T_cur_dev", "_T_vel_dev", "_cam4"}
BOOK_EXTRA = ("streak", "streak_cand", "pending_cand", "pending_tries", "gauge_total",
              "gauge_epoch", "last_event_ingest", "erased_mp_out", "f_kf_down", "f_mp_down",
              "mp_down_pos")
SERVER_EXTRA = ("_cycle_count", "_last_gba_ingest", "_arena_epoch", "_last_arena_sig",
                "_downlink_epoch", "_last_cull_ingest")


# ----------------------------------------------------------------------
# packing: the port's objects as numpy, tagged for either package's load
# ----------------------------------------------------------------------
def pack(x):
    import torch
    from multi_orbslam3_tpu_torch import interop
    from multi_orbslam3_tpu_torch.bow.database import KeyframeDatabase
    from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
    from multi_orbslam3_tpu_torch.map.mapstate import MapState
    if isinstance(x, MapState):
        return {"__packed__": "map", "v": interop.map_to_numpy(x)}
    if isinstance(x, KeyframeDatabase):
        return {"__packed__": "db", "v": interop.database_to_numpy(x)}
    if isinstance(x, FrameFeatures):
        return {"__packed__": "feats", "v": interop.features_to_numpy(x)}
    if isinstance(x, torch.Tensor):
        return {"__packed__": "t", "v": x.detach().cpu().numpy()}
    if isinstance(x, (torch.Generator, torch.cuda.Event)):
        return None
    if isinstance(x, enum.Enum):
        return {"__packed__": "enum", "v": x.name}
    if isinstance(x, dict):
        return {k: pack(v) for k, v in x.items()}
    if isinstance(x, list):
        return [pack(v) for v in x]
    if isinstance(x, tuple):
        return tuple(pack(v) for v in x)
    return x


def unpack(x, pkg: str, device):
    if isinstance(x, dict) and "__packed__" in x:
        kind, v = x["__packed__"], x["v"]
        if pkg == "port":
            import torch
            from multi_orbslam3_tpu_torch import interop
            from multi_orbslam3_tpu_torch.pipeline.system import TrackState
            if kind == "map":
                return interop.map_from_numpy(v, device)
            if kind == "db":
                return interop.database_from_numpy(v, device)
            if kind == "feats":
                return interop.features_from_numpy(v, device)
            if kind == "t":
                return torch.from_numpy(np.ascontiguousarray(v)).to(device)
            return TrackState[v]
        import jax.numpy as jnp
        from multi_orbslam3_tpu.bow.database import KeyframeDatabase
        from multi_orbslam3_tpu.frontend.extractor import FrameFeatures
        from multi_orbslam3_tpu.map.mapstate import MapState
        from multi_orbslam3_tpu.pipeline.system import TrackState
        klass = {"map": MapState, "db": KeyframeDatabase, "feats": FrameFeatures}
        if kind in klass:
            return klass[kind](**{f: jnp.asarray(v[f]) for f in klass[kind]._fields})
        if kind == "t":
            return jnp.asarray(v)
        return TrackState[v]
    if isinstance(x, dict):
        return {k: unpack(v, pkg, device) for k, v in x.items()}
    if isinstance(x, list):
        return [unpack(v, pkg, device) for v in x]
    if isinstance(x, tuple):
        return tuple(unpack(v, pkg, device) for v in x)
    return x


def client_state(cl) -> dict:
    """A client's attributes and its slam's, packed (the recorder's hooks,
    instance functions, left out)."""
    return {"client": {k: pack(v) for k, v in vars(cl).items()
                       if k not in SKIP_CLIENT and not callable(v)},
            "slam": {k: pack(v) for k, v in vars(cl.slam).items()
                     if k not in SKIP_SLAM and not callable(v)}}


def load_client(cl, st: dict, pkg: str, device) -> None:
    for k, v in st["client"].items():
        setattr(cl, k, unpack(v, pkg, device))
    for k, v in st["slam"].items():
        v = unpack(v, pkg, device)
        if k == "_pending_map" and v is not None:
            v = tuple(v[:4]) + ((None,) if pkg == "port" else ())
        setattr(cl.slam, k, v)


class Dumper:
    """on_merge hook of MergeRecord: dump the state at the first merge."""

    def __init__(self, out_dir: str, seed: int):
        self.out_dir, self.seed, self.done = out_dir, seed, False

    def __call__(self, server, clients, kf_cur, kf_cand, S, casc, cycle):
        if self.done:
            return
        self.done = True
        os.makedirs(self.out_dir, exist_ok=True)
        server.save_checkpoint(os.path.join(self.out_dir, "server.npz"))
        t = lambda x: x.detach().cpu().numpy()  # noqa: E731
        state = {
            "seed": self.seed, "cycle": int(cycle), "kf_cur": int(kf_cur),
            "kf_cand": int(kf_cand), "device": str(server.device),
            "S": {"s": t(S.s), "R": t(S.R), "t": t(S.t)},
            "lm": {f: t(getattr(casc.lm, f)) for f in casc.lm._fields},
            "inliers": t(casc.inliers), "n_proj": int(casc.n_proj),
            "gba_inflight": server._gba_inflight is not None,
            "server": {k: pack(getattr(server, k)) for k in SERVER_EXTRA if hasattr(server, k)},
            "pending_assoc": pack(server._pending_assoc),
            "books": {a: {f: pack(getattr(b, f)) for f in BOOK_EXTRA if hasattr(b, f)}
                      for a, b in server.agents.items()},
            "clients": [client_state(cl) for cl in clients],
        }
        with gzip.open(os.path.join(self.out_dir, "state.pkl.gz"), "wb") as f:
            pickle.dump(state, f)
        print(json.dumps({"phase": "dump", "dir": self.out_dir, "cycle": int(cycle),
                          "kf_cur": int(kf_cur), "kf_cand": int(kf_cand)}), flush=True)


# ----------------------------------------------------------------------
# replay
# ----------------------------------------------------------------------
def _modules(pkg: str) -> dict:
    if pkg == "port":
        from multi_orbslam3_tpu_torch import config
        from multi_orbslam3_tpu_torch.collab.client import CollabClient
        from multi_orbslam3_tpu_torch.collab.server import CollabServer
        from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
        from multi_orbslam3_tpu_torch.dataio import synthetic
        from multi_orbslam3_tpu_torch.geometry import sim3
        from multi_orbslam3_tpu_torch.map import mapstate as ms
        from multi_orbslam3_tpu_torch.pipeline import loop_closing
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_default_matmul_precision", "highest")
        from multi_orbslam3_tpu import config
        from multi_orbslam3_tpu.collab.client import CollabClient
        from multi_orbslam3_tpu.collab.server import CollabServer
        from multi_orbslam3_tpu.collab.transport import InProcessTransport
        from multi_orbslam3_tpu.dataio import synthetic
        from multi_orbslam3_tpu.geometry import sim3
        from multi_orbslam3_tpu.map import mapstate as ms
        from multi_orbslam3_tpu.pipeline import loop_closing
    return dict(config=config, Client=CollabClient, Server=CollabServer,
                Transport=InProcessTransport, synthetic=synthetic, sim3=sim3, ms=ms,
                lc=loop_closing)


def _arr(pkg: str, a, device):
    if pkg == "port":
        import torch
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    import jax.numpy as jnp
    return jnp.asarray(a)


def bench_setup(M, seed: int):
    """bench_collab's config, sequences and arena (the dump's run)."""
    c = M["config"].synthetic_mono()
    seqs = [M["synthetic"].make_sequence(c, n_frames=150, n_points=1200, seed=seed,
                                         trajectory="circle", phase=1.1 + 0.55 * a,
                                         arc=2.3 * np.pi) for a in range(2)]
    return c, seqs, {}


def build(dump_dir: str, pkg: str, device=None, setup=bench_setup):
    """Both clients and the server of one package, loaded from the dump;
    setup(modules, seed) -> (config, sequences, CollabServer kwargs)."""
    with gzip.open(os.path.join(dump_dir, "state.pkl.gz"), "rb") as f:
        state = pickle.load(f)
    M = _modules(pkg)
    dev = {"device": device} if pkg == "port" else {}
    c, seqs, server_kw = setup(M, state["seed"])
    tr = M["Transport"]()
    server = M["Server"](c, tr, n_agents=2, **server_kw, **dev)
    server.load_checkpoint(os.path.join(dump_dir, "server.npz"))
    for k, v in state["server"].items():
        setattr(server, k, unpack(v, pkg, device))
    server._pending_assoc = unpack(state["pending_assoc"], pkg, device)
    for a, extra in state["books"].items():
        for k, v in extra.items():
            setattr(server.agents[a], k, unpack(v, pkg, device))
    server.deterministic = True
    clients = [M["Client"](c, a, tr, **dev) for a in range(2)]
    for cl, st in zip(clients, state["clients"]):
        load_client(cl, st, pkg, device)
    return M, state, server, clients, seqs


def snapshot(server, clients, logs) -> dict:
    import collab_merge_record as cmr
    h = cmr.to_host
    m = server.m
    out = {"srv.kf_valid": h(m.kf_valid), "srv.kf_pose": h(m.kf_pose),
           "srv.kf_agent": h(m.kf_agent), "srv.kf_ts": h(m.kf_timestamp),
           "srv.mp_valid": h(m.mp_valid), "srv.mp_pos": h(m.mp_pos),
           "srv.kf_map": np.asarray(server.kf_map).copy()}
    for a, cl in enumerate(clients):
        cm = cl.slam.m
        out.update({f"c{a}.kf_valid": h(cm.kf_valid), f"c{a}.kf_pose": h(cm.kf_pose),
                    f"c{a}.kf_ts": h(cm.kf_timestamp), f"c{a}.mp_valid": h(cm.mp_valid),
                    f"c{a}.mp_pos": h(cm.mp_pos),
                    f"c{a}.foreign_kf": np.asarray(cl._is_foreign_kf).copy(),
                    f"c{a}.foreign_mp": np.asarray(cl._is_foreign_mp).copy(),
                    f"c{a}.T_cur": np.asarray(cl.slam.T_cur, np.float64),
                    f"c{a}.inliers": np.asarray(logs[a], np.int64).reshape(-1, 3)})
    return out


def reference_gba_rows(server) -> None:
    """The JAX server's global-BA rows on the port's server: observations
    of invalid landmarks kept, as the reference keeps them (the port masks
    them, a deliberate difference: ROADMAP C item 7). Shows the rest of the
    port's GBA against the reference's."""
    inner = server._assemble_gba

    def assemble():
        obs, K_obs, fixed, inert, pfix = inner()
        m = server.m
        raw = m.kf_mp.reshape(-1)
        valid = (raw >= 0) & m.kf_feat_valid.reshape(-1) \
            & m.kf_valid.repeat_interleave(m.kf_mp.shape[1])
        return obs._replace(valid=valid), K_obs, fixed, inert, pfix
    server._assemble_gba = assemble


def replay(dump_dir: str, pkg: str, device=None, frames: int = 10, log=print,
           until: str = None, setup=bench_setup, reference_rows: bool = False) -> dict:
    """The stages (module doc) through `until` (a stage name; None: all);
    reference_rows: the port's server takes the JAX server's GBA rows."""
    import time
    import torch_collab_runs as tcr
    M, st, server, clients, seqs = build(dump_dir, pkg, device, setup)
    if reference_rows:
        reference_gba_rows(server)
    logs = [[] for _ in clients]
    for cl, lg in zip(clients, logs):
        tcr._count_inliers(cl, lg)
    S = M["sim3"].Sim3(R=_arr(pkg, st["S"]["R"], device), t=_arr(pkg, st["S"]["t"], device),
                       s=_arr(pkg, st["S"]["s"], device))
    ok = st["lm"]["valid"] & st["inliers"]
    snaps, t0 = {}, time.perf_counter()

    class Done(Exception):
        pass

    def stage(name):
        snaps[name] = snapshot(server, clients, logs)
        log(json.dumps({"stage": name, "package": pkg, "s": round(time.perf_counter() - t0, 2)}))
        if name == until:
            raise Done

    try:
        _stages(pkg, device, M, st, server, clients, seqs, S, ok, frames, stage)
    except Done:
        pass
    snaps["__meta__"] = {"stats": np.frombuffer(json.dumps(
        {k: v for k, v in server.stats.items() if isinstance(v, (int, float))}).encode(),
        np.uint8)}
    return snaps


def _stages(pkg, device, M, st, server, clients, seqs, S, ok, frames, stage) -> None:
    import collab_merge_record as cmr
    kf_cur, kf_cand = st["kf_cur"], st["kf_cand"]
    lm = st["lm"]

    stage("loaded")
    server._merge_maps(kf_cur, kf_cand, S)
    server.stats["merges"] += 1
    stage("merge_maps")
    cur = _arr(pkg, np.where(ok, lm["cur_mp"], -1).astype(np.int32), device)
    cand = _arr(pkg, np.where(ok, lm["cand_mp"], -1).astype(np.int32), device)
    server.m = M["ms"].replace_mappoint(server.m, cur, cand)
    c = server.cfg
    for seam_kf in (kf_cur, kf_cand):
        server.m = M["lc"].weld_after_merge(
            server.m, seam_kf, server.K, width=c.camera.width, height=c.camera.height,
            scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels)
    stage("fuse_weld")
    book = server.agents[int(cmr.to_host(server.m.kf_agent)[kf_cur])]
    book.streak, book.streak_cand = 0, -1
    book.last_event_ingest = server.stats["kf_ingested"]
    server._cross_agent_fuse(int(server.kf_map[kf_cur]))
    server._follow_redirects()
    server._mark_corrected_and_lock()
    server.abort_global_ba()
    if server._gba_guard_ok():
        server.start_global_ba_async(iters=20, cg_iters=40)
        server._last_gba_ingest = server.stats["kf_ingested"]
    stage("accept")
    while server._gba_inflight is not None:
        server._poll_gba()
    stage("gba")
    server._cycle_count = getattr(server, "_cycle_count", 0) + 1
    if server._cycle_count % 8 == 0:
        server._cull()
    sig = tuple(server.stats.get(k, 0) for k in (
        "kf_ingested", "mp_ingested", "kf_upd_ingested", "mp_upd_ingested", "merges", "loops",
        "gba_runs", "kf_culled", "mp_culled", "gauge_applied"))
    if sig != getattr(server, "_last_arena_sig", None):
        server._arena_epoch = getattr(server, "_arena_epoch", 0) + 1
        server._last_arena_sig = sig
    server._downlink()
    stage("downlink")
    for cl in clients:
        cl.comm_cycle()
    stage("clients")
    for j in range(frames):
        f = st["cycle"] + 1 + j
        if f >= len(seqs[0].timestamps):
            break
        for a, cl in enumerate(clients):
            cl.process_frame(seqs[a].images[f], float(seqs[a].timestamps[f]))
            cl.comm_cycle()
        server.comm_cycle()
        stage(f"track{j + 1}")


def save(snaps: dict, path: str) -> None:
    np.savez_compressed(path, **{f"{s}/{k}": v for s, d in snaps.items() for k, v in d.items()})


def load(path: str) -> dict:
    out = {}
    with np.load(path) as z:
        for key in z.files:
            s, k = key.split("/", 1)
            out.setdefault(s, {})[k] = z[key]
    return out


# ----------------------------------------------------------------------
# comparison
# ----------------------------------------------------------------------
def _centres(pose):
    return np.einsum("nji,nj->ni", -pose[:, :3, :3], pose[:, :3, 3].astype(np.float64))


def _metres(snap: dict, prefix: str, seqs) -> float:
    """Metres per map unit: the scale of the map's ground-truth alignment
    (own keyframes of a client; the arena's keyframes)."""
    import collab_merge_record as cmr
    valid = snap[f"{prefix}.kf_valid"].astype(bool)
    if prefix == "srv":
        agent = snap["srv.kf_agent"]
    else:
        valid &= ~snap[f"{prefix}.foreign_kf"].astype(bool)
        agent = np.full(len(valid), int(prefix[1:]))
    sel = np.nonzero(valid)[0]
    A = cmr.align_to_gt({"pose": snap[f"{prefix}.kf_pose"], "ts": snap[f"{prefix}.kf_ts"],
                         "agent": agent}, sel, seqs)
    return float("nan") if A is None else A["s"]


def diff(A: dict, B: dict, seqs=None) -> dict:
    """One stage's differences between two snapshots, in metres by A's
    ground-truth scale (map units without seqs)."""
    out = {}
    for p in ("srv", "c0", "c1"):
        s = 1.0 if seqs is None else _metres(A, p, seqs)
        kv = A[f"{p}.kf_valid"].astype(bool)
        kw = B[f"{p}.kf_valid"].astype(bool)
        if p != "srv":
            # a client's own keyframes and landmarks: foreign copies take
            # their slots in downlink order, which differs between runs
            kv = kv & ~A[f"{p}.foreign_kf"].astype(bool)
            kw = kw & ~B[f"{p}.foreign_kf"].astype(bool)
        both = kv & kw
        dk = np.linalg.norm(_centres(A[f"{p}.kf_pose"][both]) - _centres(B[f"{p}.kf_pose"][both]),
                            axis=1) * s
        mv = A[f"{p}.mp_valid"].astype(bool)
        mw = B[f"{p}.mp_valid"].astype(bool)
        if f"{p}.foreign_mp" in A and f"{p}.foreign_mp" in B:
            mv = mv & ~A[f"{p}.foreign_mp"].astype(bool)
            mw = mw & ~B[f"{p}.foreign_mp"].astype(bool)
        mb = mv & mw
        dm = np.linalg.norm(A[f"{p}.mp_pos"][mb].astype(np.float64)
                            - B[f"{p}.mp_pos"][mb], axis=1) * s
        out[p] = {"kf_max_m": float(dk.max()) if len(dk) else 0.0,
                  "mp_max_m": float(dm.max()) if len(dm) else 0.0,
                  "mp_p99_m": float(np.percentile(dm, 99)) if len(dm) else 0.0,
                  "kf_valid_xor": int((kv ^ kw).sum()), "mp_valid_xor": int((mv ^ mw).sum()),
                  "n_kf": int(kv.sum()), "n_mp": int(mv.sum())}
        if p != "srv":
            out[p]["live_m"] = float(np.linalg.norm(
                _centres(A[f"{p}.T_cur"][None]) - _centres(B[f"{p}.T_cur"][None])) * s)
    for tag, X in (("a", A), ("b", B)):
        inl = X["c1.inliers"]
        out[f"a1_own_inliers_{tag}"] = int(inl[-1, 1]) if len(inl) else None
    return out


# limits set before the replay ran (PERF.md §6, PR 12): metres at bench
# scale, the largest difference of the keyframe centres / landmarks
LIMITS = {"loaded": (0.0, 0.0), "merge_maps": (1e-4, 1e-4), "fuse_weld": (1e-3, 1e-3),
          "accept": (1e-3, 1e-3), "gba": (5e-3, 1e-2), "downlink": (5e-3, 1e-2),
          "clients": (5e-3, 1e-2), "track": (1e-2, 2e-2)}


def compare(dump_dir: str, paths: list) -> int:
    with gzip.open(os.path.join(dump_dir, "state.pkl.gz"), "rb") as f:
        seed = pickle.load(f)["seed"]
    sys.modules.pop("jax", None)
    from multi_orbslam3_tpu_torch import config
    from multi_orbslam3_tpu_torch.dataio import synthetic
    c = config.synthetic_mono()
    seqs = [synthetic.make_sequence(c, n_frames=150, n_points=1200, seed=seed,
                                    trajectory="circle", phase=1.1 + 0.55 * a,
                                    arc=2.3 * np.pi) for a in range(2)]
    runs = [load(p) for p in paths]
    first_fault = None
    for name in [s for s in runs[0] if s != "__meta__"]:
        if not all(name in r for r in runs):
            continue
        d = diff(runs[0][name], runs[1][name], seqs)
        lim = LIMITS["track" if name.startswith("track") else name]
        worst = (max(d[p]["kf_max_m"] for p in ("srv", "c0", "c1")),
                 max(d[p]["mp_p99_m"] for p in ("srv", "c0", "c1")))
        row = {"stage": name, "a_vs_b": d, "limit_kf_m": lim[0], "limit_mp_p99_m": lim[1],
               "beyond": worst[0] > lim[0] or worst[1] > lim[1]}
        if len(runs) > 2:
            d2 = diff(runs[1][name], runs[2][name], seqs)
            row["b_vs_c"] = d2
            own = (max(d2[p]["kf_max_m"] for p in ("srv", "c0", "c1")),
                   max(d2[p]["mp_p99_m"] for p in ("srv", "c0", "c1")))
            # a difference the port's own CPU-against-card difference
            # matches (within 2x) is float32 order of summation
            row["float_order"] = row["beyond"] and worst[0] <= 2 * own[0] + 1e-9 \
                and worst[1] <= 2 * own[1] + 1e-9
        if row["beyond"] and not row.get("float_order") and first_fault is None:
            first_fault = name
        print(json.dumps(row), flush=True)
    print(json.dumps({"first_stage_beyond_limit": first_fault}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("dump")
    r.add_argument("--package", choices=("port", "jax"), default="port")
    r.add_argument("--device", default="cpu")
    r.add_argument("--frames", type=int, default=10)
    r.add_argument("--out", required=True)
    r.add_argument("--reference-gba-rows", action="store_true",
                   help="the port's server keeps the JAX server's GBA rows (reference_gba_rows)")
    c = sub.add_parser("compare")
    c.add_argument("dump")
    c.add_argument("runs", nargs="+")
    args = ap.parse_args()
    if args.cmd == "compare":
        return compare(args.dump, args.runs)
    if args.package == "port" and args.device == "cpu":
        import torch
        torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    snaps = replay(args.dump, args.package, args.device if args.package == "port" else None,
                   args.frames, reference_rows=args.reference_gba_rows)
    save(snaps, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
