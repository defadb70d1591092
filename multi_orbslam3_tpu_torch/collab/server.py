"""Collaborative server: one shared arena for every agent's keyframes and
landmarks (counterpart of multi_orbslam3_tpu/collab/server.py).

- ONE device-resident arena MapState holds every agent's keyframes and
  landmarks, tagged with a host-side sub-map id per slot; merging two
  agents' maps relabels ids and moves the absorbed sub-map by one batched
  Sim3.
- One shared KeyframeDatabase covers all agents; a query returns same-map
  loop candidates and cross-agent merge candidates at once.
- (agent, local id) -> arena slot maps live on the host, with the 3-deep
  relative-pose fallback chain; unresolvable messages are re-queued.
- Global BA runs time-sliced, one Gauss-Newton step a comm cycle, polled
  for readiness by a CUDA event recorded after each step.
- With inertial agents, every adopted global BA is followed by one joint
  visual-inertial solve over each inertial agent's chain
  (run_full_inertial_ba), on the preintegration windows the clients
  uplink.
- run_global_ba shards the observation list over a list of devices when
  more than one CUDA device is visible or the caller asks
  (opt/global_ba.global_bundle_adjust_sharded).

Random stream: the verification cascade draws from one torch.Generator
seeded 99; the JAX package splits PRNGKey(99) for each cascade. The draws
differ, the outcomes agree.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices, interop
from multi_orbslam3_tpu_torch.bow import database as dbm
from multi_orbslam3_tpu_torch.bow import vocabulary as vocm
from multi_orbslam3_tpu_torch.collab import protocol
from multi_orbslam3_tpu_torch.collab.host import desc_words, fetch
from multi_orbslam3_tpu_torch.collab.transport import Transport
from multi_orbslam3_tpu_torch.config import SystemConfig
from multi_orbslam3_tpu_torch.eval.ate import umeyama_align
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import sim3
from multi_orbslam3_tpu_torch.imu import preintegration as pre
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.opt import global_ba, inertial_ba, inertial_init, local_ba
from multi_orbslam3_tpu_torch.pipeline import culling, local_mapping, loop_closing
from multi_orbslam3_tpu_torch.pipeline.tracking import level_inv_sigma2
from multi_orbslam3_tpu_torch.utils.padding import pow2_len


def _arena_chi2(poses, points, obs, K) -> torch.Tensor:
    """Outlier-bounded mean reprojection chi2 (min(c2, 4 x 5.991) caps each
    observation, so a few gross outliers cannot mask an arc-wide
    degradation while growing outlier mass still registers)."""
    r, _, _, behind = local_ba._obs_terms(poses, points, obs, K)
    c2 = local_ba._chi2(r, obs.inv_sigma2)
    ok = obs.valid & ~behind
    bounded = torch.clamp(c2, max=4.0 * 5.991)
    return torch.sum(torch.where(ok, bounded, 0.0)) / torch.clamp(
        torch.sum(ok.to(torch.int32)), min=1)


def _kf_inlier_counts(poses, points, obs, K, max_kf: int):
    """Per-keyframe (n_valid_obs, n_inlier_obs) at the current geometry
    (chi2 <= 5.991, the two-dof 95% gate)."""
    r, _, _, behind = local_ba._obs_terms(poses, points, obs, K)
    c2 = local_ba._chi2(r, obs.inv_sigma2)
    ok = obs.valid & ~behind
    inl = ok & (c2 <= 5.991)
    kf = obs.kf.long()
    zero = torch.zeros(max_kf, dtype=torch.int32, device=poses.device)
    return (zero.index_add(0, kf, ok.to(torch.int32)),
            zero.index_add(0, kf, inl.to(torch.int32)))


def _compose_g13(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose two [s, R9, t3] gauges: a o b."""
    sa, Ra, ta = float(a[0]), a[1:10].reshape(3, 3), a[10:13]
    sb, Rb, tb = float(b[0]), b[1:10].reshape(3, 3), b[10:13]
    return np.concatenate([np.asarray([sa * sb]), (Ra @ Rb).reshape(9),
                           sa * (Ra @ tb) + ta])


@dataclasses.dataclass
class AgentBook:
    """Per-agent bookkeeping (the ClientHandler analog, minus threads)."""
    kf_l2s: Dict[int, int] = dataclasses.field(default_factory=dict)
    mp_l2s: Dict[int, int] = dataclasses.field(default_factory=dict)
    map_id: int = -1
    inertial: bool = False
    last_kf_slot: int = -1
    closest_kf: int = -1
    streak_cand: int = -1
    streak: int = 0
    # Sim3-continuity retry of a candidate that passed RANSAC only
    pending_cand: int = -1
    pending_tries: int = 0
    pending: List[bytes] = dataclasses.field(default_factory=list)
    dirty_kfs: List[int] = dataclasses.field(default_factory=list)
    erased_out: List[int] = dataclasses.field(default_factory=list)
    # own landmarks culled here, queued for the owner's downlink (local ids)
    erased_mp_out: List[int] = dataclasses.field(default_factory=list)
    # exact cumulative gauge of every merge Sim3 applied to this agent's
    # sub-map, [s, R9, t3], shipped with an epoch on every downlink
    gauge_total: Optional[np.ndarray] = None
    gauge_epoch: int = 0
    # foreign entities already shipped in full to this client
    sent_foreign_kf: set = dataclasses.field(default_factory=set)
    sent_foreign_mp: set = dataclasses.field(default_factory=set)
    # reliability: in-order delivery, cumulative ack, erasure tombstones
    next_seq: int = 1
    ooo: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    erased_kf_tomb: set = dataclasses.field(default_factory=set)
    erased_mp_tomb: set = dataclasses.field(default_factory=set)
    # camera->body extrinsics and pinhole intrinsics of this agent
    T_bc: Optional[np.ndarray] = None
    cam: Optional[np.ndarray] = None
    # revocations of culled foreign content this client had received
    foreign_erased_kf_out: List[int] = dataclasses.field(default_factory=list)
    foreign_erased_mp_out: List[int] = dataclasses.field(default_factory=list)
    # positions last sent to this client (bounds the landmark updates to
    # those that moved)
    mp_down_pos: Optional[np.ndarray] = None
    corrections_pending: bool = False
    # pose/position last shipped for each already-sent foreign entity
    f_kf_down: Optional[np.ndarray] = None
    f_mp_down: Optional[np.ndarray] = None


class CollabServer:
    """The shared-arena server. ``device=None`` is the CUDA device and
    raises where there is none; the CPU tests pass ``device="cpu"``."""

    def __init__(self, config: SystemConfig, transport: Transport, n_agents: int,
                 vocabulary=None, arena_kf: Optional[int] = None,
                 arena_mp: Optional[int] = None, device=None):
        self.device = devices.resolve(device, "CollabServer")
        self.cfg = config
        self.transport = transport
        self.n_agents = n_agents
        self.K = cam.intrinsics_from_config(config.camera, self.device)
        max_kf = arena_kf or config.map.max_keyframes * n_agents
        max_mp = arena_mp or config.map.max_mappoints * n_agents
        self.m = ms.empty_map(max_kf, max_mp, config.orb.n_features, self.device)
        self.kf_map = np.full(max_kf, -1, np.int32)     # sub-map id per slot
        self.mp_map = np.full(max_mp, -1, np.int32)
        # landmarks a GBA / pose-graph correction placed: the owner's window
        # BA refinements must not overwrite them
        self.mp_locked = np.zeros(max_mp, bool)
        self.kf_local = np.full(max_kf, -1, np.int32)   # sender-local id
        # uplinked IMU row per slot: flat preintegration + body velocity
        self.kf_imu = np.zeros((max_kf, pre.FLAT_DIM + 3), np.float32)
        self.voc = vocabulary if vocabulary is not None else vocm.default_vocabulary(
            config.bow.branching, config.bow.levels, device=self.device)
        self.db = dbm.KeyframeDatabase.empty(max_kf, device=self.device)
        self.agents = {a: AgentBook() for a in range(n_agents)}
        self._next_map_id = 0
        self._pending_assoc: List[tuple] = []
        self._orphan_preint: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(99)
        self._pr_queue: List[Tuple[int, int]] = []      # (agent, kf_slot)
        self._gba_inflight = None
        self._last_gba_ingest = 0
        # one GBA step a comm cycle and adoption on a fixed cycle (tests);
        # the default polls the device for realtime overlap
        self.deterministic = False
        self._cycle_count = 0
        self._arena_epoch = 0
        self._last_arena_sig = None
        self._downlink_epoch = -1
        self._last_cull_ingest = None
        self.stats = {"kf_ingested": 0, "mp_ingested": 0, "merges": 0,
                      "loops": 0, "dropped_kf": 0, "gba_runs": 0}

    def _up(self, a) -> torch.Tensor:
        """Host array -> device tensor without stalling the stream."""
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        return fetch({"x": t})["x"]

    # ==================================================================
    # checkpoint / resume: the arena, the inverted file, the per-agent
    # books and reliability state in one npz, with the JAX package's keys
    # and dtypes, so a checkpoint of either package loads in the other
    # ==================================================================
    def save_checkpoint(self, path: str) -> None:
        arrays = {f"map.{n}": a for n, a in interop.map_to_numpy(self.m).items()}
        arrays.update({
            "kf_map": self.kf_map, "mp_map": self.mp_map,
            "mp_locked": self.mp_locked,
            "kf_local": self.kf_local, "kf_imu": self.kf_imu,
            **{f"db.{n}": a for n, a in interop.database_to_numpy(self.db).items()},
        })
        books = {}
        for a, b in self.agents.items():
            books[str(a)] = {
                "kf_l2s": list(b.kf_l2s.items()),
                "mp_l2s": list(b.mp_l2s.items()),
                "map_id": b.map_id, "inertial": b.inertial,
                "last_kf_slot": b.last_kf_slot, "closest_kf": b.closest_kf,
                "dirty_kfs": [int(x) for x in b.dirty_kfs],
                "erased_out": [int(x) for x in b.erased_out],
                "sent_foreign_kf": sorted(int(x) for x in b.sent_foreign_kf),
                "sent_foreign_mp": sorted(int(x) for x in b.sent_foreign_mp),
                "next_seq": b.next_seq,
                "erased_kf_tomb": sorted(int(x) for x in b.erased_kf_tomb),
                "erased_mp_tomb": sorted(int(x) for x in b.erased_mp_tomb),
                "foreign_erased_kf_out": [int(x) for x in b.foreign_erased_kf_out],
                "foreign_erased_mp_out": [int(x) for x in b.foreign_erased_mp_out],
                "corrections_pending": b.corrections_pending,
                "T_bc": None if b.T_bc is None
                else [float(x) for x in b.T_bc.reshape(-1)],
                "cam": None if b.cam is None else [float(x) for x in b.cam],
                # in-flight payloads past the cumulative ack survive
                "n_pending": len(b.pending),
                "ooo_seqs": sorted(b.ooo),
            }
            for i, p in enumerate(b.pending):
                arrays[f"pending.{a}.{i}"] = np.frombuffer(p, np.uint8)
            for seq, p in b.ooo.items():
                arrays[f"ooo.{a}.{seq}"] = np.frombuffer(p, np.uint8)
            if b.mp_down_pos is not None:
                arrays[f"mp_down.{a}"] = b.mp_down_pos
        for a, orphans in self._orphan_preint.items():
            for i, (slot, row) in enumerate(orphans):
                arrays[f"orphan.{a}.{i}.{slot}"] = row
        host = {"books": books, "next_map_id": self._next_map_id,
                "stats": self.stats, "n_agents": self.n_agents}
        arrays["__host__"] = np.frombuffer(json.dumps(host).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        host = json.loads(bytes(data.pop("__host__")).decode())
        fields = {n: data[f"map.{n}"] for n in ms.MapState._fields
                  if f"map.{n}" in data}      # fields added later keep defaults
        current = interop.map_to_numpy(self.m)
        self.m = interop.map_from_numpy({**current, **fields}, self.device)
        self.kf_map = data["kf_map"]
        self.mp_map = data["mp_map"]
        if "mp_locked" in data:
            self.mp_locked = data["mp_locked"]
        self.kf_local = data["kf_local"]
        if "kf_imu" in data:
            self.kf_imu = data["kf_imu"]
        if "db.word" in data:
            self.db = interop.database_from_numpy(
                {n: data[f"db.{n}"] for n in dbm.KeyframeDatabase._fields}, self.device)
        else:
            # a checkpoint of the dense-matrix era: rebuild the rows from
            # the arena's stored descriptors
            active = np.asarray(data["db.active"])
            agents_row = np.asarray(data["db.agent"])
            self.db = dbm.KeyframeDatabase.empty(self.m.max_kf, device=self.device)
            for k in np.nonzero(active)[0]:
                self.db, _ = dbm.add_keyframe_bow(
                    self.db, self.voc, int(k), self.m.kf_desc[int(k)],
                    self.m.kf_feat_valid[int(k)], int(agents_row[k]))
        self._next_map_id = host["next_map_id"]
        self.stats = host["stats"]
        self.agents = {}
        for a_str, bk in host["books"].items():
            b = AgentBook()
            b.kf_l2s = {int(k): int(v) for k, v in bk["kf_l2s"]}
            b.mp_l2s = {int(k): int(v) for k, v in bk["mp_l2s"]}
            b.map_id = bk["map_id"]
            b.inertial = bk["inertial"]
            b.last_kf_slot = bk["last_kf_slot"]
            b.closest_kf = bk["closest_kf"]
            b.dirty_kfs = bk["dirty_kfs"]
            b.erased_out = bk["erased_out"]
            b.sent_foreign_kf = set(bk["sent_foreign_kf"])
            b.sent_foreign_mp = set(bk["sent_foreign_mp"])
            b.next_seq = bk["next_seq"]
            b.erased_kf_tomb = set(bk["erased_kf_tomb"])
            b.erased_mp_tomb = set(bk["erased_mp_tomb"])
            if bk.get("T_bc") is not None:
                b.T_bc = np.asarray(bk["T_bc"], np.float32).reshape(4, 4)
            if bk.get("cam") is not None:
                b.cam = np.asarray(bk["cam"], np.float32)
            b.pending = [bytes(data[f"pending.{a_str}.{i}"])
                         for i in range(bk.get("n_pending", 0))]
            b.ooo = {seq: bytes(data[f"ooo.{a_str}.{seq}"])
                     for seq in bk.get("ooo_seqs", [])}
            b.foreign_erased_kf_out = bk.get("foreign_erased_kf_out", [])
            b.foreign_erased_mp_out = bk.get("foreign_erased_mp_out", [])
            b.corrections_pending = bk.get("corrections_pending", False)
            if f"mp_down.{a_str}" in data:
                b.mp_down_pos = data[f"mp_down.{a_str}"]
            self.agents[int(a_str)] = b
        self._orphan_preint = {}
        for k in data:
            if k.startswith("orphan."):
                _, a_str, _i, slot = k.split(".")
                self._orphan_preint.setdefault(int(a_str), []).append(
                    (int(slot), data[k]))

    # ==================================================================
    # ingest
    # ==================================================================
    def comm_cycle(self, run_gba_on_events: bool = True) -> None:
        """One server cycle: ingest every agent's deltas in order, resolve
        associations, run place recognition on the new keyframes, advance
        the time-sliced GBA, cull every 8th cycle and downlink.

        run_gba_on_events: a full-arena GBA after each accepted loop/merge
        (the reference's default), under the big-map guard, and the
        periodic one every gba_periodic_kfs ingested keyframes."""
        comm = self.cfg.comm
        for a, book in self.agents.items():
            # in-order delivery: stash out-of-order seqs, drop duplicates,
            # release the contiguous run
            for p in self.transport.poll_up(a):
                try:
                    seq = protocol.peek_seq(p)
                except ValueError:
                    self.stats["dropped_frames"] = self.stats.get("dropped_frames", 0) + 1
                    continue
                if seq < book.next_seq:
                    continue                   # duplicate resend
                book.ooo[seq] = p
            while book.next_seq in book.ooo:
                book.pending.append(book.ooo.pop(book.next_seq))
                book.next_seq += 1
            payloads = book.pending
            book.pending = []
            kf_budget = comm.server_kf_bound
            mp_budget = comm.server_mp_bound
            for p in payloads:
                if kf_budget <= 0 and mp_budget <= 0:
                    book.pending.append(p)
                    continue
                try:
                    delta = protocol.MapDelta.from_bytes(p)
                except ValueError:
                    self.stats["dropped_frames"] = self.stats.get("dropped_frames", 0) + 1
                    continue
                used_kf, used_mp = self._ingest_delta(a, delta)
                kf_budget -= used_kf
                mp_budget -= used_mp
        self._resolve_pending_assoc()
        self._run_place_recognition(run_gba=run_gba_on_events)
        self._poll_gba()
        periodic = self.cfg.loop.gba_periodic_kfs
        if run_gba_on_events and periodic > 0 and self._gba_inflight is None \
                and self.stats["kf_ingested"] - self._last_gba_ingest >= periodic \
                and self._gba_guard_ok():
            self.start_global_ba_async(iters=20, cg_iters=40)
            self._last_gba_ingest = self.stats["kf_ingested"]
        self._cycle_count += 1
        if self._cycle_count % 8 == 0 and self._gba_inflight is None:
            # deferred while a GBA is in flight: erasures would invalidate
            # the snapshot the solve runs on
            self._cull()
        # any ingest/correction/cull/gauge event since the last cycle
        # obliges a downlink pass (see _downlink's idle-skip)
        sig = tuple(self.stats.get(k, 0) for k in (
            "kf_ingested", "mp_ingested", "kf_upd_ingested", "mp_upd_ingested",
            "merges", "loops", "gba_runs", "kf_culled", "mp_culled", "gauge_applied"))
        if sig != self._last_arena_sig:
            self._arena_epoch += 1
            self._last_arena_sig = sig
        self._downlink()

    # ------------------------------------------------------------------
    def _ingest_delta(self, agent: int, delta: protocol.MapDelta) -> Tuple[int, int]:
        book = self.agents[agent]
        if delta.closest_kf >= 0:
            book.closest_kf = delta.closest_kf
        book.inertial = book.inertial or delta.inertial
        if delta.T_bc is not None:
            book.T_bc = np.asarray(delta.T_bc, np.float32).reshape(4, 4)
        if delta.cam is not None:
            book.cam = np.asarray(delta.cam, np.float32).reshape(4)
        # the IMU-init gauge handoff comes before payloads whose poses are
        # already post-gauge
        if delta.R_gw is not None or abs(delta.scale - 1.0) > 1e-9:
            self._apply_agent_gauge(agent, delta.scale, delta.R_gw)
        n_kf = n_mp = 0
        if delta.kfs is not None:
            n_kf = self._ingest_kfs(agent, delta.kfs)
        if delta.mps is not None:
            n_mp = self._ingest_mps(agent, delta.mps)
        if delta.kf_updates is not None:
            self._ingest_kf_updates(agent, delta.kf_updates)
        if delta.mp_updates is not None:
            self._ingest_mp_updates(agent, delta.mp_updates)
        if delta.erased_kf is not None:
            for lid in delta.erased_kf:
                book.erased_kf_tomb.add(int(lid))
                slot = book.kf_l2s.get(int(lid))
                if slot is not None:
                    self._merge_preint_forward(int(slot), agent)
                    self.m = ms.erase_keyframe(self.m, int(slot))
                    self.db = dbm.erase_keyframe_bow(self.db, int(slot))
        if delta.erased_mp is not None:
            book.erased_mp_tomb.update(int(l) for l in delta.erased_mp)
            slots = [book.mp_l2s.get(int(l), -1) for l in delta.erased_mp]
            if slots:
                self.m = ms.erase_mappoints(self.m, self._up(np.asarray(slots, np.int32)))
        return n_kf, n_mp

    def _ingest_kfs(self, agent: int, kfs: protocol.KFPayload) -> int:
        """Batched keyframe ingest: the host resolves identities and the
        relative-pose fallback chain, then one batched insert writes every
        accepted keyframe and one batched BoW insert fills the database."""
        book = self.agents[agent]
        B = kfs.local_id.shape[0]
        n_kf0 = int(self.m.n_kf)
        kf_pose_host = None         # fetched once per payload, when needed
        accepted = []               # (b, lid, T_abs, parent_slot)
        inbatch = {}                # lid -> position in `accepted`
        for b in range(B):
            lid = int(kfs.local_id[b])
            if lid in book.kf_l2s or lid in book.erased_kf_tomb:
                continue      # duplicate, or erased before it arrived
            T_abs = None
            if bool(kfs.is_first[b]) or book.map_id < 0:
                T_abs = kfs.T_abs[b]
            else:
                for r in range(3):
                    rid = int(kfs.ref_ids[b, r])
                    if rid in inbatch:
                        T_abs = kfs.T_rel[b, r] @ accepted[inbatch[rid]][2]
                        break
                    slot = book.kf_l2s.get(rid)
                    if slot is not None:
                        if kf_pose_host is None:
                            kf_pose_host = self._host(self.m.kf_pose)
                        T_abs = kfs.T_rel[b, r] @ kf_pose_host[slot]
                        break
            if T_abs is None:
                self.stats["dropped_kf"] += 1
                continue
            # step-sanity vetting: a keyframe implying a step many times the
            # agent's running median is a tracking-failure artifact
            steps = getattr(book, "step_hist", None)
            if steps is None:
                steps = book.step_hist = []
            prev_slot = book.last_kf_slot
            step = None
            if prev_slot is not None and prev_slot >= 0:
                if kf_pose_host is None:
                    kf_pose_host = self._host(self.m.kf_pose)
                T_prev = kf_pose_host[prev_slot] if prev_slot < n_kf0 \
                    else accepted[prev_slot - n_kf0][2]
                c_new = -T_abs[:3, :3].T @ T_abs[:3, 3]
                c_prev = -T_prev[:3, :3].T @ T_prev[:3, 3]
                step = float(np.linalg.norm(c_new - c_prev))
                if len(steps) >= 5 and step > 8.0 * max(float(np.median(steps)), 1e-6):
                    self.stats["kf_vetoed"] = self.stats.get("kf_vetoed", 0) + 1
                    book.erased_kf_tomb.add(lid)   # drop resends too
                    continue
            if step is not None:
                steps.append(step)
                if len(steps) > 30:
                    del steps[0]
            if book.map_id < 0:
                book.map_id = self._next_map_id
                self._next_map_id += 1
            pos = len(accepted)
            rid2 = int(kfs.ref_ids[b, 2])
            if rid2 >= 0:
                parent_slot = n_kf0 + inbatch[rid2] if rid2 in inbatch \
                    else book.kf_l2s.get(rid2, -1)
            else:
                parent_slot = book.last_kf_slot
            accepted.append((b, lid, T_abs, parent_slot))
            inbatch[lid] = pos
            book.last_kf_slot = n_kf0 + pos     # provisional slot
        if not accepted:
            return 0
        n = len(accepted)
        sel = np.asarray([a[0] for a in accepted])
        poses = np.stack([a[2] for a in accepted]).astype(np.float32)
        parents = np.asarray([a[3] for a in accepted], np.int32)
        assocs = np.full((n, kfs.mp_local.shape[1]), ms.NO_MP, np.int32)
        cam_row = book.cam if book.cam is not None else np.asarray(
            [self.cfg.camera.fx, self.cfg.camera.fy, self.cfg.camera.cx,
             self.cfg.camera.cy], np.float32)
        desc = desc_words(kfs.desc[sel]).to(self.device)
        fv = self._up(kfs.feat_valid[sel].astype(bool))
        agents = torch.full((n,), agent, dtype=torch.int32, device=self.device)
        self.m, slots = ms.add_keyframes_batch(
            self.m, self._up(poses), self._up(kfs.timestamp[sel].astype(np.float32)),
            agents, self._up(parents), self._up(assocs),
            self._up(kfs.uv[sel].astype(np.float32)), desc,
            self._up(kfs.level[sel].astype(np.int32)),
            self._up(kfs.angle[sel].astype(np.float32)), fv, n,
            cams=self._up(np.tile(cam_row, (n, 1)).astype(np.float32)))
        self.db = dbm.add_keyframes_bow_batch(self.db, self.voc, slots, desc, fv, agents)
        slots_np = self._host(slots)
        count = 0
        for pos, (b, lid, _T, _p) in enumerate(accepted):
            slot_i = int(slots_np[pos])
            if slot_i < 0:            # over capacity
                self.stats["dropped_kf"] += 1
                if book.last_kf_slot == n_kf0 + pos:
                    book.last_kf_slot = -1
                continue
            assert slot_i == n_kf0 + pos    # provisional slots are real
            mp_local_b = np.asarray(kfs.mp_local[b])
            feats_idx = np.nonzero(mp_local_b >= 0)[0].astype(np.int32)
            if len(feats_idx):
                self._pending_assoc.append(
                    (agent, slot_i, feats_idx, mp_local_b[feats_idx].astype(np.int32)))
            # cross-agent observations, already in server slots (agent -1)
            if kfs.mp_server is not None:
                srow = np.asarray(kfs.mp_server[b])
                fidx = np.nonzero(srow >= 0)[0].astype(np.int32)
                if len(fidx):
                    self._pending_assoc.append(
                        (-1, slot_i, fidx, srow[fidx].astype(np.int32)))
            book.kf_l2s[lid] = slot_i
            self.kf_map[slot_i] = book.map_id
            self.kf_local[slot_i] = lid
            if kfs.imu is not None:
                self.kf_imu[slot_i] = kfs.imu[b]
                self._splice_orphan_preints(agent, slot_i)
            self._pr_queue.append((agent, slot_i))
            book.dirty_kfs.append(slot_i)
            self.stats["kf_ingested"] += 1
            count += 1
        return count

    def _ingest_mps(self, agent: int, mps: protocol.MPPayload) -> int:
        book = self.agents[agent]
        pos_list, desc_rows, ref_list, lids = [], [], [], []
        all_poses = None
        for b in range(mps.local_id.shape[0]):
            lid = int(mps.local_id[b])
            if lid in book.mp_l2s or lid in book.erased_mp_tomb:
                continue      # duplicate, or erased before it arrived
            ref_slot = book.kf_l2s.get(int(mps.ref_kf_local[b]))
            if ref_slot is not None:
                # pos_rel is in the reference keyframe's camera frame
                if all_poses is None:
                    all_poses = self._host(self.m.kf_pose)
                p = np.linalg.inv(all_poses[ref_slot]) @ np.append(mps.pos_rel[b], 1.0)
                pos_list.append(p[:3])
                ref_list.append(ref_slot)
            else:
                pos_list.append(mps.pos_abs[b])
                ref_list.append(max(book.last_kf_slot, 0))
            desc_rows.append(b)
            lids.append(lid)
        if not lids:
            return 0
        nb = len(lids)
        self.m, slots = ms.add_mappoints_raw_padded(
            self.m, self._up(np.stack(pos_list).astype(np.float32)),
            torch.ones(nb, dtype=torch.bool, device=self.device),
            desc_words(mps.desc[np.asarray(desc_rows)]).to(self.device),
            self._up(np.asarray(ref_list, np.int32)), agent)
        slots_np = self._host(slots)
        for i, lid in enumerate(lids):
            s = int(slots_np[i])
            if s >= 0:
                book.mp_l2s[lid] = s
                self.mp_map[s] = book.map_id
        self.stats["mp_ingested"] += nb
        return nb

    def _ingest_kf_updates(self, agent: int, ku: protocol.KFUpdatePayload):
        book = self.agents[agent]
        ids, poses = [], []
        locked = self._host(self.m.kf_pose_locked)
        for b, lid in enumerate(ku.local_id):
            if int(lid) in book.erased_kf_tomb:
                continue
            slot = book.kf_l2s.get(int(lid))
            if slot is None:
                continue
            if not bool(locked[slot]):
                ids.append(slot)
                poses.append(ku.T_abs[b])
            # association refresh: the server's observation counts follow
            # the client's fusion, so culling sees each landmark's support
            if ku.mp_local is not None:
                row = np.asarray(ku.mp_local[b])
                feats_idx = np.nonzero(row >= 0)[0].astype(np.int32)
                if len(feats_idx):
                    self._pending_assoc.append(
                        (agent, int(slot), feats_idx, row[feats_idx].astype(np.int32)))
            if ku.mp_server is not None:
                srow = np.asarray(ku.mp_server[b])
                fidx = np.nonzero(srow >= 0)[0].astype(np.int32)
                if len(fidx):
                    self._pending_assoc.append(
                        (-1, int(slot), fidx, srow[fidx].astype(np.int32)))
        if ids:
            self.m = self.m._replace(kf_pose=self.m.kf_pose.index_put(
                (self._up(np.asarray(ids, np.int64)),),
                self._up(np.stack(poses).astype(np.float32))))
            book.dirty_kfs.extend(ids)
            self.stats["kf_upd_ingested"] = self.stats.get("kf_upd_ingested", 0) + len(ids)

    def _ingest_mp_updates(self, agent: int, mu: protocol.MPUpdatePayload):
        book = self.agents[agent]
        ids, poss = [], []
        for b, lid in enumerate(mu.local_id):
            if int(lid) in book.erased_mp_tomb:
                continue
            slot = book.mp_l2s.get(int(lid))
            # a server-placed landmark is not overwritten by the owner
            if slot is not None and not self.mp_locked[slot]:
                ids.append(slot)
                poss.append(mu.pos_abs[b])
        if ids:
            self.m = self.m._replace(mp_pos=self.m.mp_pos.index_put(
                (self._up(np.asarray(ids, np.int64)),),
                self._up(np.stack(poss).astype(np.float32))))
            self.stats["mp_upd_ingested"] = self.stats.get("mp_upd_ingested", 0) + len(ids)

    def _apply_agent_gauge(self, agent: int, scale: float,
                           R_gw: Optional[np.ndarray]) -> None:
        """Re-gauge the server copy of one client's sub-map after its IMU
        initialization: X' = scale R_gw^T X for landmarks, with the
        matching keyframe-pose similarity."""
        book = self.agents[agent]
        if book.map_id < 0:
            return
        R = np.eye(3, dtype=np.float32) if R_gw is None else np.asarray(R_gw, np.float32)
        dev = self.device
        S = sim3.Sim3(R=self._up(np.ascontiguousarray(R.T)),
                      t=torch.zeros(3, device=dev),
                      s=torch.full((), float(scale), dtype=torch.float32, device=dev))
        move_kf = self._up(self.kf_map == book.map_id)
        move_mp = self._up(self.mp_map == book.map_id)
        m = self.m
        mp_pos = torch.where(move_mp[:, None], sim3.apply(S, m.mp_pos), m.mp_pos)
        T_new = sim3.to_se3_scaled(sim3.compose(sim3.from_se3(m.kf_pose), sim3.inverse(S)))
        kf_pose = torch.where(move_kf[:, None, None], T_new, m.kf_pose)
        self.m = m._replace(kf_pose=kf_pose, mp_pos=mp_pos)
        self.stats["gauge_applied"] = self.stats.get("gauge_applied", 0) + 1

    def _resolve_pending_assoc(self) -> None:
        """Resolve deferred keyframe -> landmark associations in bulk: a
        per-agent local-id -> arena-slot lookup array, one scatter for all.
        Where one cell is written twice, the last write wins."""
        if not self._pending_assoc:
            return
        still = []
        upd_kf, upd_f, upd_mp = [], [], []
        lut_cache: Dict[int, np.ndarray] = {}
        cap = self.cfg.map.max_mappoints
        mp_valid_np = None
        for entry in self._pending_assoc:
            agent, kf_slot, feats_idx, mp_local = entry[:4]
            tries = entry[4] if len(entry) > 4 else 0
            if agent < 0:
                # cross-agent rows are arena slots: only live landmarks
                if mp_valid_np is None:
                    mp_valid_np = self._host(self.m.mp_valid)
                sl = np.minimum(mp_local, self.m.max_mp - 1)
                slots = np.where(mp_valid_np[sl], sl, -1).astype(np.int32)
                found = slots >= 0
                if found.any():
                    upd_kf.append(np.full(int(found.sum()), kf_slot, np.int32))
                    upd_f.append(feats_idx[found])
                    upd_mp.append(slots[found])
                continue        # a dead foreign slot stays dead
            lut = lut_cache.get(agent)
            if lut is None:
                l2s = self.agents[agent].mp_l2s
                lut = np.full(cap, -1, np.int32)
                if l2s:
                    keys = np.fromiter(l2s.keys(), np.int64, len(l2s))
                    vals = np.fromiter(l2s.values(), np.int64, len(l2s))
                    ok = keys < cap
                    lut[keys[ok]] = vals[ok]
                lut_cache[agent] = lut
            slots = lut[np.minimum(mp_local, cap - 1)]
            found = slots >= 0
            # unresolved refs retry for a bounded number of cycles
            if (~found).any() and tries < 32:
                still.append((agent, kf_slot, feats_idx[~found], mp_local[~found],
                              tries + 1))
            if found.any():
                upd_kf.append(np.full(int(found.sum()), kf_slot, np.int32))
                upd_f.append(feats_idx[found])
                upd_mp.append(slots[found])
        if upd_kf:
            N = self.m.n_feat
            cell = np.concatenate(upd_kf).astype(np.int64) * N \
                + np.concatenate(upd_f).astype(np.int64)
            vals = np.concatenate(upd_mp).astype(np.int32)
            # last write wins: keep each cell's final entry
            _, first_rev = np.unique(cell[::-1], return_index=True)
            keep = len(cell) - 1 - first_rev
            flat = self.m.kf_mp.reshape(-1).index_put(
                (self._up(cell[keep]),), self._up(vals[keep]))
            self.m = self.m._replace(kf_mp=flat.reshape(self.m.kf_mp.shape))
        self._pending_assoc = still

    # ==================================================================
    # place recognition: loops (same sub-map) and merges (across sub-maps)
    # ==================================================================
    def _map_kf_count(self, valid_np: np.ndarray, slot: int) -> int:
        return int(np.sum(valid_np & (self.kf_map == self.kf_map[slot])))

    def _run_place_recognition(self, run_gba: bool = False) -> None:
        queue, self._pr_queue = self._pr_queue, []
        if not queue:
            return
        valid_np = self._host(self.m.kf_valid)
        lc = self.cfg.loop
        for agent, kf_slot in queue:
            book = self.agents[agent]
            # maturity gate: a merge between immature maps fits a Sim3 on a
            # handful of noisy landmarks
            if self._map_kf_count(valid_np, kf_slot) < lc.min_map_kfs:
                continue
            # fresh own keyframes since the last accepted event
            if self.stats["kf_ingested"] - getattr(book, "last_event_ingest", -10**9) \
                    < lc.event_interval_kfs:
                continue
            covis = self._host(ms.covisibility_row(self.m, kf_slot))
            # connected-group exclusion at the reference's weight-15
            # threshold, scaled to the feature budget
            covis_thr = max(3, round(15 * self.cfg.orb.n_features / 1024))
            exclude = covis >= covis_thr
            exclude[kf_slot] = True
            # this agent's most recent keyframes (temporally adjacent)
            own_recent = (self.kf_local >= 0) & (self._host(self.m.kf_agent) == agent)
            exclude[np.nonzero(own_recent)[0][-10:]] = True
            scores_np = self._host(dbm.query(self.db, self.voc, self.m.kf_desc[kf_slot],
                                             self.m.kf_feat_valid[kf_slot],
                                             self._up(exclude)))
            best = int(np.argmax(scores_np))
            # Sim3 continuity: a candidate that passed RANSAC on an earlier
            # keyframe but missed the projection gate is retried directly
            pending = book.pending_cand
            if pending >= 0 and not valid_np[pending]:
                pending = -1
                book.pending_cand = -1
            if float(scores_np[best]) < lc.min_bow_score and pending < 0:
                book.streak = 0
                book.streak_cand = -1
                continue
            # temporal consistency on the candidate side
            if book.streak_cand >= 0 and best != book.streak_cand:
                cand_covis = self._host(ms.covisibility_row(self.m, best))
                consistent = int(cand_covis[book.streak_cand]) > 0
            else:
                consistent = book.streak_cand >= 0
            book.streak = book.streak + 1 if consistent else 1
            book.streak_cand = best
            if book.streak < lc.consistency_hits and pending < 0:
                continue

            # verification cascade over the N best candidate groups
            if book.streak >= lc.consistency_hits:
                cands = loop_closing.nbest_candidates(
                    self.m, scores_np, n_best=lc.n_candidates, min_score=lc.min_bow_score)
            else:
                cands = []
            if pending >= 0:
                cands = [(pending, float("inf"), None)] + \
                    [c for c in cands if c[0] != pending]
                book.pending_tries = book.pending_tries - 1
                if book.pending_tries <= 0:
                    book.pending_cand = -1
            accepted = False
            for cand_kf, _, _ in cands:
                if self._map_kf_count(valid_np, cand_kf) < lc.min_map_kfs:
                    continue
                casc = loop_closing.verify_candidate_cascade(
                    self.m, kf_slot, cand_kf, self._gen, self.K,
                    width=self.cfg.camera.width, height=self.cfg.camera.height,
                    scale_factor=self.cfg.orb.scale_factor,
                    n_levels=self.cfg.orb.n_levels,
                    min_proj_matches=lc.min_proj_matches)
                if not casc.ok:
                    if casc.S is not None and book.pending_cand < 0:
                        # RANSAC passed, projection short: retry later
                        book.pending_cand = cand_kf
                        book.pending_tries = 3
                    continue
                book.pending_cand = -1
                S_corr, lm, inliers = casc.S, casc.lm, casc.inliers
                best = cand_kf
                cand_agent = int(self.m.kf_agent[best])
                if book.inertial and self.agents.get(cand_agent, AgentBook()).inertial:
                    # two metric, gravity-aligned maps relate by scale ~1
                    # and a yaw
                    s_est = float(S_corr.s)
                    lo, hi = lc.scale_gate
                    if not lo < s_est < hi:
                        continue
                    R = S_corr.R.cpu().numpy()
                    yaw = np.arctan2(R[1, 0], R[0, 0])
                    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                                   [np.sin(yaw), np.cos(yaw), 0.0],
                                   [0.0, 0.0, 1.0]], np.float32)
                    S_corr = sim3.Sim3(R=self._up(Rz), t=S_corr.t,
                                       s=torch.ones((), device=self.device))

                def fuse_and_weld(kf_slot=kf_slot, best=best, lm=lm, inliers=inliers):
                    ok = lm.valid & inliers
                    self.m = ms.replace_mappoint(self.m, torch.where(ok, lm.cur_mp, -1),
                                                 torch.where(ok, lm.cand_mp, -1))
                    # welding BA on both sides of the seam
                    for seam_kf in (kf_slot, best):
                        self.m = loop_closing.weld_after_merge(
                            self.m, seam_kf, self.K, width=self.cfg.camera.width,
                            height=self.cfg.camera.height,
                            scale_factor=self.cfg.orb.scale_factor,
                            n_levels=self.cfg.orb.n_levels)

                if self.kf_map[best] == self.kf_map[kf_slot]:
                    # a genuine loop closes a LONG cycle: a contemporary
                    # candidate carries no drift information
                    ts = self._host(self.m.kf_timestamp)
                    if abs(float(ts[kf_slot]) - float(ts[best])) < 5.0:
                        continue
                    inert_map = self._map_is_inertial(int(self.kf_map[kf_slot]))
                    # quality gate: the correction must lower the arena's
                    # robust reprojection error
                    m_before = self.m
                    chi0 = self._arena_robust_chi2()
                    self.m = loop_closing.correct_loop(
                        self.m, kf_slot, best, S_corr, fix_scale=inert_map,
                        yaw_only=inert_map)
                    fuse_and_weld()
                    chi1 = self._arena_robust_chi2()
                    if not np.isfinite(chi1) or chi1 > chi0 * 0.98:
                        self.m = m_before
                        self.stats["loops_rejected"] = \
                            self.stats.get("loops_rejected", 0) + 1
                        continue
                    self.stats["loops"] += 1
                else:
                    # gauge precedence: a metric inertial map never moves
                    # into a scale-free visual map's frame
                    cur_inertial = self._map_is_inertial(int(self.kf_map[kf_slot]))
                    cand_inertial = self._map_is_inertial(int(self.kf_map[best]))
                    if cur_inertial != cand_inertial:
                        # lock the metric side's poses for the welding BA
                        inert = [a for a, b in self.agents.items() if b.inertial]
                        snap = fetch(dict(agent=self.m.kf_agent, valid=self.m.kf_valid))
                        own = np.isin(snap["agent"], inert) & snap["valid"]
                        self.m = self.m._replace(
                            kf_pose_locked=self.m.kf_pose_locked | self._up(own))
                    if cur_inertial and not cand_inertial:
                        self._merge_maps(best, kf_slot, sim3.inverse(S_corr))
                    else:
                        self._merge_maps(kf_slot, best, S_corr)
                    self.stats["merges"] += 1
                    fuse_and_weld()
                accepted = True
                break
            if not accepted:
                continue
            book.streak = 0
            book.streak_cand = -1
            book.last_event_ingest = self.stats["kf_ingested"]
            # whole-overlap SearchAndFuse: fused duplicates give the GBA its
            # cross-agent coupling
            self._cross_agent_fuse(int(self.kf_map[kf_slot]))
            self._follow_redirects()
            self._mark_corrected_and_lock()
            # a correction just moved poses: an in-flight solve is stale
            self.abort_global_ba()
            if run_gba and self._gba_guard_ok():
                ev_iters = 12 if any(b.inertial for b in self.agents.values()) else 20
                self.start_global_ba_async(iters=ev_iters, cg_iters=40)
                self._last_gba_ingest = self.stats["kf_ingested"]

    # ------------------------------------------------------------------
    def _shared_map_ids(self) -> List[int]:
        """Sub-map ids fed by more than one agent (merged maps)."""
        by_map: Dict[int, set] = {}
        for a, book in self.agents.items():
            if book.map_id >= 0:
                by_map.setdefault(book.map_id, set()).add(a)
        return [mid for mid, ags in by_map.items() if len(ags) > 1]

    def _follow_redirects(self) -> None:
        """After landmark fusion, re-point each agent's local-id map at the
        survivors, and revoke fused slots that clients hold as foreign
        content."""
        red = self._host(self.m.mp_redirect)
        hot = np.nonzero(red >= 0)[0]
        if not len(hot):
            return

        def resolve(s: int) -> int:
            hops = 0
            while red[s] >= 0 and hops < 64:
                s = int(red[s])
                hops += 1
            return s

        hot_set = set(int(x) for x in hot)
        for a, book in self.agents.items():
            for lid, s in list(book.mp_l2s.items()):
                if s in hot_set:
                    book.mp_l2s[lid] = resolve(s)
            gone = book.sent_foreign_mp & hot_set
            if gone:
                book.foreign_erased_mp_out.extend(sorted(int(x) for x in gone))
                book.sent_foreign_mp -= gone
        self.m = self.m._replace(mp_redirect=torch.full_like(self.m.mp_redirect, -1))

    def _cross_agent_fuse(self, map_id: int, per_agent: int = 16) -> int:
        """Whole-overlap SearchAndFuse: project the arena's landmarks into
        each agent's recent keyframes of the merged map and reconcile
        (duplicates merge, unbound features attach). Like the reference
        port, landmarks are not masked by sub-map id."""
        snap = fetch(dict(valid=self.m.kf_valid, agent=self.m.kf_agent,
                          n_mp=torch.sum(self.m.mp_valid)))
        n_before = int(snap["n_mp"])
        for a in self.agents:
            own = np.nonzero(snap["valid"] & (snap["agent"] == a)
                             & (self.kf_map == map_id))[0]
            for k in own[-per_agent:]:
                self.m = local_mapping.fuse_into_keyframe(
                    self.m, int(k), self.K, width=self.cfg.camera.width,
                    height=self.cfg.camera.height,
                    scale_factor=self.cfg.orb.scale_factor,
                    n_levels=self.cfg.orb.n_levels).map
        fused = n_before - int(torch.sum(self.m.mp_valid))
        if fused:
            self.stats["xfuse_mp"] = self.stats.get("xfuse_mp", 0) + fused
        return fused

    def _arena_robust_chi2(self) -> float:
        """Bounded mean reprojection chi2 over every valid arena
        observation (the loop-acceptance quality gate)."""
        obs, K_obs = self._valid_rows(*self._assemble_gba()[:2])
        return float(_arena_chi2(self.m.kf_pose, self.m.mp_pos, obs, K_obs))

    def _gba_guard_ok(self, max_kfs: int = 200, max_maps: int = 3) -> bool:
        """The reference skips the post-event GBA on big maps (> 200
        keyframes) or with too many live maps."""
        n_kf = int(torch.sum(self.m.kf_valid))
        live = np.unique(self.kf_map[self.kf_map >= 0])
        if n_kf > max_kfs or len(live) > max_maps:
            self.stats["gba_skipped"] = self.stats.get("gba_skipped", 0) + 1
            return False
        return True

    def _map_is_inertial(self, map_id: int) -> bool:
        return any(b.inertial and b.map_id == map_id for b in self.agents.values())

    def _merge_maps(self, kf_cur: int, kf_cand: int, S_loop: sim3.Sim3) -> None:
        """Cross-agent merge: pull the current keyframe's sub-map through
        S_loop^-1 into the candidate's frame (p_cur ~ S_loop(p_cand)),
        relabel it, weld the spanning forest and run a pose graph."""
        map_cur = int(self.kf_map[kf_cur])
        map_cand = int(self.kf_map[kf_cand])
        move_kf = self._up(self.kf_map == map_cur)
        move_mp = self._up(self.mp_map == map_cur)
        m = self.m
        mp_pos = torch.where(move_mp[:, None], sim3.apply(sim3.inverse(S_loop), m.mp_pos),
                             m.mp_pos)
        T_new = sim3.to_se3_scaled(sim3.compose(sim3.from_se3(m.kf_pose), S_loop))
        kf_pose = torch.where(move_kf[:, None, None], T_new, m.kf_pose)
        self.m = m._replace(kf_pose=kf_pose, mp_pos=mp_pos)
        self.kf_map[self.kf_map == map_cur] = map_cand
        self.mp_map[self.mp_map == map_cur] = map_cand
        # the exact gauge this merge applied, for every owner of the moved
        # sub-map: T' = T o S_loop, p' = S_loop^-1(p)
        S_np = fetch(dict(s=S_loop.s, R=S_loop.R, t=S_loop.t))
        g13 = np.concatenate([np.asarray([float(S_np["s"])]),
                              S_np["R"].astype(np.float64).reshape(9),
                              S_np["t"].astype(np.float64).reshape(3)])
        for book in self.agents.values():
            if book.map_id == map_cur:
                book.map_id = map_cand
                book.gauge_total = g13 if book.gauge_total is None else \
                    _compose_g13(book.gauge_total, g13)
                book.gauge_epoch += 1
        # the current keyframe's root chain hangs off the candidate
        parent_np = self._host(self.m.kf_parent)
        root = kf_cur
        while parent_np[root] >= 0:
            root = int(parent_np[root])
        one = torch.ones(1, dtype=torch.bool, device=self.device)
        self.m = self.m._replace(kf_parent=ms.scatter_rows(
            self.m.kf_parent, torch.full((1,), root, device=self.device), one,
            int(kf_cand)))
        # distribute the residual with a pose graph on the welded map
        inert_map = self._map_is_inertial(map_cand)
        self.m = loop_closing.correct_loop(
            self.m, kf_cur, kf_cand, sim3.identity(device=self.device), iters=8,
            fix_scale=inert_map, yaw_only=inert_map)

    def _queue_event_gauges(self, before: np.ndarray,
                            max_slot: Optional[int] = None) -> None:
        """After a non-rigid correction, fit each agent's similarity between
        the pre- and post-correction keyframe centres and queue it on the
        exact gauge channel. `before`: the kf_pose snapshot the correction
        started from; `max_slot`: only slots below it existed then."""
        snap = fetch(dict(valid=self.m.kf_valid, agent=self.m.kf_agent,
                          pose=self.m.kf_pose))
        new = snap["pose"]
        hi = before.shape[0] if max_slot is None else int(max_slot)

        def centers(T):
            return np.einsum("nji,nj->ni", -T[:, :3, :3], T[:, :3, 3])

        for a, book in self.agents.items():
            own = np.nonzero(snap["valid"] & (snap["agent"] == a))[0]
            own = own[own < hi]
            if len(own) < 3:
                continue
            c_old, c_new = centers(before[own]), centers(new[own])
            if np.linalg.matrix_rank(c_new - c_new.mean(0), tol=1e-4) < 2:
                continue
            # T' = T o G  <=>  c' = G^-1(c): fit c_old ~ G(c_new)
            s, R, t = umeyama_align(c_new, c_old)
            if abs(s - 1.0) < 1e-4 and np.abs(R - np.eye(3)).max() < 1e-4 \
                    and np.abs(t).max() < 1e-4:
                continue
            g13 = np.concatenate([[s], R.reshape(9), t])
            book.gauge_total = g13 if book.gauge_total is None else \
                _compose_g13(book.gauge_total, g13)
            book.gauge_epoch += 1

    def _mark_corrected_and_lock(self, recent_free: int = 5) -> None:
        """Lock the corrected poses for downlink, except each agent's
        newest keyframes, which live tracking keeps refining; lock the
        landmarks the correction placed, except those referenced from
        that free tail."""
        snap = fetch(dict(valid=self.m.kf_valid, agent=self.m.kf_agent,
                          mp_valid=self.m.mp_valid, ref=self.m.mp_ref_kf))
        valid = snap["valid"]
        lock = valid.copy()
        free_kf = np.zeros_like(lock)
        for a, book in self.agents.items():
            own = np.nonzero(valid & (snap["agent"] == a))[0]
            if len(own) > recent_free:
                lock[own[-recent_free:]] = False
                free_kf[own[-recent_free:]] = True
            book.dirty_kfs = list(own)
            book.corrections_pending = True
        self.m = self.m._replace(kf_pose_locked=self.m.kf_pose_locked | self._up(lock))
        ref = snap["ref"]
        fresh = (ref >= 0) & free_kf[np.clip(ref, 0, len(free_kf) - 1)]
        self.mp_locked |= snap["mp_valid"] & ~fresh

    # ==================================================================
    # global BA over the arena
    # ==================================================================
    def _assemble_gba(self):
        """Observation list + gauge masks of a full-arena GBA, from the
        arena's kf_mp rows. Returns (obs, K_obs, fixed (numpy), inertial
        agents, point_fixed (numpy or None)).

        An observation of an invalid landmark is masked out. The reference
        keeps it (it checks only the keyframe side), and a handful of them
        appear once merges fuse landmarks: such a landmark enters the Schur
        complement with C^-1 = I instead of its block's inverse, the
        reduced system turns indefinite, and every step of every later GBA
        is rejected (ROADMAP queue C: 50 such rows of 18,903 froze
        bench_collab's post-merge solves)."""
        m = self.m
        Kc, N = m.kf_mp.shape
        dev = self.device
        obs_pt_raw = m.kf_mp.reshape(-1)
        pt = torch.where(obs_pt_raw >= 0, obs_pt_raw, 0)
        obs = local_ba.BAObservations(
            kf=torch.arange(Kc, dtype=torch.int32, device=dev).repeat_interleave(N),
            pt=pt, uv=m.kf_uv.reshape(-1, 2),
            inv_sigma2=level_inv_sigma2(m.kf_level.reshape(-1),
                                        self.cfg.orb.scale_factor),
            valid=(obs_pt_raw >= 0) & m.kf_feat_valid.reshape(-1)
            & m.kf_valid.repeat_interleave(N) & m.mp_valid[pt.long()])
        # per-observation intrinsics: each keyframe row its owner's camera
        K_kf = ms.kf_intrinsics(m, torch.arange(Kc, device=dev), self.K)
        K_obs = cam.PinholeK(*(f.repeat_interleave(N) for f in K_kf))
        # gauge: the oldest valid keyframe of every sub-map is fixed; with
        # inertial agents, their keyframes and landmarks too (their
        # refinement belongs to the inertial solve)
        inert = [a for a, b in self.agents.items() if b.inertial]
        snap = fetch(dict(valid=m.kf_valid, agent=m.kf_agent,
                          **(dict(kf_mp=m.kf_mp, fv=m.kf_feat_valid) if inert else {})))
        fixed = ~snap["valid"]
        for mid in np.unique(self.kf_map[self.kf_map >= 0]):
            slots = np.nonzero(self.kf_map == mid)[0]
            if len(slots):
                fixed[slots[0]] = True
        point_fixed = None
        if inert:
            kf_inert = np.isin(snap["agent"], inert) & snap["valid"]
            fixed |= kf_inert
            rows = snap["kf_mp"][kf_inert]
            rows_ok = snap["fv"][kf_inert] & (rows >= 0)
            point_fixed = np.zeros(m.max_mp, bool)
            point_fixed[rows[rows_ok]] = True
        return obs, K_obs, fixed, inert, point_fixed

    @staticmethod
    def _valid_rows(obs: local_ba.BAObservations, K_obs: cam.PinholeK):
        """The observation list cut to its valid rows (one read of the
        count). Masked rows add exactly zero to every sum of the solve, so
        the result is the full list's up to summation order, for a few
        percent of the work: at bench capacity ~19k of 1,048,576 rows."""
        idx = torch.nonzero(obs.valid)[:, 0]
        return (local_ba.BAObservations(*(f[idx] if f is not None else None for f in obs)),
                cam.PinholeK(*(f[idx] if f.dim() else f for f in K_obs)))

    def run_global_ba(self, iters: int = 6, cg_iters: int = 30,
                      distributed: Optional[bool] = None,
                      force_shard: bool = False, devices=None) -> None:
        """Full-arena visual BA, synchronous (tests, benchmarks); the comm
        path uses start_global_ba_async. With more than one visible CUDA
        device (distributed=None), distributed=True or force_shard, the
        observation list is sharded by landmark owner over `devices`
        (None: every visible CUDA device, or the server's CPU) and the
        camera-side sums are reduced across them; force_shard takes that
        path on one device."""
        t0 = time.perf_counter()
        m = self.m
        obs, K_obs, fixed, inert, pfix = self._assemble_gba()
        obs, K_obs = self._valid_rows(obs, K_obs)
        if distributed is None:
            distributed = self.device.type == "cuda" and torch.cuda.device_count() > 1
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        kw = dict(iters=iters, cg_iters=cg_iters,
                  point_fixed=None if pfix is None else self._up(pfix))
        if distributed or force_shard:
            res = global_ba.global_bundle_adjust_sharded(
                m.kf_pose, self._up(fixed), m.mp_pos, m.mp_valid, obs, K_obs,
                devices=devices, force_shard=force_shard, **kw)
        else:
            res = global_ba.global_bundle_adjust(
                m.kf_pose, self._up(fixed), m.mp_pos, m.mp_valid, obs, K_obs, **kw)
        c = fetch(dict(c_in=res.chi2_in, c_out=res.chi2))
        c_in, c_out = float(c["c_in"]), float(c["c_out"])
        # the LM-controlled solve never raises its own metric: anything
        # else signals a broken snapshot
        if np.isfinite(c_in) and (not np.isfinite(c_out) or c_out > c_in + 1e-6):
            self.stats["gba_rejected"] = self.stats.get("gba_rejected", 0) + 1
            return
        self.m = m._replace(kf_pose=res.poses, mp_pos=res.points)
        self.stats["gba_runs"] += 1
        self.stats["gba_wall_s"] = round(
            self.stats.get("gba_wall_s", 0.0) + (time.perf_counter() - t0), 3)
        if inert:
            # the inertial agents' poses, held in the visual pass, are
            # refined with their preintegration factors holding the gauge
            self.stats["vi_solves"] = self.stats.get("vi_solves", 0) + \
                self.run_full_inertial_ba()
        self._cull_outlier_kfs()
        shared = self._shared_map_ids()
        for mid in shared:
            self._cross_agent_fuse(mid, per_agent=8)
        if shared:
            self._follow_redirects()
        self._mark_corrected_and_lock()

    # ------------------------------------------------------------------
    # time-sliced GBA: one GN step is dispatched per comm cycle (never
    # waited for) and the result is adopted once every step has finished.
    # A CUDA event recorded after each step tells whether it has; on the
    # CPU a step is always finished. Keyframes and landmarks ingested
    # while the solve ran are corrected through their parent chain.
    # ------------------------------------------------------------------
    def start_global_ba_async(self, iters: int = 10, cg_iters: int = 30) -> None:
        """Snapshot the arena and begin an incremental GBA (a solve already
        in flight is kept; events abort it explicitly)."""
        if self._gba_inflight is not None:
            return
        m = self.m
        obs, K_obs, fixed, inert, pfix = self._assemble_gba()
        obs, K_obs = self._valid_rows(obs, K_obs)
        snap = fetch(dict(n_kf=m.n_kf, n_mp=m.n_mp, pose=m.kf_pose))
        self._gba_inflight = {
            "poses": m.kf_pose, "points": m.mp_pos, "obs": obs, "K_obs": K_obs,
            "fixed": self._up(fixed), "point_valid": m.mp_valid, "inert": inert,
            "point_fixed": None if pfix is None else self._up(pfix),
            "lam": 1e-3, "iters_left": int(iters), "cg_iters": int(cg_iters),
            "launch_n_kf": int(snap["n_kf"]), "launch_n_mp": int(snap["n_mp"]),
            "before_pose": snap["pose"], "t0": time.perf_counter(), "event": None}

    def abort_global_ba(self) -> None:
        """Drop an in-flight GBA (a new loop/merge supersedes it)."""
        if self._gba_inflight is not None:
            self._gba_inflight = None
            self.stats["gba_aborted"] = self.stats.get("gba_aborted", 0) + 1

    def _gba_step(self, st) -> global_ba.GBAResult:
        res = global_ba.global_bundle_adjust(
            st["poses"], st["fixed"], st["points"], st["point_valid"], st["obs"],
            st["K_obs"], iters=1, cg_iters=st["cg_iters"], lam0=st["lam"],
            point_fixed=st["point_fixed"])
        st["poses"], st["points"] = res.poses, res.points
        st["lam"] = res.lam          # LM damping carries across slices
        st["iters_left"] -= 1
        if self.device.type == "cuda":
            st["event"] = torch.cuda.Event()
            st["event"].record()
        return res

    @staticmethod
    def _step_done(st) -> bool:
        return st["event"] is None or st["event"].query()

    def drain_gba(self) -> None:
        """Finish and adopt an in-flight GBA (end of sequence), then sweep
        outlier keyframes without the newest-keyframe protection."""
        while self._gba_inflight is not None:
            st = self._gba_inflight
            if st["iters_left"] > 0:
                self._gba_step(st)
            else:
                self._adopt_gba(st)
                self._gba_inflight = None
        self._cull_outlier_kfs(protect_tail=False)

    def _poll_gba(self) -> None:
        """Advance the in-flight GBA by at most one step (none while the
        previous one is still running, unless deterministic), or adopt
        the finished result."""
        st = self._gba_inflight
        if st is None:
            return
        if not self.deterministic and not self._step_done(st):
            return
        if st["iters_left"] > 0:
            res = self._gba_step(st)
            st.setdefault("chi2_launch", res.chi2_in)
            st["chi2_final"] = res.chi2
            return
        self._adopt_gba(st)
        self._gba_inflight = None

    def _adopt_gba(self, st) -> None:
        """Write the finished result into the live arena; entities created
        during the solve follow their parent / reference keyframe."""
        m = self.m
        snap = fetch(dict(
            c_in=st.get("chi2_launch", torch.tensor(float("nan"))),
            c_out=st.get("chi2_final", torch.tensor(0.0)),
            res_pose=st["poses"], res_pts=st["points"], pose=m.kf_pose,
            valid=m.kf_valid, parent=m.kf_parent, n_kf=m.n_kf, mp=m.mp_pos,
            mp_valid=m.mp_valid, n_mp=m.n_mp, ref=m.mp_ref_kf))
        # divergence gate: a solve that raised the mean inlier chi2 is
        # not adopted
        c_in, c_out = float(snap["c_in"]), float(snap["c_out"])
        if np.isfinite(c_in) and (not np.isfinite(c_out) or c_out > c_in + 1e-6):
            self.stats["gba_rejected"] = self.stats.get("gba_rejected", 0) + 1
            return
        launch_nk, launch_np = st["launch_n_kf"], st["launch_n_mp"]
        before = st["before_pose"]
        cur_pose, cur_valid = snap["pose"], snap["valid"]
        new_pose = cur_pose.copy()
        mask = cur_valid[:launch_nk]
        new_pose[:launch_nk][mask] = snap["res_pose"][:launch_nk][mask]
        # mid-flight keyframes: T_new = T_old inv(T_parent_old) T_parent_new
        # through the nearest snapshot-era ancestor
        parent = snap["parent"]
        for k in range(launch_nk, int(snap["n_kf"])):
            if not cur_valid[k]:
                continue
            p = int(parent[k])
            while p >= launch_nk:
                p = int(parent[p])
            if p < 0:
                continue
            new_pose[k] = cur_pose[k] @ np.linalg.inv(before[p]) @ new_pose[p]
        # landmarks: snapshot rows take the solved positions; mid-flight
        # rows ride their reference keyframe's correction
        cur_mp, mp_valid = snap["mp"], snap["mp_valid"]
        new_mp = cur_mp.copy()
        pmask = mp_valid[:launch_np]
        new_mp[:launch_np][pmask] = snap["res_pts"][:launch_np][pmask]
        n_mp = int(snap["n_mp"])
        if n_mp > launch_np:
            ref = snap["ref"][launch_np:n_mp]
            sel = mp_valid[launch_np:n_mp] & (ref >= 0)
            if sel.any():
                r = np.clip(ref[sel], 0, cur_pose.shape[0] - 1)
                A = np.einsum("kij,kjl->kil", np.linalg.inv(new_pose[r]), cur_pose[r])
                x = cur_mp[launch_np:n_mp][sel]
                xh = np.concatenate([x, np.ones((len(x), 1))], 1)
                new_mp[launch_np:n_mp][sel] = np.einsum("kij,kj->ki", A, xh)[:, :3]
        self.m = m._replace(kf_pose=self._up(new_pose.astype(np.float32)),
                            mp_pos=self._up(new_mp.astype(np.float32)))
        self.stats["gba_runs"] += 1
        self.stats["gba_wall_s"] = round(
            self.stats.get("gba_wall_s", 0.0) + (time.perf_counter() - st["t0"]), 3)
        if st["inert"]:
            self.stats["vi_solves"] = self.stats.get("vi_solves", 0) + \
                self.run_full_inertial_ba()
        self._cull_outlier_kfs()
        # improved geometry exposes more cross-agent duplicates
        shared = self._shared_map_ids()
        for mid in shared:
            self._cross_agent_fuse(mid, per_agent=8)
        if shared:
            self._follow_redirects()
        # GBA results travel as exact locked updates; the gauge channel
        # stays merge-only
        self._mark_corrected_and_lock()

    # ==================================================================
    # culling (server side only, as in the reference)
    # ==================================================================
    # ==================================================================
    # server-side inertial solves over the uplinked preintegration rows
    # ==================================================================
    def _merge_preint_forward(self, slot: int, agent: int,
                              valid_mask: Optional[np.ndarray] = None) -> None:
        """Before an inertial agent's keyframe is erased, fold its uplinked
        preintegration window into the next own keyframe's window, so the
        agent's inertial chain stays unbroken (the reference's
        MergePrevious on erasure). With no row-bearing successor ingested
        yet, the window waits as an orphan for _splice_orphan_preints."""
        row = self.kf_imu[slot].copy()
        if float(row[pre.FLAT_DT]) <= 0.0:      # no window uplinked
            return
        snap = fetch(dict(agent=self.m.kf_agent, **(
            dict(valid=self.m.kf_valid) if valid_mask is None else {})))
        valid = snap["valid"] if valid_mask is None else valid_mask
        cand = np.nonzero(valid & (snap["agent"] == agent))[0]
        cand = cand[cand > slot]
        self.kf_imu[slot] = 0.0
        # the first successor that carries a window takes it (rows ship
        # once, inside keyframe payloads)
        for c in cand:
            if float(self.kf_imu[c, pre.FLAT_DT]) > 0.0:
                merged = pre.merge_preintegrated(
                    pre.flat_to_preint(row[:pre.FLAT_DIM]),
                    pre.flat_to_preint(self.kf_imu[c, :pre.FLAT_DIM]))
                self.kf_imu[c, :pre.FLAT_DIM] = pre.preint_to_flat(merged)
                return
        self._orphan_preint.setdefault(agent, []).append((slot, row))

    def _splice_orphan_preints(self, agent: int, slot_i: int) -> None:
        """Fold the stashed orphan windows of keyframes erased before
        slot_i into the freshly ingested row-bearing keyframe slot_i."""
        orphans = self._orphan_preint.get(agent)
        if not orphans:
            return
        take = sorted([o for o in orphans if o[0] < slot_i], key=lambda o: o[0])
        if not take:
            return
        self._orphan_preint[agent] = [o for o in orphans if o[0] >= slot_i]
        acc = pre.flat_to_preint(take[0][1][:pre.FLAT_DIM])
        for _, row in take[1:]:
            acc = pre.merge_preintegrated(acc, pre.flat_to_preint(row[:pre.FLAT_DIM]))
        merged = pre.merge_preintegrated(
            acc, pre.flat_to_preint(self.kf_imu[slot_i, :pre.FLAT_DIM]))
        self.kf_imu[slot_i, :pre.FLAT_DIM] = pre.preint_to_flat(merged)

    def _kf_owners(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the arena's keyframe validity and owners."""
        snap = fetch(dict(valid=self.m.kf_valid, agent=self.m.kf_agent))
        return snap["valid"], snap["agent"]

    def run_inertial_refinement(self, window: int = 8, anchor: int = 2,
                                iters: int = 4) -> int:
        """Sweep fixed-size visual-inertial windows over each inertial
        agent's keyframe chain with the uplinked preintegration windows,
        velocities and biases; each window's anchor prefix is pose-fixed,
        so windows weld onto already-refined state. Returns the number of
        windows solved."""
        valid, agents_arr = self._kf_owners()
        n_windows = 0
        for a, book in self.agents.items():
            if not book.inertial:
                continue
            own = np.nonzero(valid & (agents_arr == a))[0]
            has_pre = self.kf_imu[own, pre.FLAT_DT] > 0.0
            if int(has_pre.sum()) < 2 or len(own) < anchor + 2:
                continue
            T_bc = book.T_bc if book.T_bc is not None else np.eye(4, dtype=np.float32)
            g_w = np.array([0.0, 0.0, -float(self.cfg.imu.gravity)], np.float32)
            Kw = anchor + window
            start = 0
            while start + anchor + 1 < len(own):
                self._vi_window(own[start:start + Kw], Kw, T_bc, g_w, iters,
                                n_fixed=anchor if start > 0 else 1)
                n_windows += 1
                start += window
        return n_windows

    def _estimate_agent_gravity(self, own: np.ndarray,
                                T_bc: np.ndarray) -> Optional[np.ndarray]:
        """The gravity direction of one agent's arena chain (poses fixed,
        scale pinned): the server's world is the client's init-time gauge,
        whose gravity is only as vertical as that estimate, and a joint
        solve against an assumed -z would tilt the chain by the init
        error. Returns g_w (3,), or None for a chain with fewer than 6
        consecutive valid windows."""
        snap = fetch(dict(ts=self.m.kf_timestamp, pose=self.m.kf_pose))
        rows = self.kf_imu[own]
        ts = snap["ts"][own]
        gap = np.diff(ts, prepend=ts[0])
        ok = np.zeros(len(own), bool)
        ok[1:] = (rows[1:, pre.FLAT_DT] > 0.0) & (
            np.abs(rows[1:, pre.FLAT_DT] - gap[1:]) < 0.25 * np.maximum(gap[1:], 1e-3) + 0.01)
        # the longest run of consecutive valid windows
        best, start = (0, 0), 0
        for i in range(1, len(own) + 1):
            if i == len(own) or not ok[i]:
                if i - start > best[1] - best[0]:
                    best = (start, i)
                start = i
        a, b = best
        if b - a < 6:
            return None
        sl = own[a:b]
        T_cw = snap["pose"][sl].astype(np.float64)
        T_wb = np.linalg.inv(np.asarray(T_bc, np.float64)[None] @ T_cw)
        G = float(self.cfg.imu.gravity)
        res = inertial_init.inertial_init(
            self._up(T_wb[:, :3, :3].astype(np.float32)),
            self._up(T_wb[:, :3, 3].astype(np.float32)),
            pre.flat_to_preint(self._up(self.kf_imu[sl, :pre.FLAT_DIM])),
            G=G, fix_scale=True)
        R_wg = self._host(res.R_wg).astype(np.float64)
        if not np.all(np.isfinite(R_wg)):
            return None
        return (R_wg @ np.array([0.0, 0.0, -G])).astype(np.float32)

    def run_full_inertial_ba(self, iters: int = 8, max_joint: int = 256) -> int:
        """One joint visual-inertial solve over each inertial agent's whole
        keyframe chain (the reference's FullInertialBA after a global BA):
        poses, velocities, biases and landmarks, with preintegration and
        reprojection factors. A windowed pass cannot redistribute error
        along a whole arc. Each chain is padded to a power-of-two bucket;
        chains longer than max_joint take the windowed sweep. Returns the
        solves run."""
        valid, agents_arr = self._kf_owners()
        n_solved = 0
        shared = self._shared_map_ids()
        for a, book in self.agents.items():
            if not book.inertial:
                continue
            own = np.nonzero(valid & (agents_arr == a))[0]
            has_pre = self.kf_imu[own, pre.FLAT_DT] > 0.0
            if int(has_pre.sum()) < 2 or len(own) < 4:
                continue
            if len(own) > max_joint:
                n_solved += self.run_inertial_refinement()
                continue
            T_bc = book.T_bc if book.T_bc is not None else np.eye(4, dtype=np.float32)
            g_est = self._estimate_agent_gravity(own, T_bc)
            g_w = g_est if g_est is not None else np.array(
                [0.0, 0.0, -float(self.cfg.imu.gravity)], np.float32)
            Kw = pow2_len(len(own), lo=16)
            # landmarks are free; in a merged map, those other agents also
            # observe stay pinned (this per-agent solve cannot see those
            # residuals; the visual GBA owns them)
            pf_global = None
            if book.map_id in shared:
                snap = fetch(dict(kf_mp=self.m.kf_mp, fv=self.m.kf_feat_valid))
                others = valid & (agents_arr != a)
                rows = snap["kf_mp"][others]
                rows_ok = snap["fv"][others] & (rows >= 0)
                pf_global = np.zeros(self.m.max_mp, bool)
                pf_global[rows[rows_ok]] = True
            # the landmark set is capped at 4,096 as in the JAX package; a
            # chain that sees more loses its highest slots
            # (stats["vi_pts_truncated"] counts each such solve)
            self._vi_window(own, Kw, T_bc, g_w, iters, n_fixed=1,
                            n_pts=min(4096, self.m.max_mp), fix_points=False,
                            point_fixed=pf_global)
            n_solved += 1
        return n_solved

    def _vi_window_inputs(self, sl: np.ndarray, Kw: int, T_bc: np.ndarray,
                          g_w: np.ndarray, n_fixed: int, n_pts: Optional[int] = None,
                          point_fixed: Optional[np.ndarray] = None) -> Optional[dict]:
        """The fixed-shape inputs of one visual-inertial window over arena
        slots `sl`, padded to Kw by repeating the last slot (pads are
        pose-fixed and carry no observations and no inertial pair); None
        when no pair in it is usable. The uploads do not wait on the
        device; the keyframe timestamps are read once."""
        n_real = len(sl)
        sl_pad = np.concatenate([sl, np.full(Kw - n_real, sl[-1], sl.dtype)])
        m = self.m
        dev = self.device
        rows = self.kf_imu[sl_pad]
        # pair i-1 -> i is usable only when both are real and a window
        # spanning the keyframes' timestamp gap was uplinked for i (a
        # mismatch means a dropped uplink, an unmerged cull or an init-time
        # window: a factor over the wrong span corrupts poses)
        ts_w = self._host(m.kf_timestamp)[sl_pad]
        gap = np.diff(ts_w, prepend=ts_w[0])
        pair_valid = np.zeros(Kw, bool)
        pair_valid[1:n_real] = (
            (rows[1:n_real, pre.FLAT_DT] > 0.0)
            & (np.abs(rows[1:n_real, pre.FLAT_DT] - gap[1:n_real])
               < 0.25 * np.maximum(gap[1:n_real], 1e-3) + 0.01))
        if not pair_valid.any():
            return None
        fixed = np.arange(Kw) >= n_real         # pads
        fixed[:n_fixed] = True                  # anchor prefix
        up = self._up(rows)
        sj = self._up(sl_pad.astype(np.int64))
        obs_mp = m.kf_mp[sj]
        if n_pts is None:
            n_pts = self.cfg.local_mapping.local_ba_points
        uniq = local_mapping.fixed_size_unique(obs_mp, n_pts, ms.NO_MP)
        pt_ok = uniq >= 0
        # distinct landmarks the window observes, for the truncation count
        srt = torch.sort(obs_mp.reshape(-1)).values
        n_seen = torch.sum((srt[1:] != srt[:-1]) & (srt[1:] >= 0)) + (srt[0] >= 0).long()
        lut = torch.full((m.max_mp + 1,), -1, dtype=torch.int64, device=dev)
        lut = lut.index_put((torch.where(pt_ok, uniq, m.max_mp).long(),),
                            torch.where(pt_ok, torch.arange(n_pts, device=dev), -1))
        flat_mp = obs_mp.reshape(-1)
        local_pt = lut[torch.where(flat_mp >= 0, flat_mp, m.max_mp).long()]
        N = m.kf_mp.shape[1]
        kf_idx = torch.arange(Kw, device=dev).repeat_interleave(N)
        obs = local_ba.BAObservations(
            kf=kf_idx, pt=torch.where(local_pt >= 0, local_pt, 0),
            uv=m.kf_uv[sj].reshape(-1, 2),
            inv_sigma2=level_inv_sigma2(m.kf_level[sj].reshape(-1),
                                        self.cfg.orb.scale_factor),
            valid=(flat_mp >= 0) & (local_pt >= 0) & m.kf_feat_valid[sj].reshape(-1)
            & (kf_idx < n_real))
        pt_safe = torch.where(pt_ok, uniq, 0).long()
        pf_local = None
        if point_fixed is not None:
            pf_local = self._up(point_fixed)[pt_safe] | ~pt_ok
        host = self._up(np.concatenate([
            fixed, pair_valid]).astype(np.float32))
        solve = dict(
            poses=m.kf_pose[sj], velocities=up[:, pre.FLAT_DIM:].contiguous(),
            bg=up[:, pre.FLAT_BG:pre.FLAT_BG + 3].contiguous(),
            ba=up[:, pre.FLAT_BA:pre.FLAT_BA + 3].contiguous(), fixed=host[:Kw] > 0,
            points=m.mp_pos[pt_safe], obs=obs,
            preints=pre.flat_to_preint(up[:, :pre.FLAT_DIM]), pair_valid=host[Kw:] > 0,
            K=ms.kf_intrinsics(m, sj[0], self.K), g_w=self._up(np.asarray(g_w, np.float32)),
            T_bc=self._up(np.asarray(T_bc, np.float32).reshape(4, 4)),
            point_fixed=pf_local)
        return {"solve": solve, "sl": sl, "sj": sj, "n_real": n_real, "uniq": uniq,
                "pt_ok": pt_ok, "n_seen": n_seen}

    def _vi_window(self, sl: np.ndarray, Kw: int, T_bc: np.ndarray, g_w: np.ndarray,
                   iters: int, n_fixed: int, n_pts: Optional[int] = None,
                   fix_points: bool = True,
                   point_fixed: Optional[np.ndarray] = None) -> None:
        """One visual-inertial window over arena slots `sl` (see
        _vi_window_inputs). The solve itself reads nothing back; after it,
        one read takes the finiteness and visual-consistency gates, the
        truncation count and the refined velocities, which the host rows
        keep."""
        inp = self._vi_window_inputs(sl, Kw, T_bc, g_w, n_fixed, n_pts, point_fixed)
        if inp is None:
            return
        sv, sj, n_real = inp["solve"], inp["sj"], inp["n_real"]
        uniq, pt_ok = inp["uniq"], inp["pt_ok"]
        res = inertial_ba.inertial_bundle_adjust(**sv, iters=iters, fix_points=fix_points)
        # visual-consistency gate: the IMU factors must not win by dragging
        # the window off the image evidence; the window is reverted if the
        # visual inlier chi2 got worse
        obs = sv["obs"]
        r0, _, _, behind0 = local_ba._obs_terms(sv["poses"], sv["points"], obs, sv["K"])
        c20 = local_ba._chi2(r0, obs.inv_sigma2)
        in0 = obs.valid & ~behind0 & (c20 <= 5.991)
        chi0 = torch.sum(torch.where(in0, c20, 0.0)) / torch.clamp(
            torch.sum(in0.to(torch.int32)), min=1)
        snap = fetch(dict(finite=torch.isfinite(res.poses).all(), chi0=chi0,
                          chi2=res.chi2, n_seen=inp["n_seen"], n_kept=pt_ok.sum(),
                          vel=res.velocities[:n_real]))
        if int(snap["n_seen"]) > int(snap["n_kept"]):
            self.stats["vi_pts_truncated"] = self.stats.get("vi_pts_truncated", 0) + 1
        if not bool(snap["finite"]):
            return
        chi0 = float(snap["chi0"])
        if float(snap["chi2"]) > max(chi0 * 1.2, chi0 + 0.05):
            return
        # write back the real rows only: pads repeat sl[-1]
        m = self.m
        real = torch.arange(Kw, device=self.device) < n_real
        upd = {"kf_pose": ms.scatter_rows(m.kf_pose, sj, real, res.poses)}
        if not fix_points:
            # the joint solve moved landmarks too. Rows without a landmark
            # go to the sacrificial row: the JAX package sends them to slot
            # 0, a duplicate index whose winner a GPU scatter leaves open
            upd["mp_pos"] = ms.scatter_rows(m.mp_pos, uniq, pt_ok, res.points)
        self.m = m._replace(**upd)
        # refined velocities chain into the next window's anchor (the
        # integration-time biases stay: they are the linearisation point)
        self.kf_imu[sl, pre.FLAT_DIM:] = snap["vel"]

    def _notify_kfs_erased(self, culled: np.ndarray, before: np.ndarray,
                           agents_arr: np.ndarray) -> None:
        """Bookkeeping after a server-side keyframe cull: owner erasure
        notices and tombstones, database rows, revocation of foreign
        copies."""
        remaining = before.copy()
        for slot in culled:
            a = int(agents_arr[slot])
            self._merge_preint_forward(int(slot), a, valid_mask=remaining)
            remaining[slot] = False
            lid = int(self.kf_local[slot])
            if lid >= 0:
                self.agents[a].erased_out = self.agents[a].erased_out + [lid]
                self.agents[a].erased_kf_tomb.add(lid)
            self.db = dbm.erase_keyframe_bow(self.db, int(slot))
            for b2, book2 in self.agents.items():
                if b2 != a and int(slot) in book2.sent_foreign_kf:
                    book2.foreign_erased_kf_out.append(int(slot))
                    book2.sent_foreign_kf.discard(int(slot))

    def _cull_outlier_kfs(self, min_obs: int = 15, min_inlier_frac: float = 0.3,
                          protect_tail: bool = True) -> int:
        """Erase keyframes whose observations are mostly outliers at the
        solved geometry (minted from a wrong pose; the solver cannot
        repair them). Origins and, mid-run, each agent's newest keyframes
        are protected."""
        m = self.m
        obs, K_obs = self._valid_rows(*self._assemble_gba()[:2])
        n_ok, n_inl = _kf_inlier_counts(m.kf_pose, m.mp_pos, obs, K_obs, m.max_kf)
        snap = fetch(dict(n_ok=n_ok, n_inl=n_inl, valid=m.kf_valid, agent=m.kf_agent))
        n_ok, valid, agents_arr = snap["n_ok"], snap["valid"], snap["agent"]
        frac = snap["n_inl"] / np.maximum(n_ok, 1)
        bad = valid & (n_ok >= min_obs) & (frac < min_inlier_frac)
        for a, book in self.agents.items():
            own = np.nonzero(valid & (agents_arr == a))[0]
            if len(own):
                bad[own[:1]] = False
                if protect_tail:
                    bad[own[-2:]] = False
            if protect_tail and book.last_kf_slot is not None and book.last_kf_slot >= 0:
                bad[book.last_kf_slot] = False
        slots = np.nonzero(bad)[0]
        if not len(slots):
            return 0
        before = valid.copy()
        for s in slots:
            self.m = ms.erase_keyframe(self.m, int(s))
        self._notify_kfs_erased(slots, before, agents_arr)
        self.stats["kf_outlier_culled"] = \
            self.stats.get("kf_outlier_culled", 0) + len(slots)
        return len(slots)

    def _cull(self) -> None:
        # nothing ingested since the last sweep: nothing newly redundant
        ing = (self.stats.get("kf_ingested", 0), self.stats.get("mp_ingested", 0))
        if ing == self._last_cull_ingest:
            return
        self._last_cull_ingest = ing
        snap = fetch(dict(agent=self.m.kf_agent, valid=self.m.kf_valid,
                          mp_valid=self.m.mp_valid))
        agents_arr, before, before_mp = snap["agent"], snap["valid"], snap["mp_valid"]
        protect = np.zeros(self.m.max_kf, bool)
        for a, book in self.agents.items():
            if book.last_kf_slot >= 0:
                protect[book.last_kf_slot] = True
            own = np.nonzero(before & (agents_arr == a))[0]
            protect[own[:1]] = True     # sub-map origin
            protect[own[-3:]] = True    # newest few, still being tracked
        self.m, n_kf, n_mp = culling.cull(self.m, self._up(protect), age_kf=6)
        if n_kf == 0 and n_mp == 0:
            return
        after = fetch(dict(valid=self.m.kf_valid, mp_valid=self.m.mp_valid,
                           mp_agent=self.m.mp_agent))
        if n_kf > 0:
            culled = np.nonzero(before & ~after["valid"])[0]
            self._notify_kfs_erased(culled, before, agents_arr)
            self.stats["kf_culled"] = self.stats.get("kf_culled", 0) + n_kf
        if n_mp > 0:
            culled_set = set(int(s) for s in np.nonzero(before_mp & ~after["mp_valid"])[0])
            mp_owner = after["mp_agent"]
            # the owner's local copy dies with the server's
            s2l = {a: {s: l for l, s in book.mp_l2s.items()}
                   for a, book in self.agents.items()}
            for s in sorted(culled_set):
                a = int(mp_owner[s])
                lid = s2l.get(a, {}).get(s)
                if lid is not None:
                    book = self.agents[a]
                    book.erased_mp_out.append(lid)
                    book.erased_mp_tomb.add(lid)
                    del book.mp_l2s[lid]
            for book2 in self.agents.values():
                gone = book2.sent_foreign_mp & culled_set
                if gone:
                    book2.foreign_erased_mp_out.extend(sorted(gone))
                    book2.sent_foreign_mp -= gone
            self.stats["mp_culled"] = self.stats.get("mp_culled", 0) + n_mp

    # ==================================================================
    # downlink
    # ==================================================================
    def _downlink(self) -> None:
        """Send corrected (locked) poses back to their owners, plus the
        cross-agent covisibility vicinity of each client's current
        keyframe: full payloads of other agents' entities the client has
        never seen, refreshes of those it has, revocations and the gauge.
        One host snapshot of the arena serves every agent."""
        cap = self.cfg.comm.vicinity_kfs
        m = self.m
        # idle-skip before the snapshot: nothing queued and the arena has
        # not moved since the last cycle (a backlog of foreign refreshes is
        # not among the tests, as in the reference)
        any_work = self._arena_epoch != self._downlink_epoch
        if not any_work:
            for book in self.agents.values():
                if book.dirty_kfs or book.corrections_pending or book.erased_out \
                        or book.erased_mp_out or book.foreign_erased_kf_out \
                        or book.foreign_erased_mp_out \
                        or book.gauge_epoch > getattr(book, "_gauge_sent_epoch", 0) \
                        or book.next_seq - 1 > getattr(book, "acked", 0):
                    any_work = True
                    break
        if not any_work:
            return
        self._downlink_epoch = self._arena_epoch
        anchors = {}
        for a, book in self.agents.items():
            anc = book.kf_l2s.get(book.closest_kf, book.last_kf_slot)
            anchors[a] = -1 if anc is None else int(anc)
        order = sorted(self.agents)
        covis_all = ms.covisibility_rows(
            m, self._up(np.asarray([anchors[a] for a in order], np.int64)))
        snap = fetch(dict(
            kf_pose=m.kf_pose, locked=m.kf_pose_locked, kf_valid=m.kf_valid,
            kf_agent=m.kf_agent, kf_timestamp=m.kf_timestamp, kf_mp=m.kf_mp,
            kf_feat_valid=m.kf_feat_valid, kf_cam=m.kf_cam, mp_pos=m.mp_pos,
            mp_valid=m.mp_valid, mp_agent=m.mp_agent, covis=covis_all))
        covis_by_agent = {a: snap["covis"][i] for i, a in enumerate(order)}
        for a, book in self.agents.items():
            ku = mu = None
            sent_slots: List[int] = []
            if book.dirty_kfs:
                slots = np.unique(np.asarray(book.dirty_kfs, np.int64))
                slots = slots[snap["locked"][slots]]
                # vicinity priority: closest to the client's reference KF
                if anchors[a] >= 0 and len(slots) > cap:
                    covis = covis_by_agent[a]
                    slots = slots[np.argsort(-covis[slots])][:cap]
                else:
                    slots = slots[:cap]
                local_ids = self.kf_local[slots]
                ok = local_ids >= 0
                slots, local_ids = slots[ok], local_ids[ok]
                if len(slots):
                    ku = protocol.KFUpdatePayload(
                        agent=a, local_id=local_ids.astype(np.int32),
                        T_abs=snap["kf_pose"][slots], locked=np.ones(len(slots), bool))
                sent_slots = slots.tolist()
            # locked landmark updates for the agent's own points, budgeted
            # to those that moved since the last downlink
            if book.corrections_pending or ku is not None:
                own_mp = list(book.mp_l2s.items())
                if own_mp:
                    lids = np.asarray([l for l, _ in own_mp], np.int32)
                    sl = np.asarray([s for _, s in own_mp])
                    cur = snap["mp_pos"][sl]
                    if book.mp_down_pos is None:
                        book.mp_down_pos = np.full((self.m.max_mp, 3), np.inf, np.float32)
                    moved = np.abs(cur - book.mp_down_pos[sl]).max(1) > 1e-6
                    pick = np.nonzero(moved)[0][:self.cfg.comm.client_mp_bound]
                    if len(pick):
                        mu = protocol.MPUpdatePayload(
                            agent=a, local_id=lids[pick], pos_abs=cur[pick],
                            locked=np.ones(len(pick), bool))
                        book.mp_down_pos[sl[pick]] = cur[pick]
                    book.corrections_pending = bool(moved.sum() > len(pick))
            fkf, fmp = self._pack_foreign_vicinity(a, book, snap, covis_by_agent[a],
                                                   anchors[a])
            fku = fmu2 = None
            # refresh already-shipped foreign entities the arena moved
            if book.sent_foreign_kf:
                sl = np.fromiter(book.sent_foreign_kf, np.int64, len(book.sent_foreign_kf))
                sl = sl[snap["kf_valid"][sl]]
                if book.f_kf_down is None:
                    book.f_kf_down = np.full((self.m.max_kf, 4, 4), np.inf, np.float32)
                curT = snap["kf_pose"][sl]
                movedT = np.abs(curT - book.f_kf_down[sl]).reshape(len(sl), -1).max(1) > 1e-6
                pick = sl[movedT][:self.cfg.comm.vicinity_kfs]
                if len(pick):
                    fku = protocol.ForeignKFUpdatePayload(
                        server_id=pick.astype(np.int32), T_abs=snap["kf_pose"][pick])
                    book.f_kf_down[pick] = snap["kf_pose"][pick]
            if book.sent_foreign_mp:
                sl = np.fromiter(book.sent_foreign_mp, np.int64, len(book.sent_foreign_mp))
                sl = sl[snap["mp_valid"][sl]]
                if book.f_mp_down is None:
                    book.f_mp_down = np.full((self.m.max_mp, 3), np.inf, np.float32)
                curp = snap["mp_pos"][sl]
                movedp = np.abs(curp - book.f_mp_down[sl]).max(1) > 1e-6
                pick = sl[movedp][:self.cfg.comm.client_mp_bound]
                if len(pick):
                    fmu2 = protocol.ForeignMPUpdatePayload(
                        server_id=pick.astype(np.int32), pos_abs=snap["mp_pos"][pick])
                    book.f_mp_down[pick] = snap["mp_pos"][pick]
            erased, erased_mp = book.erased_out, book.erased_mp_out
            f_kf_rev, f_mp_rev = book.foreign_erased_kf_out, book.foreign_erased_mp_out
            gauge_fresh = book.gauge_epoch > getattr(book, "_gauge_sent_epoch", 0)
            need_ack = book.next_seq - 1 > getattr(book, "acked", 0)
            if ku is None and mu is None and fkf is None and fmp is None \
                    and fku is None and fmu2 is None and not erased and not erased_mp \
                    and not f_kf_rev and not f_mp_rev and not gauge_fresh \
                    and not need_ack:
                book.dirty_kfs = []
                continue
            book.acked = book.next_seq - 1
            as_i32 = lambda x: np.asarray(x, np.int32) if x else None  # noqa: E731
            delta = protocol.MapDelta(
                agent=a, kf_updates=ku, mp_updates=mu, foreign_kfs=fkf,
                foreign_mps=fmp, foreign_kf_updates=fku, foreign_mp_updates=fmu2,
                erased_kf=as_i32(erased), erased_mp=as_i32(erased_mp),
                foreign_erased_kf=as_i32(f_kf_rev), foreign_erased_mp=as_i32(f_mp_rev),
                ack_seq=book.next_seq - 1, gauge_down=book.gauge_total,
                gauge_epoch=book.gauge_epoch)
            book.erased_out = []
            book.erased_mp_out = []
            book._gauge_sent_epoch = book.gauge_epoch
            book.foreign_erased_kf_out = []
            book.foreign_erased_mp_out = []
            self.transport.send_down(a, delta.to_bytes())
            book.dirty_kfs = sorted(set(book.dirty_kfs) - set(sent_slots))

    def _pack_foreign_vicinity(self, a: int, book: AgentBook, snap: Dict,
                               covis: np.ndarray, anchor: int, kf_budget: int = 6,
                               mp_budget: int = 3000):
        """Pack the covisibility vicinity (<= vicinity_kfs keyframes) around
        the client's reference keyframe, restricted to OTHER agents'
        entities of the same sub-map that this client has never received.
        Only the new keyframes' per-feature rows and the new landmarks'
        descriptors cost another (device-gathered) fetch."""
        if anchor is None or anchor < 0 or book.map_id < 0:
            return None, None
        valid, owners = snap["kf_valid"], snap["kf_agent"]
        cand = np.nonzero((covis > 0) & valid & (owners != a)
                          & (self.kf_map == book.map_id))[0]
        if len(cand) == 0:
            return None, None
        cand = cand[np.argsort(-covis[cand])][:self.cfg.comm.vicinity_kfs]
        new_kf = [int(s) for s in cand if int(s) not in book.sent_foreign_kf][:kf_budget]
        fkf = fmp = None
        mp_new: List[int] = []
        if new_kf:
            sl = np.asarray(new_kf)
            kf_mp = snap["kf_mp"][sl]
            fv = snap["kf_feat_valid"][sl]
            sl_d = self._up(sl.astype(np.int64))
            rows = fetch(dict(uv=self.m.kf_uv[sl_d], desc=self.m.kf_desc[sl_d],
                              level=self.m.kf_level[sl_d], angle=self.m.kf_angle[sl_d]))
            fkf = protocol.ForeignKFPayload(
                server_id=sl.astype(np.int32), owner=owners[sl],
                timestamp=snap["kf_timestamp"][sl], T_abs=snap["kf_pose"][sl],
                uv=rows["uv"], desc=rows["desc"], level=rows["level"],
                angle=rows["angle"], feat_valid=fv, mp_server=kf_mp,
                cam=snap["kf_cam"][sl])
            book.sent_foreign_kf.update(new_kf)
            if book.f_kf_down is None:
                book.f_kf_down = np.full((self.m.max_kf, 4, 4), np.inf, np.float32)
            book.f_kf_down[sl] = snap["kf_pose"][sl]
            mp_valid = snap["mp_valid"]
            cand_mp = np.unique(kf_mp[(kf_mp >= 0) & fv])
            mp_new = [int(s) for s in cand_mp if mp_valid[s]
                      and int(s) not in book.sent_foreign_mp][:mp_budget]
        if mp_new:
            msl = np.asarray(mp_new)
            fmp = protocol.ForeignMPPayload(
                server_id=msl.astype(np.int32), owner=snap["mp_agent"][msl],
                pos_abs=snap["mp_pos"][msl],
                desc=fetch(dict(desc=self.m.mp_desc[self._up(msl.astype(np.int64))]))["desc"])
            book.sent_foreign_mp.update(mp_new)
            if book.f_mp_down is None:
                book.f_mp_down = np.full((self.m.max_mp, 3), np.inf, np.float32)
            book.f_mp_down[msl] = snap["mp_pos"][msl]
        return fkf, fmp
