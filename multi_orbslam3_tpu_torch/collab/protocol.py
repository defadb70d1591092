"""Map-delta wire protocol.

Replaces the reference's msg/*.msg schema (Map.msg envelope with KF[],
KFred[], MP[], MPred[], erasure lists — SURVEY.md §2.4) with numpy
struct-of-arrays payloads. Semantics preserved from the reference:

- **Relative-pose encoding with fallback chain**: each KF pose is shipped
  relative to its predecessor, with the pred-of-pred and spanning-tree
  parent as fallbacks (KeyFrame.cc:1584-1618). The receiver resolves the
  first reference it already has and *drops* the message otherwise
  (KeyFrame.cc:2359-2363) — late/lost messages never corrupt the map.
- **Pose locks**: server->client pose updates carry `locked`; the client
  applies only locked updates (KeyFrame.cc:2143-2144) — server wins after
  optimization, client wins for fresh odometry.
- **Erasure tombstones**: erased ids travel in the envelope so late
  arrivals are dropped cleanly (Map.cc:185-236).

Serialization: `to_bytes`/`from_bytes` pack the arrays with the mo3
codec (collab/codec.py — native C++ array-table format with CRC32
integrity and zero-copy decode; pure-Python twin of the identical wire
format as fallback). A corrupted/truncated frame raises at decode, the
receiver drops it, and the sender's unacked-outbox resend covers the
loss. Legacy np.savez payloads are still readable.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Dict, List, Optional

import numpy as np

from multi_orbslam3_tpu_torch.collab import codec


@dataclasses.dataclass
class KFPayload:
    """Full keyframes (KF.msg analog), SoA over B keyframes."""
    agent: int
    local_id: np.ndarray        # (B,) int32 sender-local slot ids
    timestamp: np.ndarray       # (B,)
    # relative pose chain: T_this_from_ref for up to 3 candidate refs
    ref_ids: np.ndarray         # (B, 3) int32 local ids (pred, predpred, parent), -1 none
    T_rel: np.ndarray           # (B, 3, 4, 4) pose relative to each ref
    T_abs: np.ndarray           # (B, 4, 4) absolute pose (first-KF bootstrap)
    is_first: np.ndarray        # (B,) bool — no reference exists (map origin)
    uv: np.ndarray              # (B, N, 2)
    desc: np.ndarray            # (B, N, 8) uint32
    level: np.ndarray           # (B, N) int32
    angle: np.ndarray           # (B, N)
    feat_valid: np.ndarray      # (B, N) bool
    mp_local: np.ndarray        # (B, N) int32 sender-local MP id per feature
    # cross-agent associations: server arena slot of a FOREIGN landmark
    # this feature tracks (-1 none). The reference's KF.msg association
    # triplets carry (id, ClientId) pairs for exactly this reason — a
    # keyframe may observe another agent's landmark, and those
    # observations are what lets the server's global BA align the agents'
    # arcs after a merge (msg/KF.msg mvpMapPoints_ClientIds).
    mp_server: Optional[np.ndarray] = None      # (B, N) int32
    # inertial uplink (reference ships mpImuPreintegrated + velocity inside
    # KF messages so the server can run FullInertialBA and merge windows on
    # culling): (B, FLAT_DIM + 3) = flattened Preintegrated (prev own KF ->
    # this KF; dT == 0 marks "no window") followed by the world-frame body
    # velocity at this KF. None for visual-only senders.
    imu: Optional[np.ndarray] = None


@dataclasses.dataclass
class KFUpdatePayload:
    """Pose updates (KFred.msg analog). Client->server updates may carry
    the keyframe's CURRENT landmark-association row (KFred.msg ships MP
    association triplets the same way): the client's local mapping keeps
    attaching landmarks to older keyframes (fuse), and without re-shipping
    those rows the server's observation counts stagnate at creation level
    and its culling starves the arena."""
    agent: int
    local_id: np.ndarray        # (B,)
    T_abs: np.ndarray           # (B, 4, 4)
    locked: np.ndarray          # (B,) bool — mbPoseLock
    mp_local: Optional[np.ndarray] = None   # (B, N) sender-local mp ids
    mp_server: Optional[np.ndarray] = None  # (B, N) foreign assoc (server slots)


@dataclasses.dataclass
class MPPayload:
    """Full map points (MP.msg analog)."""
    agent: int
    local_id: np.ndarray        # (B,)
    ref_kf_local: np.ndarray    # (B,) int32 local id of reference KF
    pos_rel: np.ndarray         # (B, 3) position in reference-KF camera frame
    pos_abs: np.ndarray         # (B, 3) absolute (fallback)
    desc: np.ndarray            # (B, 8) uint32


@dataclasses.dataclass
class MPUpdatePayload:
    """Position-only updates (MPred.msg analog)."""
    agent: int
    local_id: np.ndarray
    pos_abs: np.ndarray
    locked: np.ndarray


@dataclasses.dataclass
class ForeignKFPayload:
    """Full OTHER-agent keyframes shipped server->client (reference
    KeyFrame::ConvertToMessageServer, KeyFrame.cc:1765-1807 — full
    payloads for entities the receiving client has never seen; they are
    what lets a client track/relocalize against another agent's map after
    a merge). Identity is the server arena slot."""
    server_id: np.ndarray       # (B,) int32 server arena slots
    owner: np.ndarray           # (B,) int32 owning agent per KF
    timestamp: np.ndarray       # (B,)
    T_abs: np.ndarray           # (B, 4, 4) pose in the merged frame
    uv: np.ndarray              # (B, N, 2)
    desc: np.ndarray            # (B, N, 8) uint32
    level: np.ndarray           # (B, N) int32
    angle: np.ndarray           # (B, N)
    feat_valid: np.ndarray      # (B, N) bool
    mp_server: np.ndarray       # (B, N) int32 server MP slot per feature
    cam: Optional[np.ndarray] = None   # (B, 4) owner's rectified pinhole
    # (fx, fy, cx, cy) — heterogeneous agents (ClientHandler.cc:26-66)


@dataclasses.dataclass
class ForeignMPPayload:
    """Other-agent landmarks (full payload, server slot identity)."""
    server_id: np.ndarray       # (B,) int32
    owner: np.ndarray           # (B,) int32
    pos_abs: np.ndarray         # (B, 3)
    desc: np.ndarray            # (B, 8) uint32


@dataclasses.dataclass
class ForeignKFUpdatePayload:
    """Pose-only refresh of foreign keyframes already shipped (the
    reference downlink re-sends KFred updates for every vicinity entity,
    other agents' included — PublishMapServer, Communicator.cc:1150-1228;
    without these the client's foreign copies go stale the moment a GBA
    or pose-graph correction moves the arena)."""
    server_id: np.ndarray       # (B,) int32
    T_abs: np.ndarray           # (B, 4, 4)


@dataclasses.dataclass
class ForeignMPUpdatePayload:
    """Position-only refresh of foreign landmarks already shipped
    (MPred analog for other agents' entities)."""
    server_id: np.ndarray       # (B,) int32
    pos_abs: np.ndarray         # (B, 3)


def peek_seq(data: bytes) -> int:
    """Envelope seq of a wire frame WITHOUT decoding the array table
    (CRC-validated). Raises ValueError on corrupted/unknown frames."""
    if data[:4] == b"MO3C":
        return int(codec.peek_meta(data)["seq"])
    return MapDelta.from_bytes(data).seq    # legacy savez payload


@dataclasses.dataclass
class MapDelta:
    """The per-cycle envelope (Map.msg analog)."""
    agent: int
    seq: int = 0                                # mMsgId analog
    kfs: Optional[KFPayload] = None
    kf_updates: Optional[KFUpdatePayload] = None
    mps: Optional[MPPayload] = None
    mp_updates: Optional[MPUpdatePayload] = None
    foreign_kfs: Optional[ForeignKFPayload] = None
    foreign_mps: Optional[ForeignMPPayload] = None
    foreign_kf_updates: Optional[ForeignKFUpdatePayload] = None
    foreign_mp_updates: Optional[ForeignMPUpdatePayload] = None
    erased_kf: Optional[np.ndarray] = None      # (E,) int32 local ids
    erased_mp: Optional[np.ndarray] = None
    # server->client revocation of FOREIGN entities previously shipped in
    # the vicinity downlink and since culled server-side (the reference's
    # erasure flow covers every map consumer, Communicator.cc:309-354);
    # ids are SERVER slots, the client resolves them via its foreign maps
    foreign_erased_kf: Optional[np.ndarray] = None
    foreign_erased_mp: Optional[np.ndarray] = None
    closest_kf: int = -1                        # client's current ref KF
    # IMU-init gauge handoff (mScale/mRgw analog, Map.cc:497-503)
    scale: float = 1.0
    R_gw: Optional[np.ndarray] = None           # (3, 3)
    inertial: bool = False                      # sender runs VI odometry
    # camera->body extrinsics of the sending agent (ImuCalib.T_bc; the
    # server needs it to evaluate preintegration factors in FullInertialBA)
    T_bc: Optional[np.ndarray] = None           # (4, 4)
    # the sending agent's (rectified) pinhole intrinsics (fx, fy, cx, cy)
    # — per-client camera model (reference builds Pinhole/KannalaBrandt8
    # per client from Server/Camera_* params, ClientHandler.cc:26-66;
    # KB8 clients rectify to an ideal pinhole at extraction, so the wire
    # model is always pinhole)
    cam: Optional[np.ndarray] = None            # (4,)
    # reliability: server->client cumulative ack of in-order-processed
    # uplink seq (the reference's open-ack lists, Communicator.h:162-165)
    ack_seq: int = -1
    # server->client EXACT event gauge (the ClientHandler
    # mg2oS_wcurmap_wclientmap handoff, src/ClientHandler.h:24): the
    # CUMULATIVE Sim3 the server has applied to this client's sub-map
    # through merges — semantics: poses T' = T o G, landmarks
    # p' = G^-1(p); layout [s, R row-major 9, t 3] (13,) float64. The
    # client tracks the epoch it last applied and applies only the
    # remainder, so a lost downlink frame cannot desynchronize gauges.
    gauge_down: Optional[np.ndarray] = None
    gauge_epoch: int = 0

    def to_bytes(self) -> bytes:
        arrays: Dict[str, np.ndarray] = {}
        meta = {"agent": self.agent, "seq": self.seq,
                "closest_kf": self.closest_kf, "scale": self.scale,
                "inertial": self.inertial, "ack_seq": self.ack_seq,
                "gauge_epoch": self.gauge_epoch}
        for name in ("kfs", "kf_updates", "mps", "mp_updates",
                     "foreign_kfs", "foreign_mps",
                     "foreign_kf_updates", "foreign_mp_updates"):
            obj = getattr(self, name)
            if obj is None:
                continue
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if v is None:
                    continue
                if isinstance(v, np.ndarray):
                    arrays[f"{name}.{f.name}"] = v
                else:
                    meta[f"{name}.{f.name}"] = v
        if self.erased_kf is not None:
            arrays["erased_kf"] = self.erased_kf
        if self.erased_mp is not None:
            arrays["erased_mp"] = self.erased_mp
        if self.foreign_erased_kf is not None:
            arrays["foreign_erased_kf"] = self.foreign_erased_kf
        if self.foreign_erased_mp is not None:
            arrays["foreign_erased_mp"] = self.foreign_erased_mp
        if self.R_gw is not None:
            arrays["R_gw"] = self.R_gw
        if self.T_bc is not None:
            arrays["T_bc"] = self.T_bc
        if self.cam is not None:
            arrays["cam"] = self.cam
        if self.gauge_down is not None:
            arrays["gauge_down"] = self.gauge_down
        return codec.pack(meta, arrays)

    @classmethod
    def from_bytes(cls, data: bytes) -> "MapDelta":
        if data[:4] == b"MO3C":
            meta, arrays = codec.unpack(data)
            arrays = dict(arrays)
        else:   # legacy np.savez payload (pre-codec checkpoints/captures)
            try:
                import ast
                with np.load(io.BytesIO(data)) as z:
                    arrays = {k: z[k] for k in z.files}
                meta = ast.literal_eval(
                    bytes(arrays.pop("__meta__")).decode())
            except Exception as e:      # noqa: BLE001 — any malformed frame
                raise ValueError(f"undecodable frame: {e}") from e

        def build(name, klass):
            fields = {f.name for f in dataclasses.fields(klass)}
            sub_a = {k.split(".", 1)[1]: v for k, v in arrays.items()
                     if k.startswith(name + ".")}
            sub_m = {k.split(".", 1)[1]: v for k, v in meta.items()
                     if isinstance(k, str) and k.startswith(name + ".")}
            if not sub_a and not sub_m:
                return None
            kw = {**sub_a, **sub_m}
            return klass(**{k: v for k, v in kw.items() if k in fields})

        return cls(agent=meta["agent"], seq=meta["seq"],
                   closest_kf=meta["closest_kf"], scale=meta["scale"],
                   inertial=meta.get("inertial", False),
                   ack_seq=meta.get("ack_seq", -1),
                   kfs=build("kfs", KFPayload),
                   kf_updates=build("kf_updates", KFUpdatePayload),
                   mps=build("mps", MPPayload),
                   mp_updates=build("mp_updates", MPUpdatePayload),
                   foreign_kfs=build("foreign_kfs", ForeignKFPayload),
                   foreign_mps=build("foreign_mps", ForeignMPPayload),
                   foreign_kf_updates=build("foreign_kf_updates",
                                            ForeignKFUpdatePayload),
                   foreign_mp_updates=build("foreign_mp_updates",
                                            ForeignMPUpdatePayload),
                   erased_kf=arrays.get("erased_kf"),
                   erased_mp=arrays.get("erased_mp"),
                   foreign_erased_kf=arrays.get("foreign_erased_kf"),
                   foreign_erased_mp=arrays.get("foreign_erased_mp"),
                   R_gw=arrays.get("R_gw"), T_bc=arrays.get("T_bc"),
                   cam=arrays.get("cam"),
                   gauge_down=arrays.get("gauge_down"),
                   gauge_epoch=meta.get("gauge_epoch", 0))
