"""MapState: the device-resident SLAM map and its functional updates
(counterpart of multi_orbslam3_tpu/map/mapstate.py).

Every update returns new tensors and leaves its input map untouched: the
fused tracking step and the deferred mapping chain keep an old map and a
new one side by side, so mutating a map that is still referenced would be
a bug. Writes that must skip some rows go to a sacrificial extra row that
is sliced off afterwards, so a skipped row can never collide with a real
write (JAX's ``.at[].set`` with a parked duplicate index leaves the winner
unspecified). No function here reads a value back to the host.

Descriptor words are int32 bit patterns of the JAX package's uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.frontend.kernels import popcount32
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import sim3

NO_MP = -1

_I32 = torch.int32
_F32 = torch.float32


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor         # (K, 4, 4) T_cw
    kf_valid: torch.Tensor        # (K,) bool
    kf_map_id: torch.Tensor       # (K,) int32 sub-map id
    kf_timestamp: torch.Tensor    # (K,) float32
    kf_agent: torch.Tensor        # (K,) int32
    kf_parent: torch.Tensor       # (K,) int32 spanning-tree parent (-1 root)
    kf_pose_locked: torch.Tensor  # (K,) bool
    kf_uv: torch.Tensor           # (K, N, 2) undistorted keypoints
    kf_desc: torch.Tensor         # (K, N, 8) int32 descriptor words
    kf_level: torch.Tensor        # (K, N) int32
    kf_angle: torch.Tensor        # (K, N) float32
    kf_feat_valid: torch.Tensor   # (K, N) bool
    kf_mp: torch.Tensor           # (K, N) int32 map-point slot or NO_MP
    kf_ur: torch.Tensor           # (K, N) f32 stereo right-u (-1 mono)
    kf_cam: torch.Tensor          # (K, 4) f32 per-KF pinhole; 0 = default
    # --- map points ---
    mp_pos: torch.Tensor          # (P, 3)
    mp_valid: torch.Tensor        # (P,) bool
    mp_map_id: torch.Tensor       # (P,) int32
    mp_agent: torch.Tensor        # (P,) int32
    mp_desc: torch.Tensor         # (P, 8) int32
    mp_normal: torch.Tensor       # (P, 3)
    mp_min_dist: torch.Tensor     # (P,)
    mp_max_dist: torch.Tensor     # (P,)
    mp_ref_kf: torch.Tensor       # (P,) int32
    mp_found: torch.Tensor        # (P,) int32
    mp_visible: torch.Tensor      # (P,) int32
    mp_redirect: torch.Tensor     # (P,) int32 fusion forwarding pointer
    # --- counters (0-d int32 tensors on the map's device) ---
    n_kf: torch.Tensor
    n_mp: torch.Tensor
    active_map: torch.Tensor

    @property
    def max_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_uv.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_pose.device


def empty_map(max_kf: int, max_mp: int, n_feat: int, device=None) -> MapState:
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_pose=torch.eye(4, dtype=_F32, device=device).repeat(max_kf, 1, 1),
        kf_valid=z(max_kf, torch.bool),
        kf_map_id=z(max_kf, _I32),
        kf_timestamp=z(max_kf, _F32),
        kf_agent=z(max_kf, _I32),
        kf_parent=full((max_kf,), -1, _I32),
        kf_pose_locked=z(max_kf, torch.bool),
        kf_uv=z((max_kf, n_feat, 2), _F32),
        kf_desc=z((max_kf, n_feat, 8), _I32),
        kf_level=z((max_kf, n_feat), _I32),
        kf_angle=z((max_kf, n_feat), _F32),
        kf_feat_valid=z((max_kf, n_feat), torch.bool),
        kf_mp=full((max_kf, n_feat), NO_MP, _I32),
        kf_ur=full((max_kf, n_feat), -1.0, _F32),
        kf_cam=z((max_kf, 4), _F32),
        mp_pos=z((max_mp, 3), _F32),
        mp_valid=z(max_mp, torch.bool),
        mp_map_id=z(max_mp, _I32),
        mp_agent=z(max_mp, _I32),
        mp_desc=z((max_mp, 8), _I32),
        mp_normal=z((max_mp, 3), _F32),
        mp_min_dist=z(max_mp, _F32),
        mp_max_dist=z(max_mp, _F32),
        mp_ref_kf=full((max_mp,), -1, _I32),
        mp_found=z(max_mp, _I32),
        mp_visible=z(max_mp, _I32),
        mp_redirect=full((max_mp,), -1, _I32),
        n_kf=z((), _I32),
        n_mp=z((), _I32),
        active_map=z((), _I32),
    )


def scatter_rows(arr: torch.Tensor, idx: torch.Tensor, write: torch.Tensor,
                 vals) -> torch.Tensor:
    """Copy of `arr` with arr[idx[b]] = vals[b] where write[b]; rows with
    write False land in a sacrificial extra row that is dropped."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]], dim=0)
    tgt = torch.where(write, idx.long(), n)
    shape = (tgt.shape[0],) + arr.shape[1:]
    if isinstance(vals, torch.Tensor):
        vals = vals.to(arr.dtype).expand(shape)
    else:   # a Python scalar is filled on the device, never copied over
        vals = torch.full(shape, vals, dtype=arr.dtype, device=arr.device)
    return ext.index_put((tgt,), vals)[:n]


def take(x: torch.Tensor, k) -> torch.Tensor:
    """x[k] for a slot k given as an int or an index tensor of any shape.
    A 0-d device tensor is gathered with index_select: indexing with it
    directly would read it back to the host and stall the stream."""
    if isinstance(k, torch.Tensor):
        return x.index_select(0, k.reshape(-1).long()).reshape(k.shape + x.shape[1:])
    return x[k]


def as_index(x, device) -> torch.Tensor:
    """A slot given as a Python int or a tensor -> 0-d int64 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(x), dtype=torch.int64, device=device)


def add_keyframe(m: MapState, feats: FrameFeatures, pose: torch.Tensor,
                 timestamp, mp_assoc: torch.Tensor, parent,
                 agent=0, u_r=None, cam4=None) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe at the next free slot. mp_assoc: (N,) landmark slot
    per feature. Returns (new_map, kf_slot) with slot -1 when full."""
    dev = m.device
    if u_r is None:
        u_r = torch.full((m.n_feat,), -1.0, dtype=_F32, device=dev)
    if cam4 is None:
        cam4 = torch.zeros(4, dtype=_F32, device=dev)
    k = m.n_kf
    in_cap = (k < m.max_kf).reshape(1)
    idx = torch.clamp(k, max=m.max_kf - 1).reshape(1)

    def put(arr, val):
        if isinstance(val, torch.Tensor):
            val = val.to(dev)
        return scatter_rows(arr, idx, in_cap, val)

    m = m._replace(
        kf_pose=put(m.kf_pose, pose),
        kf_valid=put(m.kf_valid, True),
        kf_map_id=put(m.kf_map_id, m.active_map),
        kf_timestamp=put(m.kf_timestamp, float(timestamp)),
        kf_agent=put(m.kf_agent, int(agent)),
        kf_parent=put(m.kf_parent, parent if isinstance(parent, torch.Tensor)
                      else int(parent)),
        kf_uv=put(m.kf_uv, feats.uv_und),
        kf_desc=put(m.kf_desc, feats.desc),
        kf_level=put(m.kf_level, feats.level),
        kf_angle=put(m.kf_angle, feats.angle),
        kf_feat_valid=put(m.kf_feat_valid, feats.valid),
        kf_mp=put(m.kf_mp, mp_assoc),
        kf_ur=put(m.kf_ur, u_r),
        kf_cam=put(m.kf_cam, cam4),
        n_kf=torch.where(in_cap[0], k + 1, k),
    )
    return m, torch.where(in_cap[0], k, -1)


def add_keyframes_batch(m: MapState, poses: torch.Tensor, timestamps: torch.Tensor,
                        agents: torch.Tensor, parents: torch.Tensor,
                        assocs: torch.Tensor, uv: torch.Tensor, desc: torch.Tensor,
                        level: torch.Tensor, angle: torch.Tensor,
                        feat_valid: torch.Tensor, count,
                        cams=None) -> tuple[MapState, torch.Tensor]:
    """Insert up to B keyframes at consecutive slots in one pass (the
    server's ingest). All inputs are (B, ...); only rows [0, count) are
    real, the rest go to the sacrificial row. Returns (map, slots (B,)
    int32, -1 for padding and over-capacity rows)."""
    B = poses.shape[0]
    dev = m.device
    if cams is None:
        cams = torch.zeros((B, 4), dtype=_F32, device=dev)
    idx = torch.arange(B, dtype=_I32, device=dev)
    slots = m.n_kf + idx
    ok = (idx < count) & (slots < m.max_kf)

    def scat(arr, vals):
        return scatter_rows(arr, slots, ok, vals.to(dev))

    m = m._replace(
        kf_pose=scat(m.kf_pose, poses),
        kf_valid=scat(m.kf_valid, torch.ones(B, dtype=torch.bool, device=dev)),
        kf_map_id=scat(m.kf_map_id, m.active_map.expand(B)),
        kf_timestamp=scat(m.kf_timestamp, timestamps),
        kf_agent=scat(m.kf_agent, agents),
        kf_parent=scat(m.kf_parent, parents),
        kf_uv=scat(m.kf_uv, uv),
        kf_desc=scat(m.kf_desc, desc),
        kf_level=scat(m.kf_level, level),
        kf_angle=scat(m.kf_angle, angle),
        kf_feat_valid=scat(m.kf_feat_valid, feat_valid),
        kf_mp=scat(m.kf_mp, assocs),
        kf_ur=scat(m.kf_ur, torch.full((B, m.n_feat), -1.0, dtype=_F32, device=dev)),
        kf_cam=scat(m.kf_cam, cams),
        n_kf=m.n_kf + torch.sum(ok.to(_I32)).to(_I32),
    )
    return m, torch.where(ok, slots, -1)


def _scatter_kf_mp(kf_mp: torch.Tensor, kf, feat: torch.Tensor,
                   write: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """kf_mp[kf, feat[b]] = vals[b] where write[b] (flat sacrificial cell)."""
    K, N = kf_mp.shape
    flat = as_index(kf, kf_mp.device) * N + feat.long()
    out = scatter_rows(kf_mp.reshape(-1), flat, write, vals.to(_I32))
    return out.reshape(K, N)


def add_mappoints(m: MapState, pos: torch.Tensor, ok: torch.Tensor,
                  desc: torch.Tensor, ref_kf, kf_a, feat_a: torch.Tensor,
                  kf_b, feat_b: torch.Tensor, agent=0) -> tuple[MapState, torch.Tensor]:
    """Batch-insert up to B new landmarks observed in kf_a and kf_b.
    Returns (new_map, slots (B,) int32, -1 where not created)."""
    B = pos.shape[0]
    okc = ok.to(_I32)
    offset = torch.cumsum(okc, 0, dtype=_I32) - 1
    slots = torch.where(ok, m.n_mp + offset, NO_MP)
    write = (slots >= 0) & (slots < m.max_mp)
    slots = torch.where(write, slots, NO_MP)

    ref = as_index(ref_kf, m.device)
    T_ref = take(m.kf_pose, ref)
    R = T_ref[:3, :3]
    t = T_ref[:3, 3]
    cam_center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    view = pos - cam_center
    dist = torch.linalg.norm(view, dim=-1) + 1e-8
    normal = view / dist[:, None]

    def upd(arr, val):
        return scatter_rows(arr, slots, write, val)

    m = m._replace(
        mp_pos=upd(m.mp_pos, pos),
        mp_valid=upd(m.mp_valid, True),
        mp_map_id=upd(m.mp_map_id, m.active_map.expand(B)),
        mp_agent=upd(m.mp_agent, int(agent)),
        mp_desc=upd(m.mp_desc, desc),
        mp_normal=upd(m.mp_normal, normal),
        mp_min_dist=upd(m.mp_min_dist, dist * 0.5),
        mp_max_dist=upd(m.mp_max_dist, dist * 2.0),
        mp_ref_kf=upd(m.mp_ref_kf, ref.to(_I32).expand(B)),
        n_mp=torch.clamp(m.n_mp + torch.sum(okc), max=m.max_mp).to(_I32),
    )
    kfmp = _scatter_kf_mp(m.kf_mp, kf_a, feat_a, write, slots)
    kfmp = _scatter_kf_mp(kfmp, kf_b, feat_b, write, slots)
    return m._replace(kf_mp=kfmp), slots


def add_mappoints_raw(m: MapState, pos: torch.Tensor, ok: torch.Tensor,
                      desc: torch.Tensor, ref_kf: torch.Tensor,
                      agent=0) -> tuple[MapState, torch.Tensor]:
    """Batch-insert landmarks without writing feature associations (the
    network-ingest path: associations arrive with the keyframes). ref_kf
    (B,) is each landmark's reference keyframe slot. Returns (map, slots
    (B,) int32, -1 where not created)."""
    dev = m.device
    pos, ok, desc = pos.to(dev), ok.to(dev), desc.to(dev)
    ref_kf = ref_kf.to(dev)
    B = pos.shape[0]
    okc = ok.to(_I32)
    offset = torch.cumsum(okc, 0, dtype=_I32) - 1
    slots = torch.where(ok, m.n_mp + offset, NO_MP)
    write = (slots >= 0) & (slots < m.max_mp)
    slots = torch.where(write, slots, NO_MP)

    ref_safe = torch.clamp(ref_kf, 0, m.max_kf - 1).long()
    R = m.kf_pose[ref_safe, :3, :3]
    t = m.kf_pose[ref_safe, :3, 3]
    cam_center = -torch.einsum("bji,bj->bi", R, t)
    view = pos - cam_center
    dist = torch.linalg.norm(view, dim=-1) + 1e-8

    def upd(arr, val):
        return scatter_rows(arr, slots, write, val)

    m = m._replace(
        mp_pos=upd(m.mp_pos, pos),
        mp_valid=upd(m.mp_valid, True),
        mp_map_id=upd(m.mp_map_id, m.active_map.expand(B)),
        mp_agent=upd(m.mp_agent, int(agent)),
        mp_desc=upd(m.mp_desc, desc),
        mp_normal=upd(m.mp_normal, view / dist[:, None]),
        mp_min_dist=upd(m.mp_min_dist, dist * 0.5),
        mp_max_dist=upd(m.mp_max_dist, dist * 2.0),
        mp_ref_kf=upd(m.mp_ref_kf, ref_kf),
        n_mp=torch.clamp(m.n_mp + torch.sum(okc), max=m.max_mp).to(_I32))
    return m, slots


def add_mappoints_raw_padded(m: MapState, pos, ok, desc, ref_kf,
                             agent=0) -> tuple[MapState, torch.Tensor]:
    """The JAX package pads the batch to a power-of-two shape class to
    bound its compilations; padding rows create nothing, so here this is
    add_mappoints_raw on the batch as given. Returns slots of the rows."""
    return add_mappoints_raw(m, pos, ok, desc, ref_kf, agent)


def kf_intrinsics(m: MapState, kf, K_default: cam.PinholeK) -> cam.PinholeK:
    """Per-keyframe pinhole intrinsics; an all-zero kf_cam row means the
    caller's default camera. `kf` may be a slot or an index tensor."""
    row = take(m.kf_cam, kf)
    have = row[..., 0] > 0
    return cam.PinholeK(
        fx=torch.where(have, row[..., 0], K_default.fx),
        fy=torch.where(have, row[..., 1], K_default.fy),
        cx=torch.where(have, row[..., 2], K_default.cx),
        cy=torch.where(have, row[..., 3], K_default.cy))


def covisibility_row(m: MapState, kf) -> torch.Tensor:
    """(K,) int32 shared-landmark counts between keyframe `kf` and every
    keyframe (0 for `kf` itself)."""
    return covisibility_rows(m, as_index(kf, m.device).reshape(1))[0]


def covisibility_rows(m: MapState, kfs: torch.Tensor) -> torch.Tensor:
    """covisibility_row for a batch of keyframes (A,) in one pass: (A, K)
    int32, a row's own keyframe 0. Negative slots count as slot 0."""
    P = m.max_mp
    kfs = torch.clamp(kfs.to(m.device).long(), min=0)
    row_kf = m.kf_mp[kfs]                                       # (A, N)
    row_ok = (row_kf >= 0) & m.kf_feat_valid[kfs]
    member = torch.zeros((kfs.shape[0], P + 1), dtype=_F32, device=m.device)
    member = member.scatter_reduce(1, torch.where(row_ok, row_kf, P).long(),
                                   row_ok.to(_F32), "amax", include_self=True)
    member = member * torch.cat([m.mp_valid, m.mp_valid.new_zeros(1)]).to(_F32)
    ok = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    slot = torch.where(ok, m.kf_mp, P).long()                   # (K, N)
    counts = torch.sum(member[:, slot], dim=2).to(_I32)         # (A, K)
    return counts.scatter(1, kfs[:, None], 0)


def kf_mp_mask(m: MapState) -> torch.Tensor:
    """(K, P) bool: keyframe k observes valid landmark p."""
    K, N = m.kf_mp.shape
    P = m.max_mp
    ok = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    rows = torch.arange(K, device=m.device).repeat_interleave(N)
    cols = torch.where(ok, m.kf_mp, P).reshape(-1).long()   # P: sacrificial
    mask = torch.zeros((K, P + 1), dtype=torch.bool, device=m.device)
    mask = mask.index_put((rows, cols), torch.ones_like(cols, dtype=torch.bool))
    return mask[:, :P] & m.mp_valid[None, :]


def covisibility_matrix(m: MapState, chunk: int = 8192) -> torch.Tensor:
    """(K, K) int32 shared-landmark counts (0 on the diagonal), W = A A^T
    over the observation mask A, with the landmark axis in chunks: each
    chunk's (K, chunk) block of A is built as bool straight from kf_mp and
    cast to float32 for its product, so the whole (K, P) mask never exists.
    The JAX package multiplies in bf16 with a float32 result; a bf16 torch
    matmul returns bf16, which rounds counts above 256, so the products run
    in float32 (TF32 is off package-wide): every count is an exact integer
    below 2^24. At the 4-agent arena (2,048 keyframes x 1,024 features,
    65,536 landmarks) the call's peak above the map is 148 MiB on an H100,
    against 820 MiB in one chunk (profiling/profile_covis.py)."""
    K, N = m.kf_mp.shape
    P = m.max_mp
    ok = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    rows = torch.arange(K, device=m.device).repeat_interleave(N)
    W = torch.zeros((K, K), dtype=_F32, device=m.device)
    for c0 in range(0, P, chunk):
        width = min(chunk, P - c0)
        inside = ok & (m.kf_mp >= c0) & (m.kf_mp < c0 + width)
        cols = torch.where(inside, m.kf_mp - c0, width).reshape(-1).long()
        A = torch.zeros((K, width + 1), dtype=torch.bool, device=m.device)
        A = A.index_put((rows, cols), torch.ones_like(cols, dtype=torch.bool))
        A = (A[:, :width] & m.mp_valid[None, c0:c0 + width]).to(_F32)
        W = W + A @ A.T
    return (W - torch.diag(torch.diagonal(W))).to(_I32)


def erase_keyframe(m: MapState, kf) -> MapState:
    """Tombstone keyframe `kf` (an int or a 0-d tensor): its associations
    are dropped and its children re-parent to its parent."""
    kf = as_index(kf, m.device)
    one = torch.ones(1, dtype=torch.bool, device=m.device)
    parent = take(m.kf_parent, kf)
    return m._replace(
        kf_valid=scatter_rows(m.kf_valid, kf.reshape(1), one, False),
        kf_mp=scatter_rows(m.kf_mp, kf.reshape(1), one, NO_MP),
        kf_parent=torch.where(m.kf_parent == kf, parent, m.kf_parent))


def erase_mappoints(m: MapState, slots: torch.Tensor) -> MapState:
    """Tombstone landmarks: clear validity and every keyframe association.
    slots (B,), -1 entries ignored."""
    slots = slots.to(m.device)
    ok = slots >= 0
    P = m.max_mp
    mp_valid = scatter_rows(m.mp_valid, slots, ok, False)
    erased = scatter_rows(torch.zeros(P + 1, dtype=torch.bool, device=m.device),
                          slots, ok, True)
    point = torch.where(m.kf_mp >= 0, m.kf_mp, P).long()
    return m._replace(mp_valid=mp_valid,
                      kf_mp=torch.where(erased[point], NO_MP, m.kf_mp))


def update_found_visible(m: MapState, feat_mp: torch.Tensor,
                         visible: torch.Tensor) -> MapState:
    """Per-frame landmark statistics: found += 1 for each inlier landmark,
    visible += 1 for each valid landmark in the frame's frustum."""
    ok = feat_mp >= 0
    found = m.mp_found.index_add(0, torch.where(ok, feat_mp, 0).long(),
                                 ok.to(_I32))
    vis = m.mp_visible + (visible & m.mp_valid).to(_I32)
    return m._replace(mp_found=found, mp_visible=vis)


def popcount_pairs(D: torch.Tensor) -> torch.Tensor:
    """(..., O, 8) words -> (..., O, O) Hamming distances between rows."""
    acc = None
    for wd in range(D.shape[-1]):
        x = popcount32(D[..., :, None, wd] ^ D[..., None, :, wd])
        acc = x if acc is None else acc + x
    return acc


def refresh_point_stats(m: MapState, kf_slots: torch.Tensor,
                        slot_ok: torch.Tensor, *, max_obs: int = 8,
                        scale_factor: float = 1.2,
                        n_levels: int = 8) -> MapState:
    """Recompute representative descriptor (min median Hamming over up to
    `max_obs` observations), mean viewing normal and scale-invariance
    range for every landmark observed by the window keyframes."""
    dev = m.device
    kf_slots = kf_slots.long()
    Kw = kf_slots.shape[0]
    N = m.n_feat
    P = m.max_mp
    F = Kw * N

    flat_mp = torch.where(slot_ok[:, None], m.kf_mp[kf_slots], NO_MP)
    flat_mp = torch.where(m.kf_feat_valid[kf_slots], flat_mp, NO_MP).reshape(-1)
    flat_kf = kf_slots.repeat_interleave(N)
    flat_desc = m.kf_desc[kf_slots].reshape(F, 8)
    flat_level = m.kf_level[kf_slots].reshape(F)

    R = m.kf_pose[kf_slots, :3, :3]
    t = m.kf_pose[kf_slots, :3, 3]
    centers = -(R.transpose(-1, -2) @ t[..., None])[..., 0]     # (Kw, 3)
    flat_center = centers.repeat_interleave(N, dim=0)
    mp_safe = torch.where(flat_mp >= 0, flat_mp, 0).long()
    view = m.mp_pos[mp_safe] - flat_center
    dist = torch.linalg.norm(view, dim=-1) + 1e-8
    nrm = view / dist[:, None]

    valid = flat_mp >= 0
    key = torch.where(valid, flat_mp, P).long()

    # normals: masked segment mean over all window observations
    w = valid.to(_F32)
    nsum = torch.zeros((P + 1, 3), dtype=_F32, device=dev).index_add(
        0, key, nrm * w[:, None])
    cnt = torch.zeros(P + 1, dtype=_F32, device=dev).index_add(0, key, w)
    touched = cnt[:P] > 0
    new_normal = nsum[:P] / torch.clamp(cnt[:P, None], min=1.0)
    new_normal = new_normal / (
        torch.linalg.norm(new_normal, dim=-1, keepdim=True) + 1e-8)

    # depth range from the reference-KF observation only
    is_ref = valid & (flat_kf == m.mp_ref_kf[mp_safe].long())
    ref_key = torch.where(is_ref, flat_mp, P).long()
    ref_dist = torch.zeros(P + 1, dtype=_F32, device=dev).scatter_reduce(
        0, ref_key, torch.where(is_ref, dist, 0.0), "amax", include_self=True)
    ref_level = torch.zeros(P + 1, dtype=_I32, device=dev).scatter_reduce(
        0, ref_key, torch.where(is_ref, flat_level, 0), "amax", include_self=True)
    has_ref = ref_dist[:P] > 0
    level_sf = torch.pow(float(scale_factor), ref_level[:P].to(_F32))
    max_d = ref_dist[:P] * level_sf
    min_d = max_d / float(scale_factor ** (n_levels - 1))

    # representative descriptor: rank of each observation in its landmark's
    # group (stable sort by slot), a (P, max_obs) table, min-median Hamming
    order = torch.argsort(key, stable=True)
    skey = key[order]
    pos = torch.arange(F, device=dev)
    prev = torch.cat([skey.new_full((1,), -2), skey[:-1]])
    group_start = torch.where(skey != prev, pos, 0)
    group_start = torch.cummax(group_start, dim=0).values
    rank = pos - group_start
    in_tab = (skey < P) & (rank < max_obs)
    tab = torch.full(((P + 1) * max_obs,), F, dtype=torch.int64, device=dev)
    cell = torch.where(in_tab, skey * max_obs + rank, P * max_obs)
    tab = tab.index_put((cell,), torch.where(in_tab, order, F))
    tab = tab.reshape(P + 1, max_obs)[:P]
    tab_ok = tab < F
    desc_ext = torch.cat([flat_desc, flat_desc.new_zeros((1, 8))], dim=0)
    D = desc_ext[tab]                                     # (P, O, 8)
    BIGD = 1 << 20
    pair_ok = tab_ok[:, :, None] & tab_ok[:, None, :]
    ham = torch.where(pair_ok, popcount_pairs(D), BIGD)
    ham_sorted = torch.sort(ham, dim=-1).values
    n_obs = torch.sum(tab_ok, dim=-1)
    med_idx = torch.clamp(n_obs - 1, min=0) // 2
    med = torch.gather(ham_sorted, 2,
                       med_idx[:, None, None].expand(P, max_obs, 1))[..., 0]
    med = torch.where(tab_ok, med, BIGD)
    best_obs = torch.argmin(med, dim=-1)
    best_desc = torch.gather(D, 1, best_obs[:, None, None].expand(P, 1, 8))[:, 0]

    upd_desc = touched & (n_obs > 0)
    return m._replace(
        mp_desc=torch.where(upd_desc[:, None], best_desc, m.mp_desc),
        mp_normal=torch.where(touched[:, None], new_normal, m.mp_normal),
        mp_min_dist=torch.where(touched & has_ref, min_d, m.mp_min_dist),
        mp_max_dist=torch.where(touched & has_ref, max_d, m.mp_max_dist),
    )


def replace_mappoint(m: MapState, old: torch.Tensor, new: torch.Tensor) -> MapState:
    """Fuse duplicates: every reference to old[b] becomes new[b]; old[b] is
    invalidated, its found count moves to new[b] and its redirect pointer
    records new[b]. Entries with old or new < 0 are ignored."""
    P = m.max_mp
    ok = (old >= 0) & (new >= 0)
    lut = torch.arange(P + 1, dtype=_I32, device=m.device)
    lut = scatter_rows(lut, old, ok, new)
    point = torch.where(m.kf_mp >= 0, m.kf_mp, P).long()
    remapped = lut[point]
    kf_mp = torch.where((m.kf_mp >= 0) & (remapped != P), remapped, NO_MP)
    mp_valid = scatter_rows(m.mp_valid, old, ok, False)
    old_safe = torch.where(ok, old, 0).long()
    found = m.mp_found.index_add(0, torch.where(ok, new, 0).long(),
                                 torch.where(ok, m.mp_found[old_safe], 0))
    redirect = scatter_rows(m.mp_redirect, old, ok, new)
    return m._replace(kf_mp=kf_mp, mp_valid=mp_valid, mp_found=found,
                      mp_redirect=redirect)


def switch_map(m: MapState, map_id) -> MapState:
    """Change the active sub-map (Atlas::ChangeMap analog)."""
    return m._replace(active_map=as_index(map_id, m.device).to(_I32))


def erase_active_map(m: MapState) -> MapState:
    """Tombstone every entity of the active sub-map (ResetActiveMap)."""
    kf_gone = m.kf_valid & (m.kf_map_id == m.active_map)
    mp_gone = m.mp_valid & (m.mp_map_id == m.active_map)
    kf_mp = torch.where(kf_gone[:, None], NO_MP, m.kf_mp)
    point = torch.where(kf_mp >= 0, kf_mp, 0).long()
    kf_mp = torch.where((kf_mp >= 0) & mp_gone[point], NO_MP, kf_mp)
    return m._replace(kf_valid=m.kf_valid & ~kf_gone,
                      mp_valid=m.mp_valid & ~mp_gone, kf_mp=kf_mp)


def merge_active_into(m: MapState, target_map, S_loop) -> MapState:
    """Weld the active sub-map into `target_map` (the client-side Atlas
    merge). S_loop is a sim3.Sim3 with p_cur ~ S_loop(p_target): moved
    landmarks are pulled through S_loop^-1, moved keyframe poses become
    T_cw o S_loop (scale folded into the translation), ids are relabeled
    and the target becomes active."""
    target = as_index(target_map, m.device).to(_I32)
    move_kf = m.kf_map_id == m.active_map
    move_mp = m.mp_map_id == m.active_map
    mp_pos = torch.where(move_mp[:, None],
                         sim3.apply(sim3.inverse(S_loop), m.mp_pos), m.mp_pos)
    T_new = sim3.to_se3_scaled(sim3.compose(sim3.from_se3(m.kf_pose), S_loop))
    return m._replace(
        kf_pose=torch.where(move_kf[:, None, None], T_new, m.kf_pose),
        mp_pos=mp_pos,
        kf_map_id=torch.where(move_kf, target, m.kf_map_id),
        mp_map_id=torch.where(move_mp, target, m.mp_map_id),
        active_map=target)
