"""Configuration system (the port's own copy of
multi_orbslam3_tpu/config.py: the same dataclasses, fields and defaults;
tests/test_torch_no_jax.py holds the two equal).

Replaces the reference's three-tier ROS-param config (ros/conf/*.yaml +
roslaunch <param> + deep nh.param lookups; SURVEY.md §5 "Config / flag system",
reference include/Datatypes.h:41-54 ``ORBParameters``) with plain frozen
dataclasses. Everything that fixes a tensor shape (capacities, feature
counts, pyramid levels) lives here, so every stage runs at fixed shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB extractor parameters (reference ros/conf/EuRoC_mono_client.yaml

    ``ORBextractor/*`` and src/ORBextractor.cc:408-474).
    ``n_features`` is padded to a lane-friendly multiple of 128 on device.
    """

    n_features: int = 1024          # reference: 1000; 1024 as in the JAX package
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0    # iniThFAST (reference ORBextractor.cc:835)
    fast_threshold_min: float = 7.0  # minThFAST fallback
    cell_size: int = 32             # spatial-balance grid cell (px) — fixed-shape analog of
    # the reference quadtree DistributeOctTree (ORBextractor.cc:537-761)
    patch_size: int = 31            # orientation/descriptor patch
    half_patch: int = 15
    init_multiplier: int = 2        # 5x in reference Tracking.cc:1167-86; 2x here
    # (grid top-k already yields denser coverage)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole (or Kannala-Brandt) intrinsics.

    Reference: ros/conf/EuRoC_mono_client.yaml Camera_* and
    src/CameraModels/Pinhole.cpp.
    """

    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    # radial-tangential distortion (k1 k2 p1 p2 k3); zeros = pre-rectified
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    model: str = "pinhole"          # "pinhole" | "kb8"
    # Kannala-Brandt k1..k4 (used when model == "kb8")
    kb: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    fps: float = 20.0
    # stereo
    baseline: float = 0.0           # meters; >0 enables stereo depth
    depth_threshold: float = 35.0   # close/far point threshold (in baseline units)


@dataclasses.dataclass(frozen=True)
class IMUConfig:
    """IMU noise / rate (reference ros/conf EuRoC IMU params, src/ImuTypes.cc)."""

    rate_hz: float = 200.0
    gyro_noise: float = 1.7e-4
    acc_noise: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    # body-from-camera extrinsics as a flat 4x4 row-major tuple
    T_bc: Tuple[float, ...] = tuple(float(x) for x in
                                    (1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1))
    gravity: float = 9.81
    max_samples_per_frame: int = 32  # static cap on IMU samples between frames


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed device-resident capacities — the fixed-shape analog of the reference's

    unbounded object graphs (SURVEY.md §7.4). Sized for EuRoC-scale sequences.
    """

    max_keyframes: int = 512
    max_mappoints: int = 16384
    max_obs: int = 131072            # COO observation list capacity
    max_obs_per_kf: int = 1024       # = ORBConfig.n_features
    covis_threshold: int = 15        # covisibility edge weight (KeyFrame.cc:490-621)


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking state-machine thresholds (reference src/Tracking.cc)."""

    init_min_matches: int = 60       # two-view bootstrap match gate
    min_matches_motion: int = 20     # TrackWithMotionModel acceptance
    min_matches_refkf: int = 15
    min_matches_localmap: int = 30
    kf_min_interval: int = 2         # min frames between KFs (mMinFrames;
    # the reference uses 0 but CULLS client-side redundancy later — here
    # the server culls, so the floor bounds the per-KF mapping-chain load)
    kf_max_interval: int = 20        # mMaxFrames ~ fps (NeedNewKeyFrame :2813)
    kf_tracked_ratio: float = 0.85  # insert KF when tracked decays below
    # ratio * best-inliers-since-last-KF (thRefRatio analog)
    search_radius: float = 15.0      # projection search window (px)
    relost_timeout: int = 100        # frames in RECENTLY_LOST before LOST


@dataclasses.dataclass(frozen=True)
class LocalMappingConfig:
    """Local mapping / BA windows (reference LM/LocalBASize=20, Nd=21)."""

    local_ba_kfs: int = 16           # optimized KF window (pow2-friendly)
    local_ba_fixed_kfs: int = 8      # fixed anchor KFs
    local_ba_points: int = 2048      # landmark cap in the window (a 16+8
    # window tracks ~1-2k live landmarks; the old 4096 cap made every GN
    # iteration pay 2x dead compute — measured 86 ms/KF on chip)
    local_ba_iters: int = 6          # warm-started windows converge in ~5
    triangulation_neighbors: int = 8  # CreateNewMapPoints neighbor KFs (ref <=20)
    culling_redundancy: float = 0.9  # KeyFrameCulling: >=90% seen elsewhere


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Place recognition / loop & merge (reference src/LoopClosing.cc)."""

    consistency_hits: int = 3        # consecutive KF confirmations
    min_bow_score_ratio: float = 0.75
    # absolute BoW score floor for loop/merge candidates. Scores shrink
    # as the vocabulary grows (fewer shared words between genuine
    # revisits): ~0.05-0.15 true-match scores at 10k words vs ~0.02-0.06
    # at 100k. The reference uses NO absolute floor (DetectNBestCandidates
    # ranks groups and lets Sim3+projection verify,
    # src/KeyFrameDatabase.cc:594); the floor here only prunes hopeless
    # candidates before the geometric cascade.
    min_bow_score: float = 0.012
    sim3_ransac_iters: int = 128     # batched hypotheses per round
    sim3_min_inliers: int = 20
    pose_graph_iters: int = 20
    scale_gate: Tuple[float, float] = (0.9, 1.1)  # inertial merge gate (:95-118)
    n_candidates: int = 3            # N-best candidate groups (DetectNBest)
    min_proj_matches: int = 25       # guided-projection acceptance gate
    min_map_kfs: int = 12            # maturity gate: skip place recognition
    # for maps smaller than this (reference NewDetectCommonRegions skips
    # <12-KF maps — an immature-map merge poisons both agents)
    event_interval_kfs: int = 5      # fresh KFs required between events
    # periodic full-arena GBA every N ingested keyframes (0 disables;
    # beyond the reference's event-only GBA — keeps each agent's
    # post-event arc globally refined instead of drifting to run end)
    gba_periodic_kfs: int = 12


@dataclasses.dataclass(frozen=True)
class BoWConfig:
    """Vocabulary tree shape (reference DBoW2 ORBvoc: k=10, L=6,
    src/ClientSystem.cc:69-77). Default is the bundled k=10 L=5 100k-word
    artifact — the sparse per-feature database (bow/database.py) makes
    memory/compute independent of vocabulary size, so scale is bounded
    only by the tree-descent tables. The 10k L4 artifact remains for
    small CI configs."""

    branching: int = 10
    levels: int = 5
    # derived: n_words = branching ** levels


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Client<->server flow control (reference src/Communicator.cc:17-55)."""

    client_kf_bound: int = 100
    client_mp_bound: int = 4500
    server_kf_bound: int = 400
    server_mp_bound: int = 12000
    client_period_s: float = 0.005
    server_period_s: float = 0.005
    vicinity_kfs: int = 50           # downlink window (Map.cc:937-939)
    max_agents: int = 4              # reference Optimizer.h:23 MAXAGENTS


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    sensor: str = "mono"             # mono | stereo | rgbd | mono_inertial
    orb: ORBConfig = ORBConfig()
    camera: CameraConfig = CameraConfig()
    imu: IMUConfig = IMUConfig()
    map: MapConfig = MapConfig()
    tracking: TrackingConfig = TrackingConfig()
    local_mapping: LocalMappingConfig = LocalMappingConfig()
    loop: LoopConfig = LoopConfig()
    bow: BoWConfig = BoWConfig()
    comm: CommConfig = CommConfig()

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def euroc_mono() -> SystemConfig:
    """EuRoC monocular config (reference ros/conf/EuRoC_mono_client.yaml)."""
    return SystemConfig()


def euroc_mono_inertial() -> SystemConfig:
    """EuRoC mono-inertial config: cam0 intrinsics + the dataset's
    camera-IMU extrinsics (mav0/cam0/sensor.yaml T_BS = body-from-camera;
    the reference reads the same matrix as Tbc from its yaml,
    include/ImuTypes.h:71). IMU noise densities are EuRoC's published
    values (= IMUConfig defaults)."""
    return SystemConfig(
        sensor="mono_inertial",
        imu=IMUConfig(T_bc=(
            0.0148655429818, -0.999880929698, 0.00414029679422,
            -0.0216401454975,
            0.999557249008, 0.0149672133247, 0.025715529948,
            -0.064676986768,
            -0.0257744366974, 0.00375618835797, 0.999660727178,
            0.00981073058949,
            0.0, 0.0, 0.0, 1.0)))


def synthetic_mono(width: int = 640, height: int = 480) -> SystemConfig:
    """Small synthetic-world config used by tests and the benchmark."""
    cam = CameraConfig(width=width, height=height, fx=400.0, fy=400.0,
                       cx=width / 2.0, cy=height / 2.0)
    return SystemConfig(camera=cam)


def small_synthetic() -> SystemConfig:
    """Reduced capacities for CI / smoke runs (fast compiles, short
    sequences): 320x240, 256 features, small arena, relaxed loop
    maturity gates (short sequences never reach the production 12-KF
    gate)."""
    c = synthetic_mono(width=320, height=240)
    return c.replace(
        orb=ORBConfig(n_features=256, n_levels=4),
        map=MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                      max_obs_per_kf=256),
        local_mapping=LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8),
        bow=BoWConfig(branching=6, levels=3),
        loop=LoopConfig(min_map_kfs=6, event_interval_kfs=2),
    )


def tumvi_512() -> SystemConfig:
    """TUM-VI 512x512 fisheye config (reference ros/conf/TUM_512.yaml,
    src/CameraModels/KannalaBrandt8.cpp): Kannala-Brandt cam0 calibration
    + IMU noise/extrinsics from the dataset's published camchain. The
    dataset ships in the same ASL layout as EuRoC, so dataio.euroc loads
    it unchanged."""
    cam = CameraConfig(
        width=512, height=512, fx=190.97847715128717, fy=190.9733070521226,
        cx=254.93170605935475, cy=256.8974428996504, model="kb8",
        kb=(0.0034823894022493434, 0.0007150348452162257,
            -0.0020532361418706202, 0.00020293673591811182))
    imu = IMUConfig(
        rate_hz=200.0, gyro_noise=8.0e-5, acc_noise=1.4e-3,
        gyro_walk=2.2e-6, acc_walk=8.6e-5,
        # body-from-camera (cam0) extrinsics, TUM-VI camchain T_cam_imu^-1
        T_bc=(-0.99952504, 0.00750192, -0.02989013, 0.04557484,
              0.02961534, -0.03439736, -0.99896935, -0.07116180,
              -0.00852233, -0.99938008, 0.03415885, -0.04468125,
              0.0, 0.0, 0.0, 1.0))
    return SystemConfig(sensor="mono_inertial", camera=cam, imu=imu)
