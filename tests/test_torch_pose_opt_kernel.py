"""The motion-only pose optimisation as csrc/pose_opt.cu computes it, on the
CPU: opt/pose_opt.pose_opt_kernel_model (the kernel's arithmetic op for op:
its per-thread row order, shuffle tree and warp-ordered block sums, the
packed 27-term normal equations, the 6 x 6 LU with partial pivoting in one
thread, the closed-form retraction and normalisation, the re-classification
between rounds) against the plain version, pose_optimization_ref.

The two sum the same float32 terms in different orders (the plain version's
einsums, matmuls and solve_ex against the kernel's fixed tree and its own
LU), so they agree to float rounding, not bit for bit: with 1,280 or more
rows the camera centres within 1e-5 m (found: about 1e-7) and the inlier
sets equal but for rows whose chi2 lies within 1e-4 relative of its
threshold. One row constrains 2 or 3 of the pose's 6 degrees of freedom;
the 1e-6 damping leaves the others to the rounding of b, amplified by up
to 1e6, so there the centres agree to 1e-4 m (found: up to 3e-5) and the
residuals to 1e-3 px.

The wrapper's CUDA path runs through a stand-in for the launch, which
reads the C entry's pointers back as tensors and runs the model on them.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.opt import pose_opt, robust

torch.set_num_threads(2)

BF = 0.11 * 458.654


def _case(m, seed, kind="stereo", outliers=0.1, masked=0.1, behind=0.02):
    """m observations of points 2-16 m ahead of a pose 3 cm / 0.03 rad off
    identity, with level-scaled pixel noise, a share of gross outliers, of
    masked rows and of rows behind the camera; stereo right-u on every
    row ("stereo"), on none ("mono") or on half ("mixed")."""
    rng = np.random.RandomState(seed)
    K = cam.PinholeK(*(torch.tensor(v) for v in (458.654, 457.296, 376.0, 240.0)))
    pts = np.stack([rng.uniform(-6, 6, m), rng.uniform(-4, 4, m),
                    rng.uniform(2, 16, m)], 1).astype(np.float32)
    back = rng.rand(m) < behind
    pts_seen = pts.copy()
    pts[back, 2] *= -1.0
    T_true = se3.exp(torch.from_numpy((rng.randn(6) * 0.03).astype(np.float32)))
    p_world = se3.apply(se3.inverse(T_true), torch.from_numpy(pts)).contiguous()
    level = rng.randint(0, 8, m)
    scale = torch.from_numpy((1.2 ** level).astype(np.float32))
    uv = cam.project(K, torch.from_numpy(pts_seen))
    uv = uv + torch.from_numpy(rng.randn(m, 2).astype(np.float32)) * scale[:, None]
    bad = torch.from_numpy(rng.rand(m) < outliers)
    uv[bad] += torch.from_numpy(rng.uniform(-40, 40, (int(bad.sum()), 2)).astype(np.float32))
    inv_s2 = 1.0 / (scale * scale)
    mask = torch.from_numpy(rng.rand(m) >= masked)
    u_r = None
    if kind != "mono":
        u_r = uv[:, 0] - BF / torch.from_numpy(pts_seen[:, 2])
        if kind == "mixed":
            u_r = torch.where(torch.from_numpy(rng.rand(m) < 0.5), u_r, torch.tensor(-1.0))
    return dict(T_init=torch.eye(4), K=K, p_world=p_world, uv_obs=uv.contiguous(),
                inv_sigma2=inv_s2, mask=mask, u_r=u_r, bf=BF if u_r is not None else 0.0)


def _centre(T):
    return -(T[:3, :3].T @ T[:3, 3])


def _near_threshold(c, T, rel=1e-4):
    """Rows whose chi2 at pose T lies within `rel` of its threshold."""
    r, _, _ = pose_opt._residual_jac(T, c["K"], c["p_world"], c["uv_obs"], c["u_r"], c["bf"])
    chi2 = torch.sum(r * r, dim=-1) * c["inv_sigma2"]
    th = torch.full_like(chi2, robust.CHI2_MONO)
    if c["u_r"] is not None:
        th = torch.where(c["u_r"] >= 0, robust.CHI2_STEREO, th)
    return torch.abs(chi2 - th) <= rel * th


def assert_close_to_plain(got, want, c, centre_m=1e-5):
    """Camera centres within centre_m, rotations within 1e-5, inlier sets
    equal but for near-threshold rows (returned: how many differ)."""
    dc = float(torch.linalg.norm(_centre(got.pose) - _centre(want.pose)))
    assert dc <= centre_m, dc
    assert float(torch.max(torch.abs(got.pose[:3, :3] - want.pose[:3, :3]))) <= 1e-5
    assert torch.equal(got.pose[3], want.pose[3])
    differ = got.inliers != want.inliers
    near = _near_threshold(c, want.pose) | _near_threshold(c, got.pose)
    assert not bool((differ & ~near).any())
    n_differ = int(differ.sum())
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= n_differ
    if n_differ == 0:
        assert torch.isclose(got.chi2, want.chi2, rtol=1e-4, atol=1e-6)
    return n_differ


@pytest.mark.parametrize("rounds,iters", [(2, 7), (3, 8), (4, 10)])
@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
@pytest.mark.parametrize("m", [0, 1, 1280, 2000])
def test_kernel_model_equals_plain(m, kind, rounds, iters):
    c = _case(m, 100 * m + 10 * rounds + iters, kind)
    want = pose_opt.pose_optimization_ref(**c, rounds=rounds, iters=iters)
    got = pose_opt.pose_opt_kernel_model(**c, rounds=rounds, iters=iters)
    assert got.inliers.dtype == torch.bool and got.n_inliers.dtype == torch.int32
    assert got.chi2.dtype == torch.float32 and got.pose.shape == (4, 4)
    if m == 1:
        # two or three rows for six unknowns: see the module's docstring
        assert_close_to_plain(got, want, c, centre_m=1e-4)
        r_got, r_want = (pose_opt._residual_jac(res.pose, c["K"], c["p_world"], c["uv_obs"],
                                                c["u_r"], c["bf"])[0] for res in (got, want))
        assert float(torch.abs(r_got - r_want).max()) <= 1e-3
        return
    assert_close_to_plain(got, want, c)
    if m:
        assert 0.6 * m <= int(got.n_inliers) <= 0.9 * m


def test_rows_behind_the_camera_or_masked_are_never_inliers():
    c = _case(1280, 7, "mixed", behind=0.1, masked=0.2)
    got = pose_opt.pose_opt_kernel_model(**c, rounds=2, iters=7)
    p_c = se3.apply(got.pose, c["p_world"])
    assert not bool((got.inliers & (p_c[:, 2] <= 1e-3)).any())
    assert not bool((got.inliers & ~c["mask"]).any())
    assert int(got.n_inliers) == int(got.inliers.sum())


@pytest.mark.parametrize("fn", [pose_opt.pose_opt_kernel_model, pose_opt.pose_optimization_ref])
def test_all_masked_keeps_the_pose(fn):
    """No active row: H is the damping alone and b is 0, so dx is 0 and the
    pose comes back as it went in (renormalised)."""
    c = _case(1280, 3, "stereo")
    c["mask"] = torch.zeros_like(c["mask"])
    T0 = se3.exp(torch.tensor([0.1, -0.2, 0.05, 0.3, -0.1, 0.2]))
    c["T_init"] = T0
    got = fn(**c, rounds=2, iters=7)
    assert torch.allclose(got.pose, T0, atol=1e-6, rtol=0)
    assert not bool(got.inliers.any()) and int(got.n_inliers) == 0 and float(got.chi2) == 0.0


@pytest.mark.parametrize("fn", [pose_opt.pose_opt_kernel_model, pose_opt.pose_optimization_ref])
def test_a_step_that_is_not_finite_keeps_the_pose(fn):
    """A masked row at infinity still enters H with weight 0 (0 x inf is
    NaN), so every dx is NaN and the pose stays T_init bit for bit."""
    c = _case(300, 5, "mono")
    c["p_world"][4] = torch.tensor([float("inf"), 0.0, 1.0])
    c["mask"][4] = False
    T0 = se3.exp(torch.tensor([0.01, 0.02, -0.01, 0.1, 0.0, -0.1]))
    c["T_init"] = T0
    got = fn(**c, rounds=2, iters=3)
    assert torch.equal(got.pose, T0)


@pytest.mark.parametrize("rounds,iters", [(0, 5), (1, 0)])
def test_schedules_without_iterations(rounds, iters):
    """Zero rounds classify at T_init; zero iterations classify each round
    at the same pose: both as the plain version."""
    c = _case(600, 11, "stereo")
    got = pose_opt.pose_opt_kernel_model(**c, rounds=rounds, iters=iters)
    want = pose_opt.pose_optimization_ref(**c, rounds=rounds, iters=iters)
    assert torch.equal(got.pose, want.pose) and torch.equal(got.inliers, want.inliers)
    assert torch.isclose(got.chi2, want.chi2, rtol=1e-5)


@pytest.mark.parametrize("m", [0, 1, 31, 255, 256, 257, 2048, 9000])
def test_block_sum_covers_every_row_once(m):
    """Integer-valued terms sum exactly in any order: the model's block sum
    takes every row once, whatever m is against the block."""
    rng = np.random.RandomState(m)
    terms = torch.from_numpy(rng.randint(-50, 50, (m, 27)).astype(np.float32))
    got = pose_opt._block_sum(terms, kernels.POSE_THREADS)
    assert torch.equal(got, terms.to(torch.float64).sum(0).to(torch.float32))


def test_cpu_tensors_take_the_plain_version():
    c = _case(1280, 21, "stereo")
    before = kernels.launch_counts()["pose_optimization"]
    got = pose_opt.pose_optimization(**c, rounds=2, iters=7)
    want = pose_opt.pose_optimization_ref(**c, rounds=2, iters=7)
    assert kernels.launch_counts()["pose_optimization"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _floats(ptr, n, dtype=torch.float32):
    """A CPU tensor's n elements, read back from the pointer the C entry got."""
    if n == 0:
        return torch.zeros(0, dtype=dtype)
    ct = {torch.float32: ctypes.c_float, torch.bool: ctypes.c_uint8,
          torch.int32: ctypes.c_int32}[dtype]
    buf = (ct * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.uint8 if dtype == torch.bool else dtype).view(dtype)


@pytest.mark.parametrize("kind,m", [("stereo", 1280), ("mono", 300), ("mixed", 0)])
def test_the_wrapper_launches_once_with_its_arguments(monkeypatch, kind, m):
    """opt/pose_opt.pose_optimization down the CUDA path, the launch a
    stand-in that runs the model on what the C entry would receive. The
    checks and the launch run with p_world's device made the current one
    (torch.cuda.device, a stand-in here too), so a card that is not the
    current one takes its own tensors."""
    c = _case(m, 31, kind)
    calls, current = [], []

    class fake_device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            current.append(self.d)

        def __exit__(self, *exc):
            current.pop()

    def fake_check(name, t, *a):
        assert current == [c["p_world"].device]

    def fake_launch(name, T0, cam4, pw, uv, s2, mask, u_r, m_, rounds, iters, chi2_th, bf,
                    pose, inl, n_in, chi2):
        assert current == [c["p_world"].device]
        calls.append((name, m_, rounds, iters, chi2_th, bf, u_r is None))
        K = cam.PinholeK(*_floats(cam4, 4).unbind(0))
        res = pose_opt.pose_opt_kernel_model(
            _floats(T0, 16).view(4, 4), K, _floats(pw, 3 * m_).view(m_, 3),
            _floats(uv, 2 * m_).view(m_, 2), _floats(s2, m_), _floats(mask, m_, torch.bool),
            rounds, iters, chi2_th, None if u_r is None else _floats(u_r, m_), bf)
        _floats(pose, 16).copy_(res.pose.reshape(16))
        _floats(inl, m_, torch.bool).copy_(res.inliers)
        _floats(n_in, 1, torch.int32).copy_(res.n_inliers.reshape(1))
        _floats(chi2, 1).copy_(res.chi2.reshape(1))

    monkeypatch.setattr(kernels, "_all_cpu", lambda *ts: False)
    monkeypatch.setattr(kernels, "_check_cuda", fake_check)
    monkeypatch.setattr(kernels, "_launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    got = pose_opt.pose_optimization(**c, rounds=3, iters=8)
    monkeypatch.undo()
    assert current == []
    assert calls == [("pose_optimization", m, 3, 8, robust.CHI2_MONO, c["bf"],
                      kind == "mono")]
    want = pose_opt.pose_opt_kernel_model(**c, rounds=3, iters=8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_model_constants_are_the_kernels_own():
    """The model takes the block's thread count from kernels.py; the kernel
    holds its own in csrc/pose_opt.cu. Both must agree."""
    src = (kernels.CSRC / "pose_opt.cu").read_text()
    assert int(re.search(r"^constexpr int PO_THREADS = (\d+);", src, re.M).group(1)) \
        == kernels.POSE_THREADS
    assert kernels.POSE_THREADS % 32 == 0
    assert "pose_opt.cu" in kernels.SOURCES
    assert "-fmad=false" in kernels.SOURCE_FLAGS["pose_opt.cu"]
