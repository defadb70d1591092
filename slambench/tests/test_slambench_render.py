"""The device renderer is the port's NumPy renderer (dataio/synthetic.py),
pixel for pixel with the noise off, and the trajectories are its poses."""

import numpy as np
import torch

from multi_orbslam3_tpu_torch import config as cfgm
from multi_orbslam3_tpu_torch.dataio import synthetic
from slambench.harness import traffic


def test_orbit_poses_are_the_synthetic_circle():
    T = traffic.orbit_poses(40, 1.1, 0.0485, 4.0, 0.0, 8.0)
    for i in (0, 7, 39):
        want = synthetic.circular_pose_at(i, 4.0, 0.0485, 0.0, 1.1, 8.0)
        assert np.abs(T[i] - want).max() < 1e-12


def test_render_matches_numpy_without_noise():
    g = torch.Generator()
    g.manual_seed(2 ** 31 + 123)
    pts, patches = traffic.make_world(400, g, "cpu")
    T = traffic.orbit_poses(5, 1.65, 0.0485, 4.0, 0.0, 8.0)
    K = np.array([[230.0, 0, 95.5], [0, 228.0, 70.25], [0, 0, 1]])
    img = traffic.render(pts, patches, torch.from_numpy(T), (230.0, 228.0, 95.5, 70.25), 192, 144)
    for i in range(5):
        want = synthetic.render_frame(pts.numpy(), patches.numpy(), T[i], K, 192, 144,
                                      noise_std=0.0)
        assert (want != 12.0).sum() > 2000
        np.testing.assert_array_equal(img[i].numpy(), want)


def test_swing_angles_go_out_and_back():
    a = traffic.swing_angles(161, 1.1, 1.6, 160)
    assert a[0] == 1.1 and abs(a[80] - 4.3) < 1e-12 and abs(a[160] - 1.1) < 1e-12
    assert np.all(np.diff(a[:81]) > 0) and np.all(np.diff(a[80:]) < 0)


def test_generate_is_a_function_of_the_seed():
    cam = cfgm.CameraConfig(width=160, height=120, fx=120.0, fy=120.0, cx=80.0, cy=60.0,
                            baseline=0.11)
    tfc = {"landmarks": 200, "frames_per_agent": 3, "fps": 20, "noise_std": 2.0,
           "phases_rad": [1.1, 1.65],
           "orbit": {"arc_rate_rad": 0.0485, "radius_m": 4.0, "center_dist_m": 8.0}}
    a = traffic.generate(tfc, cam, 2 ** 31 + 7, "cpu")
    b = traffic.generate(tfc, cam, 2 ** 31 + 7, "cpu")
    c = traffic.generate(tfc, cam, 2 ** 31 + 8, "cpu")
    assert len(a) == 2 and a[0].right is not None and a[0].left.dtype == torch.uint8
    assert torch.equal(a[1].left, b[1].left) and torch.equal(a[0].right, b[0].right)
    assert not torch.equal(a[0].left, c[0].left)
    np.testing.assert_array_equal(a[0].T_cw, c[0].T_cw)
