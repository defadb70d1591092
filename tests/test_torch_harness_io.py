"""The port's dataset ingest and viewer against the JAX package: the copied
modules (rectify, euroc, mini_asl) held equal to their originals,
PNG frames through PIL both ways, both packages' EuRoC loaders on the same
ASL trees (whichever package wrote them), the stereo loader's rectified
pairs and geometry, and the numpy-rasterised map and frame images."""

import difflib
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.dataio import euroc as jeuroc
from multi_orbslam3_tpu.dataio import mini_asl as jmini
from multi_orbslam3_tpu.dataio import synthetic as jsyn
from multi_orbslam3_tpu_torch.dataio import euroc as teuroc
from multi_orbslam3_tpu_torch.dataio import mini_asl as tmini
from multi_orbslam3_tpu_torch.eval import viewer
from multi_orbslam3_tpu_torch.map import mapstate as tms

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "multi_orbslam3_tpu"
PORT = REPO / "multi_orbslam3_tpu_torch"


def _changed_lines(a: str, b: str) -> tuple:
    removed, added = [], []
    for line in difflib.unified_diff(a.splitlines(), b.splitlines(), lineterm="", n=0):
        if line.startswith("-") and not line.startswith("---"):
            removed.append(line[1:])
        elif line.startswith("+") and not line.startswith("+++"):
            added.append(line[1:])
    return removed, added


@pytest.mark.parametrize("rel", ["dataio/rectify.py", "dataio/mini_asl.py"])
def test_numpy_only_modules_are_byte_identical_copies(rel):
    assert (JAX_PKG / rel).read_bytes() == (PORT / rel).read_bytes()


def test_euroc_differs_only_in_its_rectify_import_and_png_decoder():
    """The port reads PNGs with PIL alone (the GPU machine has PIL but no
    matplotlib) and imports its own rectify; every other line is the JAX
    package's."""
    removed, added = _changed_lines((JAX_PKG / "dataio" / "euroc.py").read_text(),
                                    (PORT / "dataio" / "euroc.py").read_text())
    assert added == ['    """Decode an 8-bit grayscale PNG via PIL."""',
                     "    from PIL import Image  # noqa: WPS433",
                     '    return np.asarray(Image.open(path).convert("L"), np.float32)',
                     "        from multi_orbslam3_tpu_torch.dataio import rectify",
                     "        from multi_orbslam3_tpu_torch.dataio import rectify"]
    assert removed[-2:] == ["        from multi_orbslam3_tpu.dataio import rectify"] * 2
    decoder = removed[:-2]
    assert decoder[0].startswith('    """Decode an 8-bit grayscale PNG via matplotlib')
    assert "    except ImportError:" in decoder and len(decoder) == 13


# ----------------------------------------------------------------------
# PNG frames: PIL on both machines
# ----------------------------------------------------------------------

def _noise_and_gradient(h=48, w=64):
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:h, 0:w]
    return {"noise": rng.randint(0, 256, (h, w)).astype(np.uint8),
            "gradient": ((xx * 0.3 + yy * 0.2) % 255).astype(np.uint8)}


@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_the_port_reads_pil_written_pngs_exactly(tmp_path, kind):
    img = _noise_and_gradient()[kind]
    path = str(tmp_path / f"{kind}.png")
    Image.fromarray(img).save(path)
    got = teuroc._read_png_gray(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img.astype(np.float32))
    np.testing.assert_array_equal(got, jeuroc._read_png_gray(path))


def test_the_ports_written_frames_decode_in_pil_to_the_same_pixels(tmp_path):
    """write_mini_asl's PNGs hold the rendered frames rounded to uint8."""
    c = jcfg.synthetic_mono(width=96, height=64)
    seq = jsyn.make_sequence(c, n_frames=3, n_points=200, seed=4, trajectory="forward")
    root = str(tmp_path / "t")
    tmini.write_mini_asl(root, seq)
    names = sorted(os.listdir(os.path.join(root, "mav0", "cam0", "data")))
    assert len(names) == 3
    for i, name in enumerate(names):
        with Image.open(os.path.join(root, "mav0", "cam0", "data", name)) as im:
            assert im.mode == "L"
            pix = np.asarray(im)
        np.testing.assert_array_equal(
            pix, np.clip(np.asarray(seq.images[i]), 0, 255).astype(np.uint8))


# ----------------------------------------------------------------------
# Loaders: both packages on one tree, whichever package wrote it
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_trees(tmp_path_factory):
    """One 80x60, 8-frame VI sequence written by each package's writer."""
    c = jcfg.synthetic_mono(width=80, height=60)
    seq = jsyn.make_sequence(c, n_frames=8, n_points=200, seed=13, trajectory="forward",
                             imu=True, lateral=0.8, sway_freq=0.15)
    base = tmp_path_factory.mktemp("asl")
    roots = {}
    for name, mod in (("jax", jmini), ("torch", tmini)):
        roots[name] = mod.write_mini_asl(str(base / name), seq)
    return seq, roots


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_both_loaders_read_the_same_frames_and_imu_batches(mini_trees, writer):
    seq, roots = mini_trees
    root = roots[writer]
    assert teuroc.available(root) and jeuroc.available(root)
    js = jeuroc.EurocSequence(root, imu=True)
    ts = teuroc.EurocSequence(root, imu=True)
    assert ts.frames_ns == js.frames_ns and ts.frames == js.frames
    assert ts.frames_ns[0] == jmini.EPOCH0_NS + int(round(float(seq.timestamps[0]) * 1e9))
    np.testing.assert_array_equal(ts.imu, js.imu)
    items_j, items_t = list(js), list(ts)
    assert len(items_t) == len(items_j) == 8
    for a, b in zip(items_t, items_j):
        assert a[0] == b[0] and a[0] > 1.4e9             # epoch-scale seconds
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert sum(len(it[2]) for it in items_t) > 0          # IMU batches are not empty


def test_max_frames_cuts_frames_and_keys_alike(mini_trees):
    _, roots = mini_trees
    js = jeuroc.EurocSequence(roots["torch"], max_frames=5)
    ts = teuroc.EurocSequence(roots["torch"], max_frames=5)
    assert len(ts) == len(js) == 5 and ts.frames_ns == js.frames_ns


def _make_fake_euroc(root, n_frames=4, drop_right=1):
    """tests/test_euroc_io.py's stereo skeleton: cam0/cam1 sensor.yaml with
    EuRoC's calibration, gradient PNGs (cam1 drops one frame), 200 Hz IMU."""
    t0 = 1403636579763555584
    dt = 50_000_000
    for cam, fu, cx, tx, ty in (("cam0", 458.654, 367.215, "-0.0216401454975", "-0.064676986768"),
                                ("cam1", 457.587, 379.999, "-0.0198435579556", "0.0453689425024")):
        d = os.path.join(root, "mav0", cam)
        os.makedirs(os.path.join(d, "data"))
        with open(os.path.join(d, "sensor.yaml"), "w") as f:
            f.write(f"""# General sensor definitions.
sensor_type: camera
T_BS:
  rows: 4
  cols: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, {tx},
         0.999557249008, 0.0149672133247, 0.025715529948, {ty},
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [{fu}, 457.296, {cx}, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
""")
        rows = ["#timestamp [ns],filename"]
        yy, xx = np.mgrid[0:480, 0:752]
        for i in range(n_frames):
            if cam == "cam1" and i == drop_right:
                continue
            name = f"{t0 + i * dt}.png"
            rows.append(f"{t0 + i * dt},{name}")
            Image.fromarray(((xx * 0.3 + yy * 0.2 + i * 10 + (cam == "cam1") * 7) % 255)
                            .astype(np.uint8)).save(os.path.join(d, "data", name))
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    imu_dir = os.path.join(root, "mav0", "imu0")
    os.makedirs(imu_dir)
    rows = ["#timestamp,wx,wy,wz,ax,ay,az"]
    for k in range(n_frames * 10):
        rows.append(f"{t0 + k * 5_000_000},0.01,-0.02,0.005,0.1,-9.7,0.3")
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def stereo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc_stereo"))
    _make_fake_euroc(root)
    return root


def test_camera_yaml_reads_alike(stereo_root):
    for cam in ("cam0", "cam1"):
        path = os.path.join(stereo_root, "mav0", cam, "sensor.yaml")
        (Kj, dj, Tj, whj), (Kt, dt_, Tt, wht) = (jeuroc.read_camera_yaml(path),
                                                 teuroc.read_camera_yaml(path))
        np.testing.assert_array_equal(Kt, Kj)
        np.testing.assert_array_equal(Tt, Tj)
        assert dt_ == dj and wht == whj == (752, 480)


def test_stereo_loaders_rectify_and_pair_alike(stereo_root):
    """K_new, baseline and T_rect_body within 1e-12; every rectified pair
    within 1e-4 grey levels; the same pairs skipped."""
    js = jeuroc.EurocStereoSequence(stereo_root, imu=True)
    ts = teuroc.EurocStereoSequence(stereo_root, imu=True)
    np.testing.assert_allclose(ts.K_new, js.K_new, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.T_rect_body, js.T_rect_body, rtol=0, atol=1e-12)
    assert abs(ts.baseline - js.baseline) < 1e-12 and 0.09 < ts.baseline < 0.13
    items_j, items_t = list(js), list(ts)
    assert len(items_t) == len(items_j) == 3                # one right frame dropped
    for a, b in zip(items_t, items_j):
        assert a[0] == b[0]
        for x, y in zip(a[1:3], b[1:3]):
            assert x.shape == (480, 752) and x.dtype == np.float32
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# Viewer: numpy raster, PNG through PIL
# ----------------------------------------------------------------------

def _two_agent_map():
    rng = np.random.RandomState(0)
    m = tms.empty_map(8, 64, 16, "cpu")
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[:, 0, 3] = -np.arange(8, dtype=np.float32)          # centres along +x
    poses[:, 2, 3] = np.where(np.arange(8) < 4, 0.0, -3.0)    # agent 1 at z = 3
    return m._replace(
        mp_valid=torch.ones(64, dtype=torch.bool),
        mp_pos=torch.from_numpy(rng.uniform(-1, 8, (64, 3)).astype(np.float32)),
        kf_pose=torch.from_numpy(poses), kf_valid=torch.ones(8, dtype=torch.bool),
        kf_agent=torch.from_numpy((np.arange(8) >= 4).astype(np.int32)))


def test_plot_map_draws_landmarks_agents_and_ground_truth(tmp_path):
    path = str(tmp_path / "map.png")
    gt = np.stack([np.arange(8.0), np.zeros(8), np.full(8, 1.5)], 1)
    viewer.plot_map(_two_agent_map(), path, title="server arena", gt_centers=gt)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (800, 800)
        assert im.info["Title"] == "server arena"
        pix = np.asarray(im).reshape(-1, 3)
    colours = {tuple(c) for c in np.unique(pix, axis=0)}
    for want in ((255, 255, 255), (150, 150, 150), (31, 119, 180), (255, 127, 14), (0, 0, 0)):
        assert want in colours, want


def test_plot_map_of_an_empty_map_and_plot_frame(tmp_path):
    viewer.plot_map(tms.empty_map(4, 8, 4, "cpu"), str(tmp_path / "empty.png"))
    with Image.open(str(tmp_path / "empty.png")) as im:
        assert (np.asarray(im) == 255).all()
    img = np.full((48, 64), 100.0, np.float32)
    uv = np.array([[10.0, 10.0], [40.0, 30.0]], np.float32)
    viewer.plot_frame(img, uv, np.array([True, False]), str(tmp_path / "frame.png"))
    with Image.open(str(tmp_path / "frame.png")) as im:
        pix = np.asarray(im)
    assert pix.shape == (48, 64, 3)
    assert (pix[10, 13] == (0, 255, 0)).all()            # ring around the tracked point
    assert (pix[30, 43] == (31, 119, 180)).all()         # ring around the other one
    assert (pix[0, 0] == 100).all()
