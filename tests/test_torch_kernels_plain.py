"""The plain PyTorch versions of the two hand-written kernels (K1 FAST
score + NMS, one level and a whole pyramid; K2 Hamming matrix) against the
JAX package, on the CPU. K2's fused forms are in
``tests/test_torch_match_fused.py``.

On the GPU each kernel is held against these plain versions (exact
equality) by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.frontend import fast as jfast
from multi_orbslam3_tpu.frontend import matcher as jmatcher
from multi_orbslam3_tpu.frontend import orb as jorb
from multi_orbslam3_tpu.frontend import pyramid as jpyramid
from multi_orbslam3_tpu_torch.frontend import fast as tfast
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import orb as torb


def _words(rng, n):
    """(n, 8) uint32 words with every bit pattern likely, top bit included."""
    return rng.randint(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("shape,seed", [((48, 64), 0), ((37, 53), 1),
                                        ((120, 160), 2)])
def test_fast_score_nms_plain_matches_jax_on_uint8_images(shape, seed):
    """Exact: uint8-valued float images, K1's plain version equals
    fast.nms3x3(fast.fast_score(img, 7))."""
    rng = np.random.RandomState(seed)
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    # flat regions make plateaus, which exercise the NMS tie rule
    img[5:15, 5:25] = 100.0
    want = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img), 7.0)))
    got = kernels.fast_score_nms(torch.from_numpy(img), 7.0).numpy()
    assert (want > 0).sum() > 10
    np.testing.assert_array_equal(got, want)


def test_fast_score_nms_plain_matches_jax_on_a_resized_level():
    """Exact: a non-integer pyramid level (JAX's resize), passed to both as
    the same float array."""
    rng = np.random.RandomState(3)
    img = np.round(rng.uniform(0, 255, (96, 128))).astype(np.float32)
    level = np.array(jpyramid.build_pyramid(jnp.asarray(img), 3, 1.2)[2])
    want = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(level), 7.0)))
    got = kernels.fast_score_nms(torch.from_numpy(level), 7.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_score_nms_levels_plain_matches_jax_on_a_pyramid_with_a_plateau():
    """Exact, level by level: a 3-level pyramid (JAX's resize, handed to
    both as the same float arrays) of an image with flat plateaus, through
    the multi-level entry point against fast.nms3x3(fast.fast_score(.))."""
    rng = np.random.RandomState(6)
    img = np.round(rng.uniform(0, 255, (90, 118))).astype(np.float32)
    img[10:30, 12:50] = 100.0
    img[50:80, 60:110] = 30.0
    levels = [np.array(l) for l in jpyramid.build_pyramid(jnp.asarray(img), 3, 1.2)]
    assert len({l.shape for l in levels}) == 3
    got = kernels.fast_score_nms_levels([torch.from_numpy(l) for l in levels], 7.0)
    assert len(got) == 3
    for l, g in zip(levels, got):
        want = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(l), 7.0)))
        assert (want > 0).sum() > 10
        np.testing.assert_array_equal(g.numpy(), want)
    one = kernels.fast_score_nms(torch.from_numpy(levels[1]), 7.0)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


def test_fast_score_matches_jax_without_nms():
    """Exact: the score map alone, border zeroing included."""
    rng = np.random.RandomState(4)
    img = np.round(rng.uniform(0, 255, (40, 50))).astype(np.float32)
    want = np.asarray(jfast.fast_score(jnp.asarray(img), 20.0))
    got = tfast.fast_score(torch.from_numpy(img), 20.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,seed", [(7, 5, 0), (64, 130, 1), (200, 33, 2)])
def test_hamming_matrix_plain_matches_jax(n, m, seed):
    """Exact: random uint32 words (top bit set in about half of them),
    carried to the port as int32 bit patterns."""
    rng = np.random.RandomState(seed)
    d1, d2 = _words(rng, n), _words(rng, m)
    assert (d1 >= 2 ** 31).any() and (d2 >= 2 ** 31).any()
    want = np.asarray(jmatcher.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = kernels.hamming_matrix(torch.from_numpy(d1.view(np.int32)),
                                 torch.from_numpy(d2.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


def test_popcount32_counts_every_bit():
    """Exact: the SWAR popcount against numpy bit counting, including
    0, -1 (all 32 bits) and INT32_MIN (the sign bit alone)."""
    rng = np.random.RandomState(5)
    v = np.concatenate([rng.randint(-2 ** 31, 2 ** 31, 5000, dtype=np.int64),
                        [0, -1, -2 ** 31, 2 ** 31 - 1]]).astype(np.int32)
    want = np.unpackbits(v.view(np.uint8)).reshape(-1, 32).sum(1)
    got = kernels.popcount32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_brief_pattern_and_masks_equal_jax():
    """Equal: the re-created BRIEF pattern, orientation mask and circle."""
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    np.testing.assert_array_equal(torb.circular_mask(), jorb._circular_mask())
    assert tfast.CIRCLE == jfast._CIRCLE
    assert tfast.ARC_LEN == jfast.ARC_LEN


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    img = torch.zeros((32, 32))
    d = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    uv = torch.zeros((4, 2))
    lv = torch.zeros(4, dtype=torch.int32)
    kernels.fast_score_nms(img, 7.0)
    kernels.fast_score_nms_levels([img, img[:16]], 7.0)
    kernels.hamming_matrix(d, d)
    kernels.hamming_best_two_valid(d, v, d, v)
    kernels.hamming_best_two_projection(d, uv, v, 3.0, lv, d, uv, v, lv, 1)
    kernels.hamming_best_two_stereo(d, uv, v, lv, torch.ones(4), d, uv, v, lv, 128.0)
    from multi_orbslam3_tpu_torch.geometry.camera import PinholeK
    from multi_orbslam3_tpu_torch.opt import pose_opt
    pose_opt.pose_optimization(torch.eye(4), PinholeK(*torch.ones(4).unbind(0)),
                               torch.ones((4, 3)), uv, torch.ones(4), v, rounds=1, iters=1)
    counts = kernels.launch_counts()
    assert set(counts) == {"fast_score_nms_levels", "hamming_matrix",
                           "hamming_best_two_valid", "hamming_best_two_projection",
                           "hamming_best_two_stereo", "pose_optimization"}
    assert not any(counts.values())


def test_other_devices_raise_instead_of_falling_back():
    img = torch.empty((32, 32), device="meta")
    d = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.fast_score_nms(img, 7.0)
    with pytest.raises(ValueError):
        kernels.hamming_matrix(d, d)
    with pytest.raises(ValueError):
        kernels.hamming_matrix(torch.zeros((4, 8), dtype=torch.int32), d)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.fast_score_nms_levels([torch.zeros((32, 32)), img], 7.0)
    with pytest.raises(ValueError):
        kernels.hamming_best_two_valid(d, v, torch.zeros((4, 8), dtype=torch.int32), v)
    with pytest.raises(ValueError):
        kernels.hamming_best_two_projection(
            d, torch.zeros((4, 2)), v, 3.0, torch.zeros(4, dtype=torch.int32), d,
            torch.zeros((4, 2)), v, torch.zeros(4, dtype=torch.int32), 1)
