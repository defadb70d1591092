"""The loop closer's minimum support of a verified cascade in the PyTorch
port (LoopCloser._supported: upstream's 15 Sim3 inliers), on the CPU.

A place A is revisited by a current keyframe B that sees A's points
through landmarks of its own. A Sim3 that scales A's
landmarks about B's camera centre lands them on B's features, so the
cascade's own projection gate passes it; the loop closer then accepts a
cascade only on 15 or more inlier pairs, and retries the candidate
otherwise. The map is built with the JAX package's map functions, as
tests/test_torch_loop.py builds its maps, and carried across with
interop."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.geometry import sim3 as tsim3
from multi_orbslam3_tpu_torch.pipeline import loop_closing as tlc

KV = (300.0, 300.0, 160.0, 120.0)
KJ = jcam.PinholeK(*[jnp.float32(v) for v in KV])
KT = tcam.PinholeK(*[torch.tensor(v) for v in KV])
PROJ_KW = dict(width=320, height=240, scale_factor=1.2, n_levels=8)
P, N_FEAT = 64, 64


def _keyframe(m, T_cw, pts, desc, ts, assoc, parent):
    """A keyframe whose features are the true projections of pts, associated
    with the landmark slots `assoc` (NO_MP: none)."""
    uv = np.asarray(jcam.project(KJ, jse3.apply(jnp.asarray(T_cw)[None], jnp.asarray(pts))))
    uv_pad = np.zeros((N_FEAT, 2), np.float32)
    uv_pad[:P] = uv
    desc_pad = np.zeros((N_FEAT, 8), np.uint32)
    desc_pad[:P] = desc
    valid = np.zeros(N_FEAT, bool)
    valid[:P] = True
    f = FrameFeatures(uv=jnp.asarray(uv_pad), uv_und=jnp.asarray(uv_pad),
                      response=jnp.ones(N_FEAT), level=jnp.zeros(N_FEAT, jnp.int32),
                      angle=jnp.zeros(N_FEAT), desc=jnp.asarray(desc_pad),
                      valid=jnp.asarray(valid))
    row = np.full(N_FEAT, jms.NO_MP, np.int32)
    row[:P] = assoc
    return jms.add_keyframe(m, f, jnp.asarray(T_cw), ts, jnp.asarray(row), parent)


@pytest.fixture(scope="module")
def revisit():
    rng = np.random.RandomState(5)
    pts = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.9, 0.9, P),
                    rng.uniform(3, 6, P)], 1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (P, 8), dtype=np.uint32)
    m = jms.empty_map(max_kf=16, max_mp=512, n_feat=N_FEAT)
    no_mp = np.full(P, jms.NO_MP, np.int32)
    # the place: keyframe A and its landmarks
    m, kA = _keyframe(m, np.eye(4, dtype=np.float32), pts, desc, 0.0, no_mp, -1)
    idx = jnp.arange(P, dtype=jnp.int32)
    m, slots_A = jms.add_mappoints(m, jnp.asarray(pts), jnp.ones(P, bool),
                                   jnp.asarray(desc), kA, kA, idx, kA, idx)
    # the revisit: B near A, observing a second copy of the landmarks (the
    # current map's)
    T_B = np.asarray(jse3.exp(jnp.asarray([0.0, 0.02, 0.0, 0.1, 0.0, 0.0])), np.float32)
    m, kB = _keyframe(m, T_B, pts, desc, 20.0, no_mp, -1)
    m, _ = jms.add_mappoints(m, jnp.asarray(pts), jnp.ones(P, bool),
                             jnp.asarray(desc), kB, kB, idx, kB, idx)
    region = np.zeros(512, bool)
    region[np.asarray(slots_A)] = True
    mt = interop.map_from_numpy({f: np.asarray(getattr(m, f)) for f in jms.MapState._fields})
    # B's camera centre in the shared world frame
    c_B = -T_B[:3, :3].T @ T_B[:3, 3]
    return mt, int(kA), int(kB), torch.from_numpy(region), c_B


def _closer():
    return tlc.LoopCloser(tvoc.default_vocabulary(10, 4, device="cpu"), 16)


def _scaled_about(c, s):
    """p -> c + s (p - c): a Sim3 that moves points along the rays of a
    camera centred at c."""
    return tsim3.Sim3(torch.eye(3), torch.from_numpy((1.0 - s) * c).float(), torch.tensor(s))


def _cascade(S, region, n_inliers, n_pairs=40):
    """A verified cascade with n_inliers of its n_pairs RANSAC pairs inliers,
    and as many again flagged inlier on pairs that are not valid."""
    valid = torch.arange(2 * n_pairs) < n_pairs
    inliers = (torch.arange(2 * n_pairs) < n_inliers) | ~valid
    lm = types.SimpleNamespace(valid=valid, cand_region=region)
    return tlc.CascadeResult(True, S, lm, inliers, 64)


@pytest.mark.parametrize("scale", [0.5, 0.7, 1.3])
def test_the_projection_gate_cannot_see_a_scale_error_about_the_current_camera(
        revisit, scale):
    """Why the cascade alone is not enough: the current keyframe finds every
    landmark of the place through the wrong Sim3 as through the true one."""
    m, _, kB, region, c_B = revisit
    good = int(tlc.guided_projection_count(m, kB, tsim3.identity(), region, KT, **PROJ_KW))
    bad = int(tlc.guided_projection_count(m, kB, _scaled_about(c_B, scale), region, KT,
                                          **PROJ_KW))
    assert good == bad == P


@pytest.mark.parametrize("n_inliers,accepted", [(8, False), (14, False), (15, True),
                                                (40, True)])
def test_a_cascade_is_supported_from_15_valid_inlier_pairs(revisit, n_inliers, accepted):
    _, _, _, region, _ = revisit
    lc = _closer()
    assert tlc.MIN_SIM3_INLIERS == 15
    assert lc._supported(_cascade(tsim3.identity(), region, n_inliers)) is accepted


@pytest.mark.parametrize("n_inliers", [9, 15])
def test_an_unsupported_cascade_is_retried_not_accepted(revisit, monkeypatch, n_inliers):
    """The continuity retry of a pending candidate: a cascade that passes its
    projection gate on 9 inlier pairs is not welded and spends a try; on 15
    it is accepted."""
    m, kA, kB, region, c_B = revisit
    casc = _cascade(_scaled_about(c_B, 0.6), region, n_inliers)
    monkeypatch.setattr(tlc, "verify_candidate_cascade", lambda *a, **kw: casc)
    lc = _closer()
    accepted = []
    lc._accept = lambda m_, kf, cand, c, *a: accepted.append((kf, cand, c)) or m_
    lc._pending_cand, lc._pending_tries = kA, 3
    out = lc.on_keyframe(m, kB, KT, min_proj_matches=25, **PROJ_KW)
    assert out is m
    if n_inliers >= 15:
        assert accepted == [(kB, kA, casc)] and lc._pending_cand == -1
    else:
        assert accepted == [] and lc._pending_cand == kA and lc._pending_tries == 2
