"""The wire of the PyTorch port's collaborative layer against the JAX
package's: every payload type of protocol.py, in one MapDelta with gauge
and ack fields, packs to the same bytes in both packages, on the native
codec and on the pure-Python one, and each package decodes the other's
bytes to the same arrays. Descriptor words keep their top bit across the
uint32 wire and the port's int32 bit patterns."""

import dataclasses

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.collab import codec as jcodec
from multi_orbslam3_tpu.collab import protocol as jproto
from multi_orbslam3_tpu_torch.collab import codec as tcodec
from multi_orbslam3_tpu_torch.collab import protocol as tproto
from multi_orbslam3_tpu_torch.collab.host import desc_words, fetch

torch.set_num_threads(2)

PAYLOADS = ("kfs", "kf_updates", "mps", "mp_updates", "foreign_kfs",
            "foreign_mps", "foreign_kf_updates", "foreign_mp_updates")


def delta_arrays(seed: int, B: int = 3, N: int = 16) -> dict:
    """Numpy fields of a MapDelta that carries every payload type; the
    descriptor words all have their top bit set."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    i32 = lambda *s: rng.randint(-1, 500, s).astype(np.int32)  # noqa: E731
    desc = lambda *s: (rng.randint(0, 2 ** 31, s, dtype=np.int64).astype(np.uint32)  # noqa: E731
                       | np.uint32(0x80000000))
    ids = np.arange(B, dtype=np.int32)
    return {
        "kfs": dict(agent=1, local_id=ids, timestamp=rng.rand(B),
                    ref_ids=i32(B, 3), T_rel=f32(B, 3, 4, 4), T_abs=f32(B, 4, 4),
                    is_first=np.asarray([True] + [False] * (B - 1)), uv=f32(B, N, 2),
                    desc=desc(B, N, 8), level=rng.randint(0, 8, (B, N)).astype(np.int32),
                    angle=f32(B, N), feat_valid=rng.rand(B, N) < 0.8,
                    mp_local=i32(B, N), mp_server=i32(B, N),
                    imu=f32(B, 151)),
        "kf_updates": dict(agent=1, local_id=ids, T_abs=f32(B, 4, 4),
                           locked=np.asarray([True, False, True][:B]),
                           mp_local=i32(B, N), mp_server=i32(B, N)),
        "mps": dict(agent=1, local_id=ids, ref_kf_local=i32(B), pos_rel=f32(B, 3),
                    pos_abs=f32(B, 3), desc=desc(B, 8)),
        "mp_updates": dict(agent=1, local_id=ids, pos_abs=f32(B, 3),
                           locked=np.ones(B, bool)),
        "foreign_kfs": dict(server_id=ids + 7, owner=np.zeros(B, np.int32),
                            timestamp=rng.rand(B), T_abs=f32(B, 4, 4), uv=f32(B, N, 2),
                            desc=desc(B, N, 8),
                            level=rng.randint(0, 8, (B, N)).astype(np.int32),
                            angle=f32(B, N), feat_valid=rng.rand(B, N) < 0.8,
                            mp_server=i32(B, N), cam=f32(B, 4)),
        "foreign_mps": dict(server_id=ids + 11, owner=np.ones(B, np.int32),
                            pos_abs=f32(B, 3), desc=desc(B, 8)),
        "foreign_kf_updates": dict(server_id=ids + 3, T_abs=f32(B, 4, 4)),
        "foreign_mp_updates": dict(server_id=ids + 5, pos_abs=f32(B, 3)),
        "envelope": dict(agent=1, seq=42, erased_kf=np.asarray([4, 9], np.int32),
                         erased_mp=np.asarray([17], np.int32),
                         foreign_erased_kf=np.asarray([2], np.int32),
                         foreign_erased_mp=np.asarray([5, 6], np.int32),
                         closest_kf=2, scale=1.25, R_gw=np.eye(3, dtype=np.float32),
                         inertial=True, T_bc=np.eye(4, dtype=np.float32),
                         cam=np.asarray([300.0, 301.0, 160.0, 120.0], np.float32),
                         ack_seq=41, gauge_down=rng.randn(13), gauge_epoch=3)}


def build(proto, arrays: dict):
    klasses = {"kfs": proto.KFPayload, "kf_updates": proto.KFUpdatePayload,
               "mps": proto.MPPayload, "mp_updates": proto.MPUpdatePayload,
               "foreign_kfs": proto.ForeignKFPayload, "foreign_mps": proto.ForeignMPPayload,
               "foreign_kf_updates": proto.ForeignKFUpdatePayload,
               "foreign_mp_updates": proto.ForeignMPUpdatePayload}
    return proto.MapDelta(**arrays["envelope"],
                          **{n: klasses[n](**arrays[n]) for n in PAYLOADS})


def assert_deltas_equal(a, b):
    for n in PAYLOADS:
        pa, pb = getattr(a, n), getattr(b, n)
        for f in dataclasses.fields(pa):
            va, vb = getattr(pa, f.name), getattr(pb, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, (n, f.name)
                np.testing.assert_array_equal(va, vb, err_msg=f"{n}.{f.name}")
            else:
                assert va == vb, (n, f.name)
    for f in dataclasses.fields(a):
        if f.name in PAYLOADS:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.fixture(params=["native", "python"])
def codec_kind(request, monkeypatch):
    if request.param == "native":
        assert jcodec.native_available() and tcodec.native_available()
    else:
        monkeypatch.setattr(jcodec, "_load_native", lambda: None)
        monkeypatch.setattr(tcodec, "_load_native", lambda: None)
    return request.param


@pytest.mark.parametrize("seed", [0, 1])
def test_every_payload_packs_to_the_same_bytes(codec_kind, seed):
    arrays = delta_arrays(seed)
    jb = build(jproto, arrays).to_bytes()
    tb = build(tproto, arrays).to_bytes()
    assert jb == tb


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_decodes_the_others_bytes(codec_kind, direction):
    arrays = delta_arrays(3)
    src, dst = (jproto, tproto) if direction == "jax_to_port" else (tproto, jproto)
    data = build(src, arrays).to_bytes()
    got = dst.MapDelta.from_bytes(data)
    assert_deltas_equal(got, build(src, arrays))
    assert got.to_bytes() == data
    assert src.peek_seq(data) == dst.peek_seq(data) == 42


def test_the_native_and_python_codecs_write_the_same_frame():
    arrays = delta_arrays(4)
    meta = {"agent": 1, "seq": 2}
    items = [(k.encode(), np.ascontiguousarray(v)) for k, v in arrays["kfs"].items()
             if isinstance(v, np.ndarray)]
    lib = tcodec._load_native()
    assert lib is not None
    native = tcodec._pack_native(lib, b'{"agent":1,"seq":2}', items)
    assert native == tcodec._pack_py(b'{"agent":1,"seq":2}', items)
    m1, a1 = tcodec._unpack_py(native)
    m2, a2 = tcodec._unpack_native(lib, native)
    assert m1 == m2 == meta
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k])


def test_a_corrupted_frame_is_refused():
    data = bytearray(build(tproto, delta_arrays(5)).to_bytes())
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        tproto.MapDelta.from_bytes(bytes(data))
    with pytest.raises(ValueError):
        tproto.peek_seq(bytes(data))


def test_descriptors_keep_the_top_bit_across_the_wire():
    """uint32 on the wire -> int32 bit patterns on the device -> uint32 in
    the host snapshot: a view each way, never a cast."""
    words = np.asarray([[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0, 1, 0xDEADBEEF,
                         0x80000001, 0xC0000000]], np.uint32)
    t = desc_words(words)
    assert t.dtype == torch.int32
    assert int(t[0, 0]) == -2 ** 31 and int(t[0, 1]) == -1
    back = fetch({"mp_desc": t})["mp_desc"]
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, words)
    delta = tproto.MapDelta(agent=0, foreign_mps=tproto.ForeignMPPayload(
        server_id=np.asarray([0], np.int32), owner=np.asarray([1], np.int32),
        pos_abs=np.zeros((1, 3), np.float32), desc=back))
    out = jproto.MapDelta.from_bytes(delta.to_bytes())
    np.testing.assert_array_equal(out.foreign_mps.desc, words)
