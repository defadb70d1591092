"""The port's entry scripts (multi_orbslam3_tpu_torch/apps/) against the
repository's apps/ on the CPU: run_slam writes the same outputs with the
same report keys as the JAX app on a short synthetic run, its TUM file
loads in the JAX package's reader; and, slow: the same on a run long
enough for an ATE, and, like tests/test_multiprocess.py, the port's
run_server and two run_client processes over localhost TCP, whose
checkpoint and trajectories load in the JAX package's readers.

On the CPU the port tracks a 640x480 frame in seconds: its plain
projection match scores every landmark slot of the map's capacity
(16,384) against every feature, where the card runs the fused kernel."""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.dataio import checkpoint as jckpt
from multi_orbslam3_tpu.dataio import tum as jtum

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _jax_app(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_app_{name}", REPO / "apps" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv, monkeypatch, capsys) -> dict:
    monkeypatch.setattr(sys, "argv", ["app"] + argv)
    main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both_run_slam(tmp_path, monkeypatch, capsys, argv) -> tuple:
    """(JAX report, port report) of run_slam on the same arguments, the
    port's with --device cpu; each writes into its own directory."""
    from multi_orbslam3_tpu_torch.apps import run_slam
    rep_j = _run_main(_jax_app("run_slam").main, argv + ["--out", str(tmp_path / "jax")],
                      monkeypatch, capsys)
    rep_t = _run_main(run_slam.main, argv + ["--out", str(tmp_path / "torch"), "--device", "cpu"],
                      monkeypatch, capsys)
    assert rep_t.keys() == rep_j.keys(), (rep_t, rep_j)
    assert rep_t["stats"].keys() == rep_j["stats"].keys(), (rep_t, rep_j)
    assert rep_t["timing"]["frame"].keys() == rep_j["timing"]["frame"].keys()
    assert rep_t["frames"] == rep_j["frames"] and rep_t["sensor"] == rep_j["sensor"]
    out = tmp_path / "torch"
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "jax")) == \
        ["KeyFrameTrajectory.txt", "map.png", "report.json"]
    assert json.loads((out / "report.json").read_text()) == rep_t
    traj = jtum.read_tum(str(out / "KeyFrameTrajectory.txt"))
    assert len(traj) >= 2 and traj[0][1].shape == (4, 4)
    return rep_j, rep_t


def test_run_slam_writes_what_the_jax_app_writes(tmp_path, monkeypatch, capsys):
    """4 synthetic frames (synthetic_mono, 640x480, loop closing off)
    through both packages' run_slam: the same files, the same report and
    stats keys (too few frames for an ATE in either); the report line is
    report.json and the TUM file loads in the JAX package's reader."""
    rep_j, rep_t = _both_run_slam(tmp_path, monkeypatch, capsys,
                                  ["--frames", "4", "--no-loop-closing"])
    assert "ate_rmse" not in rep_t and rep_t["frames"] == 4


@pytest.mark.slow
def test_run_slam_reports_the_ate_like_the_jax_app(tmp_path, monkeypatch, capsys):
    """14 frames with loop closing on: at least 10 tracked in both, so the
    reports carry the ATE keys too; the port's ATE < 0.05 x max(span, 1)."""
    rep_j, rep_t = _both_run_slam(tmp_path, monkeypatch, capsys, ["--frames", "14"])
    assert "ate_rmse" in rep_t and rep_t["frames"] == 14
    assert rep_t["ate_rmse"] < 0.05 * max(rep_t["span"], 1.0), rep_t


def test_run_mono_maps_inertial_to_the_sensor_flag(monkeypatch):
    """run_mono hands its arguments to the port's run_slam, with --inertial
    as --sensor mono_inertial."""
    from multi_orbslam3_tpu_torch.apps import run_mono, run_slam
    seen = []
    monkeypatch.setattr(run_slam, "main", lambda: seen.append(list(sys.argv[1:])))
    for extra, sensor in (([], "mono"), (["--inertial"], "mono_inertial")):
        monkeypatch.setattr(sys, "argv", ["run_mono", "--out", "x", *extra, "--frames", "3"])
        run_mono.main()
        assert seen[-1] == ["--out", "x", "--frames", "3", "--sensor", sensor]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _module(name: str, *args: str) -> list:
    return [sys.executable, "-m", f"multi_orbslam3_tpu_torch.apps.{name}", *args]


@pytest.mark.slow
def test_server_and_two_clients_as_processes(tmp_path):
    """tests/test_multiprocess.py on the port: run_server and two
    run_client processes (--small, 30 frames each, --device cpu) over
    localhost TCP. Registration, ingest, a cross-agent merge, the
    artifacts, and a clean exit; the checkpoint and the trajectories load
    in the JAX package's readers."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    srv_out = str(tmp_path / "server")
    srv = subprocess.Popen(
        _module("run_server", "--port", str(port), "--agents", "2", "--out", srv_out,
                "--duration", "900", "--idle-exit", "5", "--small", "--device", "cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    clients = []
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                if srv.poll() is not None:
                    raise AssertionError(f"server died early: {srv.communicate()[1][-2000:]}")
                time.sleep(0.5)
        else:
            raise AssertionError("server never started listening")
        for a in range(2):
            clients.append(subprocess.Popen(
                _module("run_client", "--agent", str(a), "--server", f"127.0.0.1:{port}",
                        "--out", str(tmp_path / f"client{a}"), "--frames", "30", "--small",
                        "--device", "cpu"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO))
        c_stats = []
        for cl in clients:
            out, err = cl.communicate(timeout=900)
            assert cl.returncode == 0, err[-3000:]
            c_stats.append(json.loads(out.strip().splitlines()[-1]))
        out, err = srv.communicate(timeout=600)
        assert srv.returncode == 0, err[-3000:]
        s_stats = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in [srv] + clients:
            if p.poll() is None:
                p.kill()
    for st in c_stats:
        assert st["deltas_sent"] > 0, st
        assert st["kf_inserted"] > 4, st
    assert s_stats["kf_ingested"] > 8, s_stats
    assert s_stats["merges"] >= 1, s_stats
    m, extra = jckpt.load_map(os.path.join(srv_out, "server_map.npz"))
    assert int(np.asarray(m.n_kf)) > 8 and {"kf_map", "mp_map"} <= set(extra)
    for a in range(2):
        assert len(jtum.read_tum(os.path.join(srv_out, f"agent{a}_server_traj.txt"))) > 0
        assert os.path.exists(os.path.join(str(tmp_path / f"client{a}"),
                                           "KeyFrameTrajectory.txt"))
    assert os.path.exists(os.path.join(srv_out, "server_map.png"))
