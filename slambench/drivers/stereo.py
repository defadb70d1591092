"""The system "stereo": one ``StereoSlam`` with loop closing on; a round
is one frame, one call of ``process_frame_stereo_pipelined``. The
comparison samples its fused steps ("step"), its K2 searches ("k2proj.*",
"k2valid.*") and its place-recognition queries ("bow")."""

from __future__ import annotations

from typing import List

from slambench.drivers import TraceCapture
from slambench.harness.traffic import AgentFrames


class Driver:
    checked = "step"
    compared = ("step", "k2", "bow")

    def __init__(self, cfg, frames: List[AgentFrames], device, spans, capture):
        from multi_orbslam3_tpu_torch.pipeline.stereo_system import StereoSlam
        self.cfg, self.frames, self.device = cfg, frames, device
        self.sp, self.cap = spans, capture
        self.tcap = TraceCapture()
        self.pos = 0                 # frame index
        self.slam = StereoSlam(cfg, enable_loop_closing=True, device=device)

    def frames_left(self) -> int:
        return self.frames[0].left.shape[0] - self.pos

    def warmup(self, n: int) -> None:
        """n rounds before the window: every path the window uses runs
        once at the cell's shapes."""
        for _ in range(n):
            self.round()

    def install(self) -> None:
        from multi_orbslam3_tpu_torch.bow import database as dbm
        from multi_orbslam3_tpu_torch.frontend import kernels
        from multi_orbslam3_tpu_torch.pipeline import local_mapping, tracking
        from multi_orbslam3_tpu_torch.pipeline.loop_closing import LoopCloser
        sp, cap, tcap = self.sp, self.cap, self.tcap

        def step_after(out, config, m, il, ir, T_cur, T_vel):
            cap.offer("step", lambda: {"m": m, "il": il, "ir": ir,
                                       "T_cur": T_cur, "T_vel": T_vel, "out": out})

        def k1_after(out, levels, threshold):
            if tcap.on:
                tcap.k1.append((list(levels), float(threshold)))

        def proj_after(out, *args):
            layer = sp.current() or "other"
            cap.offer(f"k2proj.{layer}", lambda: {"args": args, "out": out, "layer": layer})
            if tcap.on:
                tcap.k2proj.append(args)

        def valid_after(out, d1, v1, d2, v2, *rest):
            layer = sp.current() or "other"
            cap.offer(f"k2valid.{layer}",
                      lambda: {"args": (d1, v1, d2, v2), "out": out, "layer": layer})
            if tcap.on:
                tcap.k2valid.append((v1, v2))

        def query_after(scores, db, voc, desc, valid, exclude):
            if sp.current() == "place_recognition":
                m = self.slam.m
                cap.offer("bow", lambda: {"desc": desc, "valid": valid, "exclude": exclude,
                                          "active": db.active, "m": m, "scores": scores})

        sp.wrap(tracking, "fused_step_stereo_chained", "fused_step", after=step_after)
        sp.wrap(local_mapping, "map_keyframe", "mapping")
        sp.wrap(LoopCloser, "on_keyframe", "place_recognition")
        sp.wrap(kernels, "fast_score_nms_levels", None, after=k1_after)
        sp.wrap(kernels, "hamming_best_two_projection", None, after=proj_after)
        sp.wrap(kernels, "hamming_best_two_valid", None, after=valid_after)
        sp.wrap(dbm, "query", None, after=query_after)

    def round(self) -> int:
        """One frame; returns the frames processed (0 when none is left)."""
        i = self.pos
        fr = self.frames[0]
        if i >= fr.left.shape[0]:
            return 0
        with self.sp.span("frame"):
            self.slam.process_frame_stereo_pipelined(fr.left[i], fr.right[i],
                                                     float(fr.timestamps[i]))
        self.pos += 1
        return 1

    def work(self) -> dict:
        s, lc = self.slam.stats, self.slam.loop_closer
        return {"frames": self.pos, "keyframes": s["kf_inserted"],
                "frames_lost": s["frames_lost"],
                "relocalizations": s.get("relocalizations", 0),
                "maps_created": s.get("maps_created", 0) + s.get("map_resets", 0),
                "loops": lc.loops_closed, "merges": lc.merges,
                "landmarks_created": s["mp_created"]}

    def map_size(self) -> dict:
        """The map's valid keyframes and landmarks (read after the window)."""
        m = self.slam.m
        return {"map_keyframes": int(m.kf_valid.sum()), "map_landmarks": int(m.mp_valid.sum())}

    def release(self) -> None:
        self.slam = None

