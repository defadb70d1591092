"""multi_orbslam3_tpu_torch — the PyTorch + CUDA port of multi_orbslam3_tpu.

The layout mirrors the JAX package module for module, so each function's
counterpart is found under the same path:

- ``geometry``  — SO3/SE3 ops, pinhole/radtan/KB8 cameras, triangulation.
- ``frontend``  — pyramid, FAST, ORB, extraction, Hamming matching; the
                  hand-written Hopper kernels live behind
                  ``frontend/kernels.py`` (sources in ``csrc/``).
- ``map``       — the fixed-capacity MapState and its functional updates.
- ``imu``       — on-manifold IMU preintegration.
- ``opt``       — robust kernels, pose-only optimisation (mono and stereo
                  rows), windowed BA, PnP, Sim3, the pose graph, and the
                  inertial solvers (VI pose optimisation, inertial
                  initialisation, visual-inertial window BA).
- ``pipeline``  — tracking, two-view initializer, local mapping, loop
                  closing, and the six sensor modes: ``MonoSlam``,
                  ``StereoSlam``, ``RGBDSlam``, ``MonoInertialSlam``,
                  ``StereoInertialSlam``, ``RGBDInertialSlam``.
- ``dataio``    — TUM trajectories and map checkpoints (the .npz layout of
                  the JAX package, readable by both).
- ``interop``   — numpy in/out of MapState, FrameFeatures, StereoDepth,
                  Preintegrated (parity tests).
- ``profiling`` — per-stage timings, wall-time buckets and device traces
                  (busy share, top device ops, launches a frame).

- ``config``, ``dataio.synthetic``, ``eval.ate`` — the port's own copies of
                  the JAX package's numpy-only modules.

Nothing in this package imports ``jax`` or the JAX package; the bundled
vocabulary files under ``bow/`` are copies too.

Precision: every float32 matmul and convolution runs in full float32. The
optimizers' normal equations diverge under reduced precision, and cuDNN's
TF32 default would perturb the pre-BRIEF Gaussian blur enough to flip
descriptor bits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
