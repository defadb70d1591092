"""multi_orbslam3_tpu_torch — the PyTorch + CUDA port of multi_orbslam3_tpu.

The layout mirrors the JAX package module for module, so each function's
counterpart is found under the same path:

- ``geometry``  — SO3/SE3 ops, pinhole/radtan/KB8 cameras, triangulation.
- ``frontend``  — pyramid, FAST, ORB, extraction, Hamming matching; the
                  two hand-written Hopper kernels live behind
                  ``frontend/kernels.py`` (sources in ``csrc/``).
- ``map``       — the fixed-capacity MapState and its functional updates.
- ``opt``       — robust kernels, pose-only optimisation, windowed BA.
- ``pipeline``  — tracking, two-view initializer, local mapping, MonoSlam.
- ``interop``   — numpy in/out of MapState/FrameFeatures (parity tests).

JAX-free helpers (``multi_orbslam3_tpu.config``, ``.dataio.synthetic``,
``.eval.ate``) are imported from the JAX package, which keeps them free of
any ``jax`` import; nothing in this package imports ``jax``.

Precision: every float32 matmul and convolution runs in full float32. The
optimizers' normal equations diverge under reduced precision, and cuDNN's
TF32 default would perturb the pre-BRIEF Gaussian blur enough to flip
descriptor bits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
