"""Hand-written Hopper kernels of the frontend and their plain versions
(counterpart of multi_orbslam3_tpu/frontend/pallas_kernels.py).

- K1 ``fast_score_nms``: FAST-9/16 score + 3x3 NMS of one pyramid level
  (``csrc/fast_nms.cu``).
- K2 ``hamming_matrix``: (N, 8) x (M, 8) packed descriptor words ->
  (N, M) int32 Hamming distances (``csrc/hamming.cu``).

Dispatch is by the tensor's device only: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises. There is no
fallback from the GPU and no switch to turn a kernel off.

The kernels are compiled with nvcc for sm_90a into one shared library with
a plain C interface, at first use, into ``_build/`` next to this package
(keyed by a hash of the sources), and bound with ctypes. Each launch runs
on PyTorch's current stream and returns ``cudaGetLastError()``, which the
wrapper turns into an exception. Each wrapper counts its launches in a
plain int attribute ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from multi_orbslam3_tpu_torch.frontend import fast

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fast_nms.cu", "hamming.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib_handle = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile csrc/*.cu into _build/libmo3_kernels_<hash>.so unless that
    file exists. Returns {"path", "cached", "seconds", "log"}, where "log"
    holds nvcc's output (ptxas register and shared-memory use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libmo3_kernels_{_source_hash()}.so"
    if so.exists():
        return {"path": so, "cached": True, "seconds": 0.0, "log": ""}
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return {"path": so, "cached": False, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def _lib():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build()["path"]))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mo3_fast_score_nms.argtypes = [vp, vp, ci, ci, ctypes.c_float, vp]
            lib.mo3_fast_score_nms.restype = ci
            lib.mo3_hamming_matrix.argtypes = [vp, vp, vp, ci, ci, vp]
            lib.mo3_hamming_matrix.restype = ci
            _lib_handle = lib
    return _lib_handle


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


# ----------------------------------------------------------------------
# K1: FAST score + 3x3 NMS
# ----------------------------------------------------------------------

def fast_score_nms_ref(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Plain version of K1: fast.nms3x3(fast.fast_score(img, threshold))."""
    return fast.nms3x3(fast.fast_score(img, threshold))


def fast_score_nms(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) float32 level -> (H, W) float32 NMS'd FAST score (0 on the
    3-px border). CPU: plain version; CUDA: kernel K1."""
    if img.device.type == "cpu":
        return fast_score_nms_ref(img, threshold)
    _check_cuda("fast_score_nms", img, torch.float32, 2)
    h, w = img.shape
    out = torch.empty_like(img)
    if h == 0 or w == 0:
        return out
    err = _lib().mo3_fast_score_nms(
        img.data_ptr(), out.data_ptr(), h, w, float(threshold),
        torch.cuda.current_stream(img.device).cuda_stream)
    _raise_on(err, "fast_score_nms")
    fast_score_nms.launches += 1
    return out


fast_score_nms.launches = 0


# ----------------------------------------------------------------------
# K2: packed Hamming distance matrix
# ----------------------------------------------------------------------

def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR). Each shift is
    followed by a mask, so the arithmetic right shift of a negative int32
    cannot leak sign bits into the count."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF) + ((v >> 24) & 0xFF)


def hamming_matrix_ref(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (N, 8) x (M, 8) int32 words -> (N, M) int32,
    accumulated one word at a time (N x M live, not N x M x 8)."""
    acc = torch.zeros((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=d1.device)
    for wd in range(d1.shape[1]):
        acc += popcount32(d1[:, None, wd] ^ d2[None, :, wd])
    return acc


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 descriptor words -> (N, M) int32 Hamming
    distances. CPU: plain version; CUDA: kernel K2."""
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_matrix_ref(d1, d2)
    _check_cuda("hamming_matrix", d1, torch.int32, 2)
    _check_cuda("hamming_matrix", d2, torch.int32, 2)
    if d1.shape[1] != 8 or d2.shape[1] != 8:
        raise ValueError("hamming_matrix: expected (N, 8) and (M, 8) words")
    n, m = d1.shape[0], d2.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=d1.device)
    if n == 0 or m == 0:
        return out
    err = _lib().mo3_hamming_matrix(
        d1.data_ptr(), d2.data_ptr(), out.data_ptr(), n, m,
        torch.cuda.current_stream(d1.device).cuda_stream)
    _raise_on(err, "hamming_matrix")
    hamming_matrix.launches += 1
    return out


hamming_matrix.launches = 0


def reset_launch_counts() -> None:
    fast_score_nms.launches = 0
    hamming_matrix.launches = 0


def launch_counts() -> dict:
    return {"fast_score_nms": fast_score_nms.launches,
            "hamming_matrix": hamming_matrix.launches}
