"""Hand-written Hopper kernels of the frontend and their plain versions
(counterpart of multi_orbslam3_tpu/frontend/pallas_kernels.py).

- K1 ``fast_score_nms_levels``: FAST-9/16 score + 3x3 NMS of up to
  MAX_LEVELS levels in one launch (``csrc/fast_nms.cu``; more levels go in
  groups, one launch each); ``fast_score_nms`` is the same call with one
  level.
- K2 ``hamming_matrix``: (N, 8) x (M, 8) packed descriptor words ->
  (N, M) int32 Hamming distances, written tile by tile from the 1-bit
  tensor-core MMA by a persistent grid (``csrc/hamming_mma.cu``), and its
  fused forms, which mask and reduce in the kernel and never write N x M:
  - ``hamming_best_two_valid`` (row and column validity; per row the first
    best column, best and second-best distance, per column the first best
    row): a compacted tensor-core search (``csrc/hamming_mma.cu``), a
    pre-pass that lists the valid rows and columns, then the 1-bit MMA over
    compacted row tiles x column stages staged by cp.async, the rows' column
    splits merged on the device by the last block of a row tile;
  - ``hamming_best_two_projection`` (validity, a per-row radius around a
    projected position and a pyramid-level window; the row results): a
    grid-indexed window search over a 16-px cell index of the columns built
    in shared memory (``csrc/hamming.cu``; one launch for up to PROJ_CHUNK
    columns, one a chunk of columns beyond, each seeded with the rows'
    results so far);
  - ``hamming_best_two_stereo`` (validity, epipolar row, disparity range and
    pyramid level between a left and a right feature set; the row results):
    a row-band search over a per-row index of the right set built in shared
    memory (``csrc/stereo_band.cu``; chunks of STEREO_CHUNK as above).
- ``pose_optimization``: the motion-only pose optimisation of one pose,
  every Gauss-Newton iteration and inlier re-classification of its
  rounds x iters schedule, in one launch of one block
  (``csrc/pose_opt.cu``; no Pallas kernel: the port of the JAX package's
  jitted loop). ``opt/pose_opt.py`` dispatches to it and holds its plain
  version and the CPU model of its arithmetic.

  Beside each search that visits columns out of column order, a CPU model
  of its visit (``stereo_band_candidates``, ``projection_window_candidates``)
  and of the search on it (``hamming_best_two_stereo_banded_ref``,
  ``hamming_best_two_projection_gridded_ref``,
  ``hamming_best_two_valid_compacted_ref``) holds the design to the plain
  version in the CPU tests; no main path runs them.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises. There is no
fallback from the GPU and no switch to turn a kernel off.

Each source is compiled by its own nvcc process for sm_90a, all started
together, into a shared library with a plain C interface, at first use,
into ``_build/`` next to this package (keyed by a hash of the sources),
and bound with ctypes. Each launch runs on PyTorch's current stream and
returns ``cudaGetLastError()``, which the wrapper turns into an exception.
Each wrapper counts its launches (``launch_counts()``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import types
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from multi_orbslam3_tpu_torch.frontend import fast

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fast_nms.cu", "hamming.cu", "hamming_mma.cu", "stereo_band.cu", "pose_opt.cu")
HEADERS = ("match_core.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the pose optimisation rounds each product and sum on its own, as the
# plain version's tensor ops do (its CPU model repeats it op for op)
SOURCE_FLAGS = {"pose_opt.cu": ("-fmad=false",)}
BIG = 10_000          # distance of a masked pair (csrc/match_core.cuh)
MAX_LEVELS = 16       # levels of one K1 launch (its table, csrc/fast_nms.cu)
STEREO_CHUNK = 4096   # right features of one stereo launch (its index, csrc/stereo_band.cu)
STEREO_MAX_BUCKETS = 2048   # image rows its index spans (the rest: overflow)
STEREO_V_LIMIT = 2.0 ** 20  # |v| at or above this: the overflow bucket
# the two matchers' design constants, as csrc/ sets them for the kernels
# (tests/test_torch_k2_matchers.py holds each equal to its csrc/ value)
PROJ_CHUNK = 8192     # columns of one projection launch (its index, csrc/hamming.cu)
PROJ_CELL = 16.0      # px a side of the projection index's cells
PROJ_MAX_CELLS = 4096  # cells the index spans (the rest: overflow)
PROJ_LIMIT = 2.0 ** 20  # |u| or |v| at or above this: the overflow list
VALID_ROWS = 128      # compacted rows a tile of the validity search (csrc/hamming_mma.cu)
VALID_CHUNK = 128     # compacted columns a stage
VALID_MAX_SPLITS = 8  # column splits of one row tile
POSE_THREADS = 256    # threads of the pose optimisation's one block (csrc/pose_opt.cu)

_lib_handle = None
_lib_lock = threading.Lock()
_LAUNCHES = {"fast_score_nms_levels": 0, "hamming_matrix": 0,
             "hamming_best_two_valid": 0, "hamming_best_two_projection": 0,
             "hamming_best_two_stereo": 0, "pose_optimization": 0}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile each of csrc/*.cu into _build/libmo3_<stem>_<hash>.so unless
    that file exists, one nvcc process a source, all running at once.
    Returns {"paths": {source: path}, "cached", "seconds", "log"}, where
    "log" holds nvcc's output (ptxas register and shared-memory use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_hash()
    paths = {name: BUILD_DIR / f"libmo3_{Path(name).stem}_{tag}.so"
             for name in SOURCES}
    todo = [name for name in SOURCES if not paths[name].exists()]
    t0 = time.perf_counter()
    nvcc = _nvcc() if todo else None
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs.append((name, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", tmp, str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"paths": paths, "cached": not todo,
            "seconds": time.perf_counter() - t0, "log": "".join(log)}


def _lib():
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            paths = build()["paths"]
            fast_so, ham_so, mma_so, band_so, pose_so = (ctypes.CDLL(str(paths[n]))
                                                         for n in SOURCES)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fns = types.SimpleNamespace(
                fast_score_nms_levels=fast_so.mo3_fast_score_nms_levels,
                hamming_matrix=mma_so.mo3_hamming_matrix,
                hamming_best_two_valid=mma_so.mo3_hamming_best_two_valid,
                hamming_best_two_projection=ham_so.mo3_hamming_best_two_projection,
                hamming_best_two_stereo=band_so.mo3_hamming_best_two_stereo,
                pose_optimization=pose_so.mo3_pose_optimization)
            fns.fast_score_nms_levels.argtypes = [vp, vp, vp, vp, ci, cf, vp]
            fns.hamming_matrix.argtypes = [vp, vp, vp, ci, ci, vp]
            fns.hamming_best_two_valid.argtypes = [
                vp, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
            fns.hamming_best_two_projection.argtypes = [
                vp, vp, vp, vp, cf, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp,
                vp]
            fns.hamming_best_two_stereo.argtypes = [
                vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, cf, cf, ci,
                vp, vp, vp, vp]
            fns.pose_optimization.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, cf, vp, vp, vp, vp, vp]
            for fn in vars(fns).values():
                fn.restype = ci
            _lib_handle = fns
    return _lib_handle


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple):
    """Raise unless t is a contiguous CUDA tensor of this dtype on the
    current device whose shape matches (None stands for any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
    if (t.dtype != dtype or t.dim() != len(shape) or not t.is_contiguous()
            or any(want is not None and got != want
                   for got, want in zip(t.shape, shape))):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def _launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream and count it."""
    err = getattr(_lib(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    _LAUNCHES[name] += 1


def _all_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """The kernels read descriptor rows as 16-byte words and feature
    positions as 8-byte pairs; the matrix kernel writes 16-byte words."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ----------------------------------------------------------------------
# K1: FAST score + 3x3 NMS
# ----------------------------------------------------------------------

def fast_score_nms_ref(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Plain version of K1 for one level:
    fast.nms3x3(fast.fast_score(img, threshold))."""
    return fast.nms3x3(fast.fast_score(img, threshold))


def fast_score_nms_levels_ref(levels: Sequence[torch.Tensor],
                              threshold: float) -> List[torch.Tensor]:
    """Plain version of K1: the one-level plain version, level by level."""
    return [fast_score_nms_ref(im, threshold) for im in levels]


def even_groups(n: int, cap: int) -> List[Tuple[int, int]]:
    """[start, end) runs that cover 0 .. n - 1 in order, each at most `cap`
    long: as few as `cap` allows, of even length. One run when n <= cap;
    none when n = 0."""
    if n <= 0:
        return []
    width = -(-n // -(-n // cap))
    return [(s, min(n, s + width)) for s in range(0, n, width)]


def fast_score_nms_levels(levels: Sequence[torch.Tensor],
                          threshold: float) -> List[torch.Tensor]:
    """(H_i, W_i) float32 levels -> their (H_i, W_i) float32 NMS'd FAST
    scores (0 on the 3-px border). CPU: plain version; CUDA: kernel K1,
    one launch for up to MAX_LEVELS levels and one a group of at most
    MAX_LEVELS beyond (even_groups: the 18 levels of a 9-level stereo pair
    are two launches of 9); the results are views of one buffer."""
    levels = list(levels)
    if _all_cpu(*levels):
        return fast_score_nms_levels_ref(levels, threshold)
    for im in levels:
        _check_cuda("fast_score_nms_levels", im, torch.float32, (None, None))
    flat = torch.empty(sum(im.numel() for im in levels), dtype=torch.float32,
                       device=levels[0].device)
    outs, offset = [], 0
    for im in levels:
        outs.append(flat[offset:offset + im.numel()].view(im.shape))
        offset += im.numel()
    work = [(im, out) for im, out in zip(levels, outs) if im.numel() > 0]
    for lo, hi in even_groups(len(work), MAX_LEVELS):
        group, n = work[lo:hi], hi - lo
        _launch("fast_score_nms_levels",
                (ctypes.c_void_p * n)(*(im.data_ptr() for im, _ in group)),
                (ctypes.c_void_p * n)(*(out.data_ptr() for _, out in group)),
                (ctypes.c_int * n)(*(im.shape[0] for im, _ in group)),
                (ctypes.c_int * n)(*(im.shape[1] for im, _ in group)),
                n, float(threshold))
    return outs


def fast_score_nms(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """One (H, W) float32 level -> its NMS'd FAST score: K1 with one level."""
    return fast_score_nms_levels([img], threshold)[0]


# ----------------------------------------------------------------------
# K2: packed Hamming distance, as a matrix and as fused matches
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
    distances. CPU: plain version; CUDA: kernel K2's matrix writer
    (popc(a) + popc(b) - 2 popc(a & b), the last from the 1-bit MMA)."""
    if _all_cpu(d1, d2):
        return hamming_matrix_ref(d1, d2)
    _check_cuda("hamming_matrix", d1, torch.int32, (None, 8))
    _check_cuda("hamming_matrix", d2, torch.int32, (None, 8))
    n, m = d1.shape[0], d2.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=d1.device)
    if n == 0 or m == 0:
        return out
    d1, d2 = _aligned16(d1), _aligned16(d2)
    _launch("hamming_matrix", d1.data_ptr(), d2.data_ptr(), out.data_ptr(), n, m)
    return out


def unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 descriptor words -> (N, 256) int8 of +-1: bit b of word
    w (b = 0 the least significant, b = 31 the sign bit of the int32) is
    element 32 w + b, +1 where the bit is set and -1 where it is clear. For
    two such rows the dot product is 256 - 2 x their Hamming distance, which
    is how an int8 matrix product (cuBLASLt's, ``torch._int_mm``) computes
    the matrix; the port itself does not take that route."""
    bits = (words[:, :, None] >> torch.arange(32, dtype=torch.int32,
                                              device=words.device)) & 1
    return (2 * bits - 1).to(torch.int8).reshape(words.shape[0], 256)


def hamming_from_pm1_dot(dot: torch.Tensor) -> torch.Tensor:
    """The Hamming distances from the int32 dot products of +-1 rows."""
    return (256 - dot) // 2


def best_two(dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row best index (first on ties), best and second-best distance of
    a masked (N, M) distance matrix."""
    best_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    masked = dist.scatter(1, best_idx[:, None], BIG)
    return best_idx, best, torch.amin(masked, dim=1)


def hamming_best_two_valid_ref(d1: torch.Tensor, valid1: torch.Tensor,
                               d2: torch.Tensor, valid2: torch.Tensor,
                               row_block: Union[int, None] = None):
    """Plain version of the validity-masked fused match: the matrix, the
    mask, best_two and the column argmin, one after the other. With
    `row_block` the rows go through in blocks of that many, so that only
    row_block x M is live at a time; the result is the same."""
    n = d1.shape[0]
    step = n if row_block is None else row_block
    rows, col_min, col_arg = [], None, None
    for r0 in range(0, n, step):
        dist = torch.where(valid1[r0:r0 + step, None] & valid2[None, :],
                           hamming_matrix_ref(d1[r0:r0 + step], d2), BIG)
        rows.append(best_two(dist))
        cmin = torch.amin(dist, dim=0)
        carg = torch.argmin(dist, dim=0) + r0     # first row on ties
        if col_min is None:
            col_min, col_arg = cmin, carg
        else:                                     # earlier block wins ties
            col_arg = torch.where(cmin < col_min, carg, col_arg)
            col_min = torch.minimum(cmin, col_min)
    idx, best, second = (torch.cat(parts) for parts in zip(*rows))
    return idx, best, second, col_arg


def valid_splits(row_tiles: int, chunks: int, grid: int) -> Tuple[int, int]:
    """(stages a split, splits) of the validity search's row tiles, as
    csrc/hamming_mma.cu chooses them on the device: the split count up to
    VALID_MAX_SPLITS that minimises stages a split x waves of a persistent
    grid of `grid` blocks (the fewest splits on a tie), then as many splits
    as that stage count needs."""
    best_s, best_cost = 1, None
    for s in range(1, min(VALID_MAX_SPLITS, chunks) + 1):
        cps = -(-chunks // s)
        items = row_tiles * -(-chunks // cps)
        cost = min(cps * -(-items // grid), (1 << 27) - 1)
        if best_cost is None or cost < best_cost:
            best_s, best_cost = s, cost
    cps = -(-chunks // best_s)
    return cps, -(-chunks // cps)


def hamming_best_two_valid_compacted_ref(d1, valid1, d2, valid2, grid: int = 528):
    """CPU model of csrc/hamming_mma.cu's validity search with a persistent
    grid of `grid` blocks: the valid rows and columns compacted into
    ascending lists; row tiles of VALID_ROWS compacted rows; the compacted
    columns in stages of VALID_CHUNK, grouped into splits by valid_splits;
    per (tile, split) each row's (best, column, second) over the split, the
    columns ascending (the first on ties), and per column the least
    (distance << 32 | row) key over the tile's rows, offered to a running
    minimum as the kernel's atomicMin is; a row's splits merged by
    stat_merge. The work items run last first and a row's splits merge
    last first, the orders that a rule keeping the first one seen would get
    wrong. Equal to hamming_best_two_valid_ref for every grid size."""
    v1, v2 = valid1.cpu().numpy(), valid2.cpu().numpy()
    n, m = v1.shape[0], v2.shape[0]
    rows, cols = np.flatnonzero(v1), np.flatnonzero(v2)
    idx = np.zeros(n, dtype=np.int64)
    best = np.full(n, BIG, dtype=np.int32)
    second = np.full(n, BIG, dtype=np.int32)
    col_key = np.full(m, BIG << 32, dtype=np.int64)
    if rows.size and cols.size:
        dist = hamming_matrix_ref(d1.cpu()[torch.from_numpy(rows)],
                                  d2.cpu()[torch.from_numpy(cols)]).numpy().astype(np.int64)
        row_tiles = -(-rows.size // VALID_ROWS)
        cps, splits = valid_splits(row_tiles, -(-cols.size // VALID_CHUNK), grid)
        part = {}
        for item in reversed(range(row_tiles * splits)):
            rt, sp = divmod(item, splits)
            r0, r1 = rt * VALID_ROWS, min(rows.size, (rt + 1) * VALID_ROWS)
            c0, c1 = sp * cps * VALID_CHUNK, min(cols.size, (sp + 1) * cps * VALID_CHUNK)
            block = dist[r0:r1, c0:c1]
            arg = np.argmin(block, axis=1)                 # first position on ties
            b = block[np.arange(r1 - r0), arg]
            rest = block.copy()
            rest[np.arange(r1 - r0), arg] = BIG
            s_ = rest.min(axis=1) if block.shape[1] > 1 else np.full(r1 - r0, BIG)
            for k in range(r1 - r0):
                part.setdefault(r0 + k, []).append((int(b[k]), int(c0 + arg[k]), int(s_[k])))
            keys = (block << 32) | rows[r0:r1, None]
            np.minimum.at(col_key, cols[c0:c1], keys.min(axis=0))
        for p, parts in part.items():
            acc = (BIG, 0, BIG)
            for q in parts:                                # last split first
                acc = stat_merge(acc, q)
            best[rows[p]], second[rows[p]] = acc[0], acc[2]
            idx[rows[p]] = cols[acc[1]] if acc[0] < BIG else 0
    dev = d1.device
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(best).to(dev),
            torch.from_numpy(second).to(dev),
            torch.from_numpy(col_key & 0xFFFFFFFF).to(dev))


def hamming_best_two_valid(d1: torch.Tensor, valid1: torch.Tensor,
                           d2: torch.Tensor, valid2: torch.Tensor):
    """Hamming match of (N, 8) against (M, 8) int32 descriptor words under
    the mask valid1[:, None] & valid2[None, :], a masked pair counting as
    BIG. Returns, per row, (idx int64: the first column with the minimum,
    best int32, second int32: the minimum with position idx taken out), and
    per column argmin_row int64: the first row with the minimum. A row or
    column with nothing unmasked gives idx 0 and BIG.

    CPU: plain version; CUDA: the compacted tensor-core search
    (csrc/hamming_mma.cu), which writes no N x M: a pre-pass lists the
    valid rows and columns and initialises the outputs, the search runs the
    1-bit MMA over the compacted pairs only; with the column keys' low
    words taken as int64, three device launches a call and no read-back."""
    n, m = d1.shape[0], d2.shape[0]
    if n == 0 or m == 0:
        dev = d1.device
        return (torch.zeros(n, dtype=torch.int64, device=dev),
                torch.full((n,), BIG, dtype=torch.int32, device=dev),
                torch.full((n,), BIG, dtype=torch.int32, device=dev),
                torch.zeros(m, dtype=torch.int64, device=dev))
    if _all_cpu(d1, valid1, d2, valid2):
        return hamming_best_two_valid_ref(d1, valid1, d2, valid2)
    name = "hamming_best_two_valid"
    _check_cuda(name, d1, torch.int32, (n, 8))
    _check_cuda(name, valid1, torch.bool, (n,))
    _check_cuda(name, d2, torch.int32, (m, 8))
    _check_cuda(name, valid2, torch.bool, (m,))
    d1, d2 = _aligned16(d1), _aligned16(d2)
    dev = d1.device
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty(n, dtype=torch.int32, device=dev)
    # per-column (distance << 32 | row) keys for the kernel's atomicMin,
    # initialised by its pre-pass
    col_key = torch.empty(m, dtype=torch.int64, device=dev)
    # scratch: counts, row list, column list, row tiles' counters, then the
    # splits' partial statistics (16-byte entries)
    tiles = -(-n // VALID_ROWS)
    lists = -(-(2 + n + m + tiles) // 4) * 4
    scratch = torch.empty(lists + 4 * VALID_MAX_SPLITS * n, dtype=torch.int32, device=dev)
    ptr = scratch.data_ptr()
    _launch(name, d1.data_ptr(), valid1.data_ptr(), n, d2.data_ptr(), valid2.data_ptr(), m,
            idx.data_ptr(), best.data_ptr(), second.data_ptr(), col_key.data_ptr(),
            ptr, ptr + 4 * 2, ptr + 4 * (2 + n), ptr + 4 * (2 + n + m), ptr + 4 * lists)
    return idx, best, second, col_key & 0xFFFFFFFF


def _row_radius(radius, n: int, device) -> torch.Tensor:
    if isinstance(radius, torch.Tensor):
        return radius.expand(n)
    return torch.full((n,), float(radius), device=device)


def hamming_best_two_projection_ref(mp_desc, proj_uv, proj_valid, radius,
                                    pred_level, feat_desc, feat_uv, feat_valid,
                                    feat_level, level_slack: int):
    """Plain version of the projection-masked fused match: the (N, M)
    radius, level and validity mask, the matrix, then best_two."""
    d2 = torch.sum((proj_uv[:, None, :] - feat_uv[None, :, :]) ** 2, dim=-1)
    r = _row_radius(radius, proj_uv.shape[0], proj_uv.device)
    in_radius = d2 <= (r[:, None] ** 2)
    lv_ok = torch.abs(feat_level[None, :] - pred_level[:, None]) <= level_slack
    mask = in_radius & lv_ok & proj_valid[:, None] & feat_valid[None, :]
    return best_two(torch.where(mask, hamming_matrix_ref(mp_desc, feat_desc), BIG))


def projection_chunks(m: int) -> List[Tuple[int, int]]:
    """The column chunks of the projection match's launches: PROJ_CHUNK
    columns each, the rest in the last; one chunk up to PROJ_CHUNK."""
    return [(s, min(m, s + PROJ_CHUNK)) for s in range(0, m, PROJ_CHUNK)]


def projection_window_candidates(proj_uv, proj_valid, radius, feat_uv,
                                 feat_valid) -> List[np.ndarray]:
    """The columns that csrc/hamming.cu visits for each row in one launch,
    in its order (feat_uv, feat_valid: that launch's chunk; the indices are
    the chunk's own). The index: a valid column with |u|, |v| < PROJ_LIMIT
    lies in cell (floor(u / PROJ_CELL), floor(v / PROJ_CELL)), the others
    (NaN and inf included) in an overflow list; the grid spans the valid
    columns' cells from the least to the largest key, gx across (at most
    PROJ_MAX_CELLS) and at most PROJ_MAX_CELLS // gx down; cells beyond go
    to the overflow list; cells are stored row-major. A valid row visits
    the overflow list, then for each cell row of floor((v - |r|) / 16) - 1 ..
    floor((v + |r|) / 16) + 1 the cells floor((u - |r|) / 16) - 1 ..
    floor((u + |r|) / 16) + 1 (float32 arithmetic); every indexed column, in
    index order, when one of those four ends is not finite or not below
    PROJ_LIMIT or the square covers more cells than the index holds
    columns. Within a cell the kernel's atomics leave any order: here the
    columns come in descending order, the one that a first-seen tie rule
    would get wrong. An invalid row visits nothing."""
    f32 = np.float32
    n = proj_uv.shape[0]
    pu, pv = (proj_uv[:, k].cpu().numpy() for k in (0, 1))
    r = _row_radius(radius, n, proj_uv.device).to(torch.float32).cpu().numpy()
    fu, fv = (feat_uv[:, k].cpu().numpy() for k in (0, 1))
    lim, inv = f32(PROJ_LIMIT), f32(1.0 / PROJ_CELL)
    cols = np.flatnonzero(feat_valid.cpu().numpy())
    with np.errstate(invalid="ignore"):
        inrange = (np.abs(fu[cols]) < lim) & (np.abs(fv[cols]) < lim)
    kx = np.floor(fu[cols][inrange] * inv).astype(np.int64)
    ky = np.floor(fv[cols][inrange] * inv).astype(np.int64)
    gx = gy = xlo = ylo = 0
    if kx.size:
        xlo, ylo = int(kx.min()), int(ky.min())
        gx = min(int(kx.max()) - xlo + 1, PROJ_MAX_CELLS)
        gy = min(int(ky.max()) - ylo + 1, PROJ_MAX_CELLS // gx)
    cells = gx * gy
    bucket = np.zeros(cols.size, dtype=np.int64)
    cx, cy = kx - xlo, ky - ylo
    bucket[inrange] = np.where((cx < gx) & (cy < gy), 1 + cy * gx + cx, 0)
    order = np.lexsort((-cols, bucket))            # by bucket, descending columns
    sorted_cols, sorted_b = cols[order], bucket[order]
    start = np.searchsorted(sorted_b, np.arange(cells + 2))   # bucket b: [start[b], start[b+1])
    out = []
    for i, valid in enumerate(proj_valid.cpu().numpy()):
        if not valid:
            out.append(np.zeros(0, dtype=np.int64))
            continue
        ar = np.abs(f32(r[i]))
        with np.errstate(invalid="ignore", over="ignore"):
            ends = (pu[i] - ar, pu[i] + ar, pv[i] - ar, pv[i] + ar)   # float32
            walk_all = not all(abs(e) < lim for e in ends)
        cx0, cx1, cy0, cy1 = 0, -1, 0, -1
        if not walk_all and cells > 0:
            cx0 = max(0, int(np.floor(ends[0] * inv)) - 1 - xlo)
            cx1 = min(gx - 1, int(np.floor(ends[1] * inv)) + 1 - xlo)
            cy0 = max(0, int(np.floor(ends[2] * inv)) - 1 - ylo)
            cy1 = min(gy - 1, int(np.floor(ends[3] * inv)) + 1 - ylo)
            if cx0 <= cx1 and cy0 <= cy1 and (cx1 - cx0 + 1) * (cy1 - cy0 + 1) > cols.size:
                walk_all = True
        if walk_all:
            out.append(sorted_cols)
            continue
        segs = [sorted_cols[:start[1]]]
        if cx0 <= cx1:
            segs += [sorted_cols[start[1 + y * gx + cx0]:start[1 + y * gx + cx1 + 1]]
                     for y in range(cy0, cy1 + 1)]
        out.append(np.concatenate(segs))
    return out


def hamming_best_two_projection_gridded_ref(mp_desc, proj_uv, proj_valid, radius,
                                            pred_level, feat_desc, feat_uv, feat_valid,
                                            feat_level, level_slack: int):
    """CPU model of csrc/hamming.cu: for each chunk of projection_chunks,
    each row visits the columns of ``projection_window_candidates`` in
    that order, applies the plain version's level test and exact float32
    radius test ((du*du) + (dv*dv) <= r*r, each operation rounded) and keeps
    (best, idx, second) ordered by (distance, column), as the kernel's
    lanes do; then it merges them into the row's result so far by
    stat_merge, as a seeded launch does. The chunks come last first.
    Equal to hamming_best_two_projection_ref wherever the visit holds every
    pair that passes, which is what the spare cells, the overflow list and
    the full walk ensure."""
    f32 = np.float32
    n = mp_desc.shape[0]
    pu, pv = (proj_uv[:, k].cpu().numpy() for k in (0, 1))
    r = _row_radius(radius, n, proj_uv.device).to(torch.float32).cpu().numpy()
    fu, fv = (feat_uv[:, k].cpu().numpy() for k in (0, 1))
    lv_r, lv_c = pred_level.cpu().numpy(), feat_level.cpu().numpy()
    dR = mp_desc.cpu().numpy().view(np.uint32)
    dC = feat_desc.cpu().numpy().view(np.uint32)
    idx = np.zeros(n, dtype=np.int64)
    best = np.full(n, BIG, dtype=np.int32)
    second = np.full(n, BIG, dtype=np.int32)
    for c0, c1 in projection_chunks(feat_desc.shape[0])[::-1]:
        cands = projection_window_candidates(proj_uv, proj_valid, radius, feat_uv[c0:c1],
                                             feat_valid[c0:c1])
        for i, c in enumerate(cands):
            c = c + c0
            with np.errstate(invalid="ignore", over="ignore"):
                du, dv = pu[i] - fu[c], pv[i] - fv[c]
                ok = ((np.abs(lv_c[c] - lv_r[i]) <= level_slack)
                      & ((du * du) + (dv * dv) <= f32(r[i]) * f32(r[i])))
            b, j0, s = BIG, 0, BIG
            for j in c[ok]:
                d = int(np.bitwise_count(dR[i] ^ dC[j]).sum())
                if d < b or (d == b and j < j0):
                    b, j0, s = d, int(j), b
                else:
                    s = min(s, d)
            best[i], idx[i], second[i] = stat_merge(
                (int(best[i]), int(idx[i]), int(second[i])), (b, j0, s))
    dev = mp_desc.device
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(best).to(dev),
            torch.from_numpy(second).to(dev))


def hamming_best_two_projection(mp_desc: torch.Tensor, proj_uv: torch.Tensor,
                                proj_valid: torch.Tensor, radius,
                                pred_level: torch.Tensor, feat_desc: torch.Tensor,
                                feat_uv: torch.Tensor, feat_valid: torch.Tensor,
                                feat_level: torch.Tensor, level_slack: int):
    """Hamming match of N projected map points (rows) against M features
    (columns) under the mask: both valid, the feature within `radius` px
    of the projection ((N,) float32 tensor, 0-d tensor or float; float32
    arithmetic, (dx*dx) + (dy*dy) <= r*r) and |feat_level - pred_level| <=
    level_slack. Returns per row (idx int64, best int32, second int32) as
    hamming_best_two_valid does.

    CPU: plain version; CUDA: the grid-indexed window search
    (csrc/hamming.cu), which indexes the columns by 16-px cell in shared
    memory and tests only the columns of the cells around a row's window:
    one launch for M <= PROJ_CHUNK, else one a chunk of projection_chunks(M)
    in column order, each after the first merging into the results of the
    ones before. No read-back: it runs inside the fused tracking step."""
    n, m = mp_desc.shape[0], feat_desc.shape[0]
    if n == 0 or m == 0:
        dev = mp_desc.device
        return (torch.zeros(n, dtype=torch.int64, device=dev),
                torch.full((n,), BIG, dtype=torch.int32, device=dev),
                torch.full((n,), BIG, dtype=torch.int32, device=dev))
    tensors = [mp_desc, proj_uv, proj_valid, pred_level, feat_desc, feat_uv,
               feat_valid, feat_level]
    if isinstance(radius, torch.Tensor):
        tensors.append(radius)
    if _all_cpu(*tensors):
        return hamming_best_two_projection_ref(
            mp_desc, proj_uv, proj_valid, radius, pred_level, feat_desc,
            feat_uv, feat_valid, feat_level, level_slack)
    name = "hamming_best_two_projection"
    if isinstance(radius, torch.Tensor):
        radius = radius.expand(n).contiguous()
        _check_cuda(name, radius, torch.float32, (n,))
        radius_ptr, radius_scalar = radius.data_ptr(), 0.0
    else:
        radius_ptr, radius_scalar = None, float(radius)
    _check_cuda(name, mp_desc, torch.int32, (n, 8))
    _check_cuda(name, proj_uv, torch.float32, (n, 2))
    _check_cuda(name, proj_valid, torch.bool, (n,))
    _check_cuda(name, pred_level, torch.int32, (n,))
    _check_cuda(name, feat_desc, torch.int32, (m, 8))
    _check_cuda(name, feat_uv, torch.float32, (m, 2))
    _check_cuda(name, feat_valid, torch.bool, (m,))
    _check_cuda(name, feat_level, torch.int32, (m,))
    mp_desc, feat_desc = _aligned16(mp_desc), _aligned16(feat_desc)
    feat_uv = _aligned16(feat_uv)
    dev = mp_desc.device
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty(n, dtype=torch.int32, device=dev)
    for c0, c1 in projection_chunks(m):
        _launch(name, mp_desc.data_ptr(), proj_uv.data_ptr(), proj_valid.data_ptr(),
                radius_ptr, radius_scalar, pred_level.data_ptr(), n,
                feat_desc.data_ptr(), feat_uv.data_ptr(), feat_valid.data_ptr(),
                feat_level.data_ptr(), c1 - c0, c0, int(c0 > 0), int(level_slack),
                idx.data_ptr(), best.data_ptr(), second.data_ptr())
    return idx, best, second


STEREO_MIN_DISPARITY = 0.3
STEREO_LEVEL_SLACK = 1


# 1.2^level overflows float32 from level 487 on: the table's last entry
# is inf, as the float32 power is for every level above it
STEREO_TOL_LEVELS = 512


@functools.lru_cache(maxsize=8)
def _stereo_tol_table(row_tol: float, device: torch.device) -> torch.Tensor:
    """row_tol * 1.2^level for levels 0 .. STEREO_TOL_LEVELS - 1 in float32:
    the power taken in float64 on float32(1.2) and rounded once, which is
    what the JAX package's float32 ``power`` gives on every level, whatever
    the device's powf."""
    with np.errstate(over="ignore"):
        table = np.float32(row_tol) * (np.float64(np.float32(1.2))
                                       ** np.arange(STEREO_TOL_LEVELS)).astype(np.float32)
    return torch.from_numpy(table).to(device)


def stereo_row_tolerance(level: torch.Tensor, row_tol: float) -> torch.Tensor:
    """(N,) float32 epipolar row tolerance of left features at `level`
    (levels are not negative; any level above the table reads its last
    entry, the same inf)."""
    table = _stereo_tol_table(float(row_tol), level.device)
    return table[torch.clamp(level, 0, STEREO_TOL_LEVELS - 1).long()]


def hamming_best_two_stereo_ref(descL, uvL, validL, levelL, tol, descR, uvR,
                                validR, levelR, max_disparity: float):
    """Plain version of the stereo-masked fused match: the (N, M) epipolar
    row, disparity, level and validity mask, the matrix, then best_two."""
    f32 = dict(dtype=torch.float32, device=uvL.device)
    dv = torch.abs(uvL[:, None, 1] - uvR[None, :, 1])
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    lv_ok = torch.abs(levelL[:, None] - levelR[None, :]) <= STEREO_LEVEL_SLACK
    mask = ((dv <= tol[:, None])
            & (disp > torch.tensor(STEREO_MIN_DISPARITY, **f32))
            & (disp < torch.tensor(max_disparity, **f32))
            & lv_ok & validL[:, None] & validR[None, :])
    return best_two(torch.where(mask, hamming_matrix_ref(descL, descR), BIG))


def stereo_chunks(m: int) -> List[Tuple[int, int]]:
    """The column chunks of the stereo match's launches: STEREO_CHUNK
    columns each, the rest in the last. A launch's cost follows its
    compile-time slot count (csrc/stereo_band.cu: 2, 4 or 8 columns a
    thread by the chunk's width), so full chunks and a narrow rest beat even
    ones: 4,608 columns as 4,096 + 512, not 2 x 2,304."""
    return [(s, min(m, s + STEREO_CHUNK)) for s in range(0, m, STEREO_CHUNK)]


def stereo_band_candidates(uvL, validL, tol, uvR, validR) -> List[np.ndarray]:
    """The right columns that csrc/stereo_band.cu visits for each left row
    in one launch, in its order (uvR, validR: that launch's chunk; the
    indices are the chunk's own): valid columns keyed by floor(v) (|v| <
    2^20; others, NaN and inf included, in an overflow bucket), the buckets
    spanning the smallest to the largest key, at most STEREO_MAX_BUCKETS
    (keys beyond go to the overflow bucket); a row visits the overflow
    bucket, then the buckets of keys floor(vL - tol) - 1 .. floor(vL + tol)
    + 1 (every bucket when that band is not finite or not below 2^20).
    Within a bucket the kernel's atomics leave any order: here the columns
    come in descending order, the one that a first-seen tie rule would get
    wrong. An invalid left row visits nothing."""
    vL = uvL[:, 1].cpu().numpy()
    tolv = tol.cpu().numpy()
    vR = uvR[:, 1].cpu().numpy()
    vlim = np.float32(STEREO_V_LIMIT)
    cols = np.flatnonzero(validR.cpu().numpy())
    with np.errstate(invalid="ignore"):
        inrange = np.abs(vR[cols]) < vlim
    keys = np.floor(vR[cols][inrange]).astype(np.int64)
    base = int(keys.min()) if keys.size else 0
    nb = min(int(keys.max()) - base + 1, STEREO_MAX_BUCKETS) if keys.size else 0
    bucket = np.zeros(cols.size, dtype=np.int64)
    bucket[inrange] = np.where(keys - base < nb, 1 + keys - base, 0)
    order = np.lexsort((-cols, bucket))            # by bucket, descending columns
    sorted_cols, sorted_b = cols[order], bucket[order]
    start = np.searchsorted(sorted_b, np.arange(nb + 2))   # bucket b: [start[b], start[b+1])
    out = []
    for i, valid in enumerate(validL.cpu().numpy()):
        if not valid:
            out.append(np.zeros(0, dtype=np.int64))
            continue
        with np.errstate(invalid="ignore", over="ignore"):
            lo_v, hi_v = vL[i] - tolv[i], vL[i] + tolv[i]   # float32 arithmetic
            banded = abs(lo_v) < vlim and abs(hi_v) < vlim
        lo, hi = 1, nb
        if nb == 0:
            hi = 0
        elif banded:
            lo = max(1, int(np.floor(lo_v)) - base)
            hi = min(nb, int(np.floor(hi_v)) - base + 2)
        seg = sorted_cols[start[lo]:start[hi + 1]] if hi >= lo else sorted_cols[:0]
        out.append(np.concatenate([sorted_cols[:start[1]], seg]))
    return out


def stat_merge(a: Tuple[int, int, int], b: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Merge the (best, idx, second) of two disjoint column sets, as
    csrc/match_core.cuh's stat_merge does: the lower (distance, column)
    wins; the loser's best is one more candidate for second."""
    (b1, i1, s1), (b2, i2, s2) = a, b
    if (b2, i2) < (b1, i1):
        return b2, i2, min(s1, s2, b1)
    return b1, i1, min(s1, s2, b2)


def hamming_best_two_stereo_banded_ref(descL, uvL, validL, levelL, tol, descR, uvR,
                                       validR, levelR, max_disparity: float):
    """CPU model of csrc/stereo_band.cu: for each chunk of stereo_chunks,
    each left row visits the columns of ``stereo_band_candidates`` in that
    order, applies the exact float32 tests of the plain version and keeps
    (best, idx, second) ordered by (distance, column), as the kernel's
    lanes do; then it merges them into the row's result so far by
    stat_merge, as a seeded launch does. The kernel launches the chunks in
    column order; the merge does not depend on it, and here they come last
    first, the order that a merge keeping the first chunk's column on a tie
    would get wrong. Equal to hamming_best_two_stereo_ref wherever the band
    holds every unmasked pair, which is what the kernel's spare row on each
    side ensures."""
    f32 = np.float32
    uL, vL = (uvL[:, k].cpu().numpy() for k in (0, 1))
    uR, vR = (uvR[:, k].cpu().numpy() for k in (0, 1))
    lvL, lvR = levelL.cpu().numpy(), levelR.cpu().numpy()
    tolv = tol.cpu().numpy()
    dL = descL.cpu().numpy().view(np.uint32)
    dR = descR.cpu().numpy().view(np.uint32)
    n = descL.shape[0]
    idx = np.zeros(n, dtype=np.int64)
    best = np.full(n, BIG, dtype=np.int32)
    second = np.full(n, BIG, dtype=np.int32)
    for c0, c1 in stereo_chunks(descR.shape[0])[::-1]:
        cands = stereo_band_candidates(uvL, validL, tol, uvR[c0:c1], validR[c0:c1])
        for i, c in enumerate(cands):
            c = c + c0
            with np.errstate(invalid="ignore"):
                ok = ((np.abs(vL[i] - vR[c]) <= tolv[i])
                      & (uL[i] - uR[c] > f32(STEREO_MIN_DISPARITY))
                      & (uL[i] - uR[c] < f32(max_disparity))
                      & (np.abs(lvR[c] - lvL[i]) <= STEREO_LEVEL_SLACK))
            b, j0, s = BIG, 0, BIG
            for j in c[ok]:
                d = int(np.bitwise_count(dL[i] ^ dR[j]).sum())
                if d < b or (d == b and j < j0):
                    b, j0, s = d, int(j), b
                else:
                    s = min(s, d)
            best[i], idx[i], second[i] = stat_merge(
                (int(best[i]), int(idx[i]), int(second[i])), (b, j0, s))
    dev = descL.device
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(best).to(dev),
            torch.from_numpy(second).to(dev))


def hamming_best_two_stereo(descL: torch.Tensor, uvL: torch.Tensor,
                            validL: torch.Tensor, levelL: torch.Tensor,
                            tol: torch.Tensor, descR: torch.Tensor,
                            uvR: torch.Tensor, validR: torch.Tensor,
                            levelR: torch.Tensor, max_disparity: float):
    """Hamming match of N left features (rows) against M right features
    (columns) of a rectified stereo pair under the mask: both valid,
    |vL - vR| <= tol ((N,) float32, the row's epipolar tolerance),
    0.3 < uL - uR < max_disparity (float32 arithmetic) and
    |levelL - levelR| <= 1. Returns per row (idx int64, best int32, second
    int32) as hamming_best_two_valid does.

    CPU: plain version; CUDA: the row-band search (csrc/stereo_band.cu),
    which indexes the right set by image row in shared memory and tests
    only the pairs within a row's band: one launch for M <= STEREO_CHUNK,
    else one a chunk of stereo_chunks(M) in column order, each after the
    first merging into the results of the ones before."""
    n, m = descL.shape[0], descR.shape[0]
    if n == 0 or m == 0:
        dev = descL.device
        return (torch.zeros(n, dtype=torch.int64, device=dev),
                torch.full((n,), BIG, dtype=torch.int32, device=dev),
                torch.full((n,), BIG, dtype=torch.int32, device=dev))
    if _all_cpu(descL, uvL, validL, levelL, tol, descR, uvR, validR, levelR):
        return hamming_best_two_stereo_ref(descL, uvL, validL, levelL, tol,
                                           descR, uvR, validR, levelR,
                                           max_disparity)
    name = "hamming_best_two_stereo"
    _check_cuda(name, descL, torch.int32, (n, 8))
    _check_cuda(name, uvL, torch.float32, (n, 2))
    _check_cuda(name, validL, torch.bool, (n,))
    _check_cuda(name, levelL, torch.int32, (n,))
    _check_cuda(name, tol, torch.float32, (n,))
    _check_cuda(name, descR, torch.int32, (m, 8))
    _check_cuda(name, uvR, torch.float32, (m, 2))
    _check_cuda(name, validR, torch.bool, (m,))
    _check_cuda(name, levelR, torch.int32, (m,))
    descL, descR = _aligned16(descL), _aligned16(descR)
    uvL, uvR = _aligned16(uvL), _aligned16(uvR)
    dev = descL.device
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty(n, dtype=torch.int32, device=dev)
    for c0, c1 in stereo_chunks(m):
        _launch(name, descL.data_ptr(), uvL.data_ptr(), validL.data_ptr(),
                tol.data_ptr(), levelL.data_ptr(), n, descR.data_ptr(),
                uvR.data_ptr(), validR.data_ptr(), levelR.data_ptr(), c1 - c0, c0,
                int(c0 > 0), STEREO_MIN_DISPARITY, float(max_disparity),
                STEREO_LEVEL_SLACK, idx.data_ptr(), best.data_ptr(), second.data_ptr())
    return idx, best, second


# ----------------------------------------------------------------------
# The motion-only pose optimisation
# ----------------------------------------------------------------------

def pose_optimization(T_init: torch.Tensor, cam: torch.Tensor, p_world: torch.Tensor,
                      uv_obs: torch.Tensor, inv_sigma2: torch.Tensor, mask: torch.Tensor,
                      rounds: int, iters: int, chi2_th: float, u_r=None, bf: float = 0.0):
    """The whole of opt/pose_opt.py's pose_optimization for CUDA tensors,
    one launch of csrc/pose_opt.cu: T_init (4, 4) float32, cam (4,) float32
    (fx, fy, cx, cy), p_world (M, 3), uv_obs (M, 2), inv_sigma2 (M,) float32,
    mask (M,) bool, u_r None or (M,) float32 (stereo right-u, -1 monocular).
    Returns (pose (4, 4), inliers (M,) bool, n_inliers () int32, chi2 ()
    float32), device tensors: nothing is read back. Any M is one launch.
    It runs on p_world's card, whichever card is current: the checks and
    the launch's stream are that card's (each agent of the multi-card dry
    run keeps its tensors on a card of its own)."""
    name = "pose_optimization"
    m = p_world.shape[0]
    f32 = torch.float32
    dev = p_world.device
    with torch.cuda.device(dev):
        _check_cuda(name, T_init, f32, (4, 4))
        _check_cuda(name, cam, f32, (4,))
        _check_cuda(name, p_world, f32, (m, 3))
        _check_cuda(name, uv_obs, f32, (m, 2))
        _check_cuda(name, inv_sigma2, f32, (m,))
        _check_cuda(name, mask, torch.bool, (m,))
        if u_r is not None:
            _check_cuda(name, u_r, f32, (m,))
        if rounds < 0 or iters < 0:
            raise ValueError(f"{name}: rounds and iters must be >= 0, got {rounds} x {iters}")
        pose = torch.empty((4, 4), dtype=f32, device=dev)
        inliers = torch.empty(m, dtype=torch.bool, device=dev)
        n_inliers = torch.empty((), dtype=torch.int32, device=dev)
        chi2 = torch.empty((), dtype=f32, device=dev)
        _launch(name, T_init.data_ptr(), cam.data_ptr(), p_world.data_ptr(),
                uv_obs.data_ptr(), inv_sigma2.data_ptr(), mask.data_ptr(),
                None if u_r is None else u_r.data_ptr(), m, int(rounds), int(iters),
                float(chi2_th), float(bf), pose.data_ptr(), inliers.data_ptr(),
                n_inliers.data_ptr(), chi2.data_ptr())
    return pose, inliers, n_inliers, chi2


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return dict(_LAUNCHES)
