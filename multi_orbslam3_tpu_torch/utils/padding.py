"""Fixed-shape padding helpers for variable-length device updates.

Everything under jit specializes on array SHAPES: a scatter/gather whose
index vector length follows the data (N corrected keyframes this cycle,
M moved landmarks, ...) compiles a fresh XLA program per distinct length.
On the comm path those lengths change every cycle, so an unpadded design
recompiles continuously — the dominant wall-clock cost of the
collaborative bench on a cold-cache machine.

`pad_pow2` buckets lengths to powers of two (at most log2(cap) program
variants per call site). Scatter padding repeats the first index with its
own value — a duplicate `.at[i].set(v)` write of the same value is
idempotent, so the padded rows are harmless.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pow2_len(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def pad_pow2(ids: np.ndarray, *values: np.ndarray, lo: int = 8
             ) -> Tuple[np.ndarray, ...]:
    """Pad an index vector (and its aligned value arrays) to a pow2
    length by repeating row 0. Safe for `.at[ids].set(vals)` scatters
    (duplicate index, duplicate value) and for gathers whose padded rows
    are discarded by the caller."""
    ids = np.asarray(ids)
    n = ids.shape[0]
    m = pow2_len(n, lo)
    if m == n:
        return (ids, *values)
    reps = m - n
    out_ids = np.concatenate([ids, np.repeat(ids[:1], reps, axis=0)])
    out_vals = tuple(
        np.concatenate([v, np.repeat(v[:1], reps, axis=0)])
        for v in values)
    return (out_ids, *out_vals)
