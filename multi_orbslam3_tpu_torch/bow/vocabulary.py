"""Binary vocabulary tree, flattened for batched device lookup (counterpart
of multi_orbslam3_tpu/bow/vocabulary.py).

Layout: per level l, a dense (k^l, k, 8) table of child centroids, as
int32 bit patterns of the JAX package's uint32 words (the port's
descriptor convention). Descriptor -> word is L rounds of gather +
popcount(xor) + argmin over all N descriptors at once.

The bundled artifacts ``orbvoc_synthetic_k10_L{4,5}.npz`` beside this
module are byte-identical copies of the JAX package's, read with numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from multi_orbslam3_tpu_torch.frontend.kernels import popcount32


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    levels: tuple          # of (k^l, k, 8) int32 centroid tables
    idf: torch.Tensor      # (n_words,) float32 inverse document frequency
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth

    @property
    def device(self) -> torch.device:
        return self.idf.device


def from_numpy(levels, idf, branching: int, depth: int, device="cpu") -> Vocabulary:
    """uint32 (or int32) level tables + idf -> a Vocabulary on `device`."""
    return Vocabulary(
        levels=tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(t).astype(np.uint32).view(np.int32))).to(device)
            for t in levels),
        idf=torch.from_numpy(np.asarray(idf, np.float32).copy()).to(device),
        branching=int(branching), depth=int(depth))


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    """(M, 8) uint32 -> (8,) uint32 bitwise majority vote."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)      # (M, 256)
    maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmeans_binary(descs: np.ndarray, k: int, rng: np.random.RandomState,
                   iters: int = 6) -> np.ndarray:
    """Binary k-means (Hamming metric, majority-vote centroids).
    descs: (M, 8) uint32 -> (k, 8) uint32 centers."""
    M = descs.shape[0]
    if M == 0:
        return rng.randint(0, 2 ** 32, (k, 8), dtype=np.uint32)
    sel = rng.choice(M, size=min(k, M), replace=False)
    centers = descs[sel].copy()
    if centers.shape[0] < k:
        pad = rng.randint(0, 2 ** 32, (k - centers.shape[0], 8), dtype=np.uint32)
        centers = np.concatenate([centers, pad])
    for _ in range(iters):
        d = _popcount_np(descs[:, None, :] ^ centers[None, :, :])  # (M, k)
        assign = d.argmin(axis=1)
        for j in range(k):
            mask = assign == j
            if mask.sum() > 0:
                centers[j] = _majority_centroid(descs[mask])
    return centers


def train_vocabulary(descriptors: np.ndarray, branching: int = 10,
                     depth: int = 4, seed: int = 0, max_train: int = 60000,
                     device="cpu") -> Vocabulary:
    """Hierarchical binary k-means over (M, 8) uint32 descriptors, the same
    numpy k-means as the JAX package (same draws, same tables); the idf
    histogram assigns words with this package's ``assign_words``."""
    rng = np.random.RandomState(seed)
    if descriptors.shape[0] > max_train:
        descriptors = descriptors[
            rng.choice(descriptors.shape[0], max_train, replace=False)]

    levels: List[np.ndarray] = []
    groups = [descriptors]
    for _ in range(depth):
        table = np.zeros((len(groups), branching, 8), np.uint32)
        next_groups: List[np.ndarray] = []
        for gi, g in enumerate(groups):
            centers = _kmeans_binary(g, branching, rng)
            table[gi] = centers
            if g.shape[0] > 0:
                d = _popcount_np(g[:, None, :] ^ centers[None, :, :])
                assign = d.argmin(axis=1)
            else:
                assign = np.zeros(0, np.int64)
            for j in range(branching):
                next_groups.append(g[assign == j])
        levels.append(table)
        groups = next_groups

    # idf from the training-word histogram (words never hit get the max)
    n_words = branching ** depth
    voc = from_numpy(levels, np.ones(n_words, np.float32), branching, depth,
                     device)
    desc_t = torch.from_numpy(descriptors.astype(np.uint32).view(np.int32)).to(device)
    words = assign_words(voc, desc_t, torch.ones(desc_t.shape[0], dtype=torch.bool,
                                                 device=device)).cpu().numpy()
    hist = np.bincount(words[words >= 0], minlength=n_words)
    n_docs = max(1, descriptors.shape[0])
    idf = np.log(n_docs / np.maximum(hist, 1)).astype(np.float32)
    return dataclasses.replace(voc, idf=torch.from_numpy(idf).to(device))


def load_vocabulary(path: str, device="cpu") -> Vocabulary:
    with np.load(path) as z:
        depth = int(z["depth"])
        return from_numpy([z[f"level{i}"] for i in range(depth)], z["idf"],
                          int(z["branching"]), depth, device)


def bundled_path(branching: int, depth: int) -> str:
    """Where the trained artifact for this shape lies, if one is bundled."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"orbvoc_synthetic_k{branching}_L{depth}.npz")


def default_vocabulary(branching: int = 10, depth: int = 4, seed: int = 7,
                       device="cpu") -> Vocabulary:
    """The bundled artifact for this shape when one exists; otherwise a
    tree trained on random bits (the JAX package's fallback, same seed)."""
    path = bundled_path(branching, depth)
    if os.path.exists(path):
        return load_vocabulary(path, device)
    rng = np.random.RandomState(seed)
    descs = rng.randint(0, 2 ** 32, (20000, 8), dtype=np.uint32)
    return train_vocabulary(descs, branching, depth, seed, device=device)


def assign_words(voc: Vocabulary, desc: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N,) int32 word ids (-1 for invalid slots).
    argmin keeps the first child on ties, as jnp.argmin does."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for lv in range(voc.depth):
        cand = voc.levels[lv][node]                          # (N, k, 8)
        d = torch.sum(popcount32(cand ^ desc[:, None, :]), dim=-1)
        node = node * voc.branching + torch.argmin(d, dim=-1)
    return torch.where(valid, node, -1).to(torch.int32)


def bow_vector(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """(N,) word ids -> (n_words,) L2-normalized tf-idf vector."""
    ok = words >= 0
    tf = torch.zeros(voc.n_words, dtype=torch.float32, device=words.device
                     ).index_add(0, torch.where(ok, words, 0).long(),
                                 ok.to(torch.float32))
    v = tf * voc.idf
    return v / (torch.linalg.norm(v) + 1e-8)
