"""Keyframe database: place-recognition queries as gather + row reduce
(counterpart of multi_orbslam3_tpu/bow/database.py).

Storage is sparse per keyframe: the word id of each feature plus the
row's tf-idf norm, O(max_kf x n_feat) whatever the vocabulary size. A
query scores every row at once:

    score_k = sum_f q[word(k, f)] * idf[word(k, f)] / norm_k

Every update returns a new database and leaves its input untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.bow.vocabulary import (
    Vocabulary, assign_words, bow_vector)
from multi_orbslam3_tpu_torch.map.mapstate import as_index, scatter_rows


class KeyframeDatabase(NamedTuple):
    word: torch.Tensor     # (max_kf, n_feat) int32 word id per feature (-1 pad)
    norm: torch.Tensor     # (max_kf,) float32 ||tf-idf row|| (1 where empty)
    active: torch.Tensor   # (max_kf,) bool
    agent: torch.Tensor    # (max_kf,) int32 owning agent of each row

    @classmethod
    def empty(cls, max_kf: int, device=None) -> "KeyframeDatabase":
        """No rows; the word table is sized at the first insert. device
        None is the CUDA device (``devices.resolve``)."""
        device = devices.resolve(device, "KeyframeDatabase.empty")
        return cls(word=torch.full((max_kf, 0), -1, dtype=torch.int32, device=device),
                   norm=torch.ones(max_kf, dtype=torch.float32, device=device),
                   active=torch.zeros(max_kf, dtype=torch.bool, device=device),
                   agent=torch.zeros(max_kf, dtype=torch.int32, device=device))


def _ensure_width(db: KeyframeDatabase, n_feat: int) -> KeyframeDatabase:
    if db.word.shape[1] == n_feat:
        return db
    word = torch.full((db.word.shape[0], n_feat), -1, dtype=torch.int32,
                      device=db.word.device)
    w = min(n_feat, db.word.shape[1])
    word[:, :w] = db.word[:, :w]            # fresh tensor: in place is safe
    return db._replace(word=word)


def _row_norm(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """(B, N) word lists -> (B,) ||tf-idf vector|| of each."""
    ok = words >= 0
    tf = torch.zeros((words.shape[0], voc.n_words), dtype=torch.float32,
                     device=words.device).scatter_add(
        1, torch.where(ok, words, 0).long(), ok.to(torch.float32))
    return torch.linalg.norm(tf * voc.idf, dim=-1) + 1e-8


def _add_rows(db: KeyframeDatabase, voc: Vocabulary, slots: torch.Tensor,
              desc: torch.Tensor, valid: torch.Tensor,
              agents: torch.Tensor) -> tuple[KeyframeDatabase, torch.Tensor]:
    B, N = valid.shape
    words = assign_words(voc, desc.reshape(B * N, 8),
                         valid.reshape(-1)).reshape(B, N)
    ok = slots >= 0
    return KeyframeDatabase(
        word=scatter_rows(db.word, slots, ok, words),
        norm=scatter_rows(db.norm, slots, ok, _row_norm(voc, words)),
        active=scatter_rows(db.active, slots, ok, True),
        agent=scatter_rows(db.agent, slots, ok, agents)), words


def add_keyframe_bow(db: KeyframeDatabase, voc: Vocabulary, slot,
                     desc: torch.Tensor, valid: torch.Tensor, agent=0):
    """Insert/overwrite row `slot` (an int or a 0-d tensor) with a
    keyframe's word list. Returns (db, words (N,))."""
    db = _ensure_width(db, desc.shape[0])
    dev = db.word.device
    agents = (agent.to(dev, torch.int32) if isinstance(agent, torch.Tensor)
              else torch.full((), int(agent), dtype=torch.int32, device=dev))
    db, words = _add_rows(db, voc, as_index(slot, dev).reshape(1), desc,
                          valid[None], agents.reshape(1))
    return db, words[0]


def add_keyframes_bow_batch(db: KeyframeDatabase, voc: Vocabulary,
                            slots: torch.Tensor, desc: torch.Tensor,
                            valid: torch.Tensor,
                            agents: torch.Tensor) -> KeyframeDatabase:
    """Batched row insert: slots (B,) with -1 for padding rows; desc
    (B, N, 8); valid (B, N)."""
    db = _ensure_width(db, desc.shape[1])
    return _add_rows(db, voc, slots, desc, valid, agents)[0]


def erase_keyframe_bow(db: KeyframeDatabase, slot) -> KeyframeDatabase:
    idx = as_index(slot, db.word.device).reshape(1)
    one = torch.ones(1, dtype=torch.bool, device=db.word.device)
    return db._replace(word=scatter_rows(db.word, idx, one, -1),
                       norm=scatter_rows(db.norm, idx, one, 1.0),
                       active=scatter_rows(db.active, idx, one, False))


def _score_rows(db: KeyframeDatabase, voc: Vocabulary, q: torch.Tensor,
                exclude: torch.Tensor) -> torch.Tensor:
    ok = db.word >= 0
    w = torch.where(ok, db.word, 0).long()
    contrib = torch.where(ok, q[w] * voc.idf[w], 0.0)
    scores = torch.sum(contrib, dim=1) / db.norm
    return torch.where(db.active & ~exclude, scores, 0.0)


def query(db: KeyframeDatabase, voc: Vocabulary, desc: torch.Tensor,
          valid: torch.Tensor, exclude: torch.Tensor) -> torch.Tensor:
    """Score every row against a frame's descriptors; exclude (max_kf,)
    bool suppresses rows. Returns (max_kf,) float32 cosine similarities
    (0 where inactive or excluded)."""
    return _score_rows(db, voc, bow_vector(voc, assign_words(voc, desc, valid)),
                       exclude)


def query_vector(db: KeyframeDatabase, voc: Vocabulary, v: torch.Tensor,
                 exclude: torch.Tensor) -> torch.Tensor:
    """`query` with a precomputed dense tf-idf vector. The argument order
    is the JAX package's; a caller that leaves `voc` out gets a TypeError
    here instead of a failure deep inside the gather."""
    if not isinstance(voc, Vocabulary):
        raise TypeError("query_vector(db, voc, v, exclude): voc must be a "
                        f"Vocabulary, got {type(voc).__name__}")
    return _score_rows(db, voc, v, exclude)
