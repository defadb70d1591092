"""Plain place-recognition scoring for the reference: descriptors to
vocabulary words by tree descent, the tf-idf vector of a query, and the
cosine score of every database keyframe, each keyframe's words worked out
again from its descriptors in the map. The vocabulary is read from its raw
.npz file. Imports nothing of the port."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from slambench.reference.frontend import popcount32

VOCABULARY_DIR = Path(__file__).resolve().parents[2] / "multi_orbslam3_tpu_torch" / "bow"


class Vocabulary:
    def __init__(self, branching: int, depth: int, device):
        with np.load(VOCABULARY_DIR / f"orbvoc_synthetic_k{branching}_L{depth}.npz") as z:
            self.depth = int(z["depth"])
            self.branching = int(z["branching"])
            self.levels = [torch.from_numpy(np.ascontiguousarray(
                z[f"level{i}"].astype(np.uint32).view(np.int32))).to(device)
                for i in range(self.depth)]
            self.idf = torch.from_numpy(z["idf"].astype(np.float32)).to(device)
        self.n_words = self.branching ** self.depth

    def words(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(N, 8) descriptor words -> (N,) word ids (-1 invalid); the first
        child on ties."""
        node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
        for lv in range(self.depth):
            cand = self.levels[lv][node]
            d = torch.sum(popcount32(cand ^ desc[:, None, :]), dim=-1)
            node = node * self.branching + torch.argmin(d, dim=-1)
        return torch.where(valid, node, -1)

    def tfidf(self, words: torch.Tensor) -> torch.Tensor:
        """(B, N) word lists -> (B, n_words) tf-idf rows, not normalized."""
        ok = words >= 0
        tf = torch.zeros((words.shape[0], self.n_words), dtype=torch.float32,
                         device=words.device).scatter_add(
            1, torch.where(ok, words, 0), ok.to(torch.float32))
        return tf * self.idf


def scores(voc: Vocabulary, q_desc, q_valid, kf_desc, kf_valid, rows: torch.Tensor,
           block: int = 64) -> torch.Tensor:
    """Cosine similarity of the query's tf-idf vector with each keyframe
    row in `rows` (indices into kf_desc), in blocks of rows."""
    q = voc.tfidf(voc.words(q_desc, q_valid)[None])[0]
    q = q / (torch.linalg.norm(q) + 1e-8)
    out = []
    for r0 in range(0, rows.shape[0], block):
        r = rows[r0:r0 + block]
        B, N = r.shape[0], kf_desc.shape[1]
        w = voc.words(kf_desc[r].reshape(B * N, 8), kf_valid[r].reshape(-1)).reshape(B, N)
        v = voc.tfidf(w)
        out.append((v @ q) / (torch.linalg.norm(v, dim=1) + 1e-8))
    return torch.cat(out) if out else torch.zeros(0, device=q.device)
