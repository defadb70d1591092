"""Numpy in and out of the port's MapState, FrameFeatures, Vocabulary,
KeyframeDatabase and Sim3.

The arrays are keyed by the JAX package's field names, so state built by
one package can be carried to the other. uint32 descriptor and centroid
words become int32 bit patterns (``.view(np.int32)``) on the way in and
uint32 again on the way out. Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multi_orbslam3_tpu_torch.bow import vocabulary as vocm
from multi_orbslam3_tpu_torch.bow.database import KeyframeDatabase
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.geometry.sim3 import Sim3
from multi_orbslam3_tpu_torch.map.mapstate import MapState

_DESC_FIELDS = ("kf_desc", "mp_desc", "desc")


def _to_torch(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _DESC_FIELDS:
        a = a.astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _DESC_FIELDS else a


def map_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> MapState:
    return MapState(**{f: _to_torch(f, d[f], device) for f in MapState._fields})


def map_to_numpy(m: MapState) -> Dict[str, np.ndarray]:
    return {f: _to_numpy(f, getattr(m, f)) for f in MapState._fields}


def features_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> FrameFeatures:
    return FrameFeatures(**{f: _to_torch(f, d[f], device)
                            for f in FrameFeatures._fields})


def features_to_numpy(f: FrameFeatures) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(k, getattr(f, k)) for k in FrameFeatures._fields}


def vocabulary_from_numpy(levels, idf, branching: int, depth: int,
                          device="cpu") -> vocm.Vocabulary:
    """The JAX Vocabulary's arrays (uint32 level tables, float32 idf), as
    np.asarray of its fields or the arrays of a saved .npz."""
    return vocm.from_numpy(levels, idf, branching, depth, device)


def database_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> KeyframeDatabase:
    return KeyframeDatabase(**{f: _to_torch(f, d[f], device)
                               for f in KeyframeDatabase._fields})


def database_to_numpy(db: KeyframeDatabase) -> Dict[str, np.ndarray]:
    return {f: _to_numpy(f, getattr(db, f)) for f in KeyframeDatabase._fields}


def sim3_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> Sim3:
    return Sim3(**{f: _to_torch(f, d[f], device) for f in Sim3._fields})


def sim3_to_numpy(S: Sim3) -> Dict[str, np.ndarray]:
    return {f: _to_numpy(f, getattr(S, f)) for f in Sim3._fields}
