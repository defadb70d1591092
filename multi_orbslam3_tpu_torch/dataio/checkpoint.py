"""Map checkpoint / resume (counterpart of
multi_orbslam3_tpu/dataio/checkpoint.py).

MapState is a NamedTuple of arrays, so a checkpoint is one .npz file. The
keys (``map.<field>``, ``extra.<name>``) and dtypes are the JAX package's:
descriptors are uint32 words on disk and int32 bit patterns in the port, so
a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.map.mapstate import MapState


def save_map(path: str, m: MapState, extra: Optional[Dict] = None) -> None:
    arrays = {f"map.{name}": a for name, a in interop.map_to_numpy(m).items()}
    if extra:
        for k, v in extra.items():
            arrays[f"extra.{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cpu") -> tuple[MapState, Dict[str, np.ndarray]]:
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    k, n = data["map.kf_mp"].shape
    p = data["map.mp_pos"].shape[0]
    # fields that older checkpoints lack: a mono map, default cameras, no
    # landmark replacements recorded
    defaults = {"kf_ur": lambda: np.full((k, n), -1.0, np.float32),
                "kf_cam": lambda: np.zeros((k, 4), np.float32),
                "mp_redirect": lambda: np.full((p,), -1, np.int32)}
    fields = {}
    for name in MapState._fields:
        key = f"map.{name}"
        fields[name] = data[key] if key in data or name not in defaults \
            else defaults[name]()
    extra = {key[len("extra."):]: v for key, v in data.items()
             if key.startswith("extra.")}
    return interop.map_from_numpy(fields, device), extra
