"""Device -> host snapshots for the collaborative layer.

The client's uplink build and the server's downlink read a dozen map
fields at once. ``fetch`` enqueues every copy (into pinned memory on a
GPU, as the frame loop's ``_HostCopy`` does) before it waits, so a
snapshot costs one synchronisation, not one round trip a field. Descriptor words leave as uint32, the wire's type,
by a view of the int32 bit patterns (never a cast)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multi_orbslam3_tpu_torch.pipeline.system import _HostCopy

DESC_FIELDS = ("kf_desc", "mp_desc", "desc")


def fetch(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    copies = {name: _HostCopy(t) for name, t in tensors.items()}
    arrays = {}
    for name, c in copies.items():
        a = c.numpy()           # the first read waits; the rest are done
        if tensors[name].device.type == "cpu":
            a = a.copy()        # never a view of the map
        arrays[name] = a.view(np.uint32) if name in DESC_FIELDS else a
    return arrays


def desc_words(a: np.ndarray) -> torch.Tensor:
    """uint32 descriptor words from the wire -> int32 bit patterns (a
    view: the top bit survives as the sign)."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))
