"""Collaborative client/server layer (counterpart of
multi_orbslam3_tpu/collab):

- ``codec``     — the mo3 wire codec (a copy of the JAX package's; its
  native half builds csrc/mo3_codec.cpp at first use into _build/);
- ``protocol``  — map-delta messages (a copy of the JAX package's);
- ``transport`` — in-process queues and TCP sockets (a copy);
- ``client``    — ``CollabClient``: a MonoSlam with an uplink outbox and a
  corrections inbox;
- ``server``    — ``CollabServer``: the shared arena, cross-agent place
  recognition, Sim3 merges, pose graph and time-sliced global BA,
  culling, and the vicinity downlink.

The payloads and the server checkpoint are byte-compatible with the JAX
package's: either side's messages and files load in the other.
"""

from multi_orbslam3_tpu_torch.collab.client import CollabClient
from multi_orbslam3_tpu_torch.collab.server import CollabServer
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport

__all__ = ["CollabClient", "CollabServer", "InProcessTransport"]
