"""Fleet state, wire, counters and the KV fleet to and from numpy.

Maps the arrays of a JAX fleet, packed fleet, wire, FleetMetrics, KVState or
WatchDelta (taken to numpy leaf by leaf) onto the port's tensors and back,
keeping every dtype: bool, int16 and int32 as they are, and the uint32
leaves (the PRNG key and the packed bit lanes) as the int32 bit patterns
the port stores. With these, both packages start from the same state and
their results compare leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from etcd_tpu_torch.device_mvcc.state import KVState
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import Msg, TensorStruct

# leaves the JAX package holds as uint32
UINT32_LEAVES = ("rng_key", "bits")


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.array(x)                      # a writable, contiguous copy
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x).to(device)


def from_numpy(cls, leaves: dict, device):
    """``leaves``: field name of ``cls`` (NodeState, Msg, PackedFleet,
    FleetMetrics, KVState, device_mvcc's WatchDelta) -> array."""
    return cls(**{k: _tensor(leaves[k], device) for k in cls.names()})


def node_state_from_numpy(leaves: dict, device) -> NodeState:
    """``leaves``: NodeState field name -> array, [M, ..., C] fleet layout."""
    return from_numpy(NodeState, leaves, device)


def msg_from_numpy(leaves: dict, device) -> Msg:
    """``leaves``: Msg field name -> array (any of the wire layouts)."""
    return from_numpy(Msg, leaves, device)


def kv_state_from_numpy(leaves: dict, device) -> KVState:
    """``leaves``: KVState field name -> array, [keys, C] and [C]."""
    return from_numpy(KVState, leaves, device)


def to_numpy(struct: TensorStruct) -> dict:
    """The inverse: field name -> numpy array, the uint32 leaves as uint32."""
    out = {}
    for k, v in struct.items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in UINT32_LEAVES else a
    return out
