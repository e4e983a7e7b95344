"""Fleet state and wire to and from numpy.

Maps the arrays of a JAX fleet or wire (taken to numpy leaf by leaf) onto
the port's tensors and back, keeping every dtype: bool, int16 and int32 as
they are, and the uint32 PRNG key as the int32 bit patterns the port stores
(utils/prng.py). With these, both packages start from the same state and
their results compare leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import Msg, TensorStruct


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.array(x)                      # a writable, contiguous copy
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x).to(device)


def node_state_from_numpy(leaves: dict, device) -> NodeState:
    """``leaves``: NodeState field name -> array, [M, ..., C] fleet layout."""
    return NodeState(**{k: _tensor(leaves[k], device) for k in NodeState.names()})


def msg_from_numpy(leaves: dict, device) -> Msg:
    """``leaves``: Msg field name -> array (any of the wire layouts)."""
    return Msg(**{k: _tensor(leaves[k], device) for k in Msg.names()})


def to_numpy(struct: TensorStruct) -> dict:
    """The inverse: field name -> numpy array, the PRNG key as uint32."""
    out = {}
    for k, v in struct.items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k == "rng_key" else a
    return out
