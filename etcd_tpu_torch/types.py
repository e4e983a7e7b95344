"""Core wire/state types of the PyTorch port (counterpart of etcd_tpu/types.py).

Same constants and the same 17-leaf message struct as the JAX package, as
plain dataclasses of tensors. Fleet layout is clusters-minor: a message
batched over nodes has scalar leaves ``[N, C]`` (N nodes of a member axis,
C clusters) and ``ent_*`` leaves ``[N, E, C]``; wider batches insert their
extra axes between the node axis and the trailing cluster axis.
"""
from __future__ import annotations

import dataclasses

import torch

NONE_ID = -1
INT32_MAX = 2**31 - 1

ROLE_FOLLOWER = 0
ROLE_PRE_CANDIDATE = 1
ROLE_CANDIDATE = 2
ROLE_LEADER = 3

MSG_NONE = 0
MSG_APP = 1
MSG_APP_RESP = 2
MSG_VOTE = 3
MSG_VOTE_RESP = 4
MSG_SNAP = 5
MSG_HEARTBEAT = 6
MSG_HEARTBEAT_RESP = 7
MSG_PRE_VOTE = 8
MSG_PRE_VOTE_RESP = 9
MSG_TRANSFER_LEADER = 10
MSG_TIMEOUT_NOW = 11
MSG_READ_INDEX = 12
MSG_READ_INDEX_RESP = 13
MSG_PROP = 14
MSG_UNREACHABLE = 15
MSG_SNAP_STATUS = 16
MSG_HUP = 17
NUM_MSG_TYPES = 18

ENTRY_NORMAL = 0
ENTRY_CONF_CHANGE = 1
ENTRY_CONF_CHANGE_V2 = 2

VOTE_PENDING = 0
VOTE_WON = 1
VOTE_LOST = 2

PR_PROBE = 0
PR_REPLICATE = 1
PR_SNAPSHOT = 2

CAMPAIGN_NONE = 0
CAMPAIGN_TRANSFER = 1
CAMPAIGN_FORCE = 2

# conf-change ops, encoded into a conf-change entry's data word
# (models/confchange.py; raft.proto ConfChangeType)
CC_ADD_NODE = 0
CC_REMOVE_NODE = 1
CC_UPDATE_NODE = 2
CC_ADD_LEARNER = 3

# int16-wire exemptions: (field, message type) pairs whose values may
# exceed int16 because the receiver rebuilds them from a split
# (engine.wire_overflow_count): MsgSnap's commit carries the 32-bit applied
# hash, its high half riding reject_hint
WIRE_SPLIT = {("commit", MSG_SNAP)}


@dataclasses.dataclass(frozen=True)
class Spec:
    """Static shape parameters (same fields and checks as the JAX Spec)."""

    M: int = 5        # members per cluster
    L: int = 64       # log ring capacity
    E: int = 4        # max entries carried by one MsgApp
    K: int = 4        # message slots per (sender, receiver) pair per round
    W: int = 4        # inflight window ring size
    R: int = 4        # read-only request queue depth
    A: int = 8        # max committed entries applied per node per round

    def __post_init__(self):
        if self.E > self.L:
            raise ValueError(f"Spec.E ({self.E}) must be <= Spec.L ({self.L})")
        if self.M > 31:
            raise ValueError("Spec.M must fit the 5-bit conf-change id field")


class TensorStruct:
    """Base of the port's tensor containers: a dataclass whose fields are
    tensors, with the functional ``replace`` the JAX pytrees have."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def names(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls))

    def items(self):
        return ((k, getattr(self, k)) for k in self.names())

    def map(self, fn):
        """A new struct of the same type with ``fn(name, leaf)`` leaves."""
        return type(self)(**{k: fn(k, v) for k, v in self.items()})


@dataclasses.dataclass
class Msg(TensorStruct):
    """One message slot per batch element (fields as in etcd_tpu.types.Msg)."""

    type: torch.Tensor
    term: torch.Tensor
    frm: torch.Tensor
    index: torch.Tensor
    log_term: torch.Tensor
    commit: torch.Tensor
    reject: torch.Tensor      # bool
    reject_hint: torch.Tensor
    context: torch.Tensor
    ent_len: torch.Tensor
    ent_term: torch.Tensor    # [.., E, C]
    ent_data: torch.Tensor    # [.., E, C]
    ent_type: torch.Tensor    # [.., E, C]
    c_voters: torch.Tensor
    c_voters_out: torch.Tensor
    c_learners: torch.Tensor
    c_learners_next: torch.Tensor


ENT_FIELDS = ("ent_term", "ent_data", "ent_type")


def empty_msg(spec: Spec, shape, device) -> Msg:
    """Default message over a batch ``shape`` = (N, C): every field 0 except
    ``frm = NONE_ID``. Leaves are broadcast views (no memory per element);
    ent leaves are [N, E, C]."""
    n, c = shape

    def const(v, dtype, ent=False):
        t = torch.full((), v, dtype=dtype, device=device)
        return t.expand((n, spec.E, c) if ent else (n, c))

    z = torch.int32
    return Msg(
        type=const(0, z), term=const(0, z), frm=const(NONE_ID, z),
        index=const(0, z), log_term=const(0, z), commit=const(0, z),
        reject=const(False, torch.bool), reject_hint=const(0, z),
        context=const(0, z), ent_len=const(0, z),
        ent_term=const(0, z, True), ent_data=const(0, z, True),
        ent_type=const(0, z, True),
        c_voters=const(0, z), c_voters_out=const(0, z),
        c_learners=const(0, z), c_learners_next=const(0, z),
    )


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wraparound (the int32
    overflow the JAX package relies on, made explicit)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[N, M, C] -> i32[N, C] bitmask (bit m set iff mask[:, m])."""
    m = mask.shape[1]
    bits = torch.arange(m, dtype=torch.int32, device=mask.device)
    shape = (1, m) + (1,) * (mask.dim() - 2)
    return (mask.to(torch.int32) << bits.view(shape)).sum(1, dtype=torch.int32)


def unpack_mask(packed: torch.Tensor, m: int) -> torch.Tensor:
    """i32[N, C] bitmask -> bool[N, M, C]."""
    bits = torch.arange(m, dtype=torch.int32, device=packed.device)
    shape = (1, m) + (1,) * (packed.dim() - 1)
    return ((packed.unsqueeze(1) >> bits.view(shape)) & 1).to(torch.bool)
