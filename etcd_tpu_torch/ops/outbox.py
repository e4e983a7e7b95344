"""Per-node outbox: K message slots per destination with overflow-drop
(etcd_tpu/ops/outbox.py), and the deferred-emission accumulator.

A batch of N nodes holds Msg leaves [N, K, M(dest), C] (ent leaves
[N, K, M, E, C]) plus per-destination fill counts [N, M, C]. Over a fleet
the node axis is the sender, so the outbox is the [from, K, to, (E,) C]
delivery view the engine masks and compacts, with no copy. Under
``RaftConfig.deferred_emit`` the steady handlers record per-destination
intents in a ``PendingWire`` ([N, M, C] leaves, the forwarded entries
[N, M, E, C]) that the round turns into slots once, after its message loop.
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.types import ENT_FIELDS, Msg, Spec, TensorStruct, empty_msg


@dataclasses.dataclass
class PendingWire(TensorStruct):
    """Deferred-emission intents (etcd_tpu/ops/outbox.py PendingWire), last
    writer wins per destination: the MsgAppResp reply, the union of
    maybe_send_append destinations, and the proposal forward."""
    rep_any: torch.Tensor        # bool [N, M, C]
    rep_term: torch.Tensor       # i32 [N, M, C]
    rep_index: torch.Tensor
    rep_reject: torch.Tensor     # bool
    rep_hint: torch.Tensor
    rep_logterm: torch.Tensor
    send_dest: torch.Tensor      # bool [N, M, C]
    send_nonempty: torch.Tensor  # bool [N, M, C]
    fwd_any: torch.Tensor        # bool [N, M, C]
    fwd_len: torch.Tensor        # i32 [N, M, C]
    fwd_data: torch.Tensor       # i32 [N, M, E, C]
    fwd_type: torch.Tensor       # i32 [N, M, E, C]


def empty_pending(spec: Spec, shape, device) -> PendingWire:
    """No intents, for a batch (N, C)."""
    N, C = shape

    def z(dtype, *f):
        return torch.zeros((N, spec.M) + f + (C,), dtype=dtype, device=device)

    i, b = torch.int32, torch.bool
    return PendingWire(rep_any=z(b), rep_term=z(i), rep_index=z(i),
                       rep_reject=z(b), rep_hint=z(i), rep_logterm=z(i),
                       send_dest=z(b), send_nonempty=z(b), fwd_any=z(b),
                       fwd_len=z(i), fwd_data=z(i, spec.E), fwd_type=z(i, spec.E))


@dataclasses.dataclass
class Outbox(TensorStruct):
    msgs: Msg
    counts: torch.Tensor       # i32 [N, M, C]
    # highest commit index carried by any message sent to each destination
    # this round (0 = none); read by the coalesced end-of-round commit flush
    sent_commit: torch.Tensor  # i32 [N, M, C]
    # deferred-emission accumulator; None unless cfg.deferred_emit
    pend: PendingWire | None = None


def empty_outbox(spec: Spec, shape, device, deferred: bool = False) -> Outbox:
    """All-zero slots (``frm`` included) for a batch (N, C), with an empty
    PendingWire when ``deferred``."""
    N, C = shape
    K, M, E = spec.K, spec.M, spec.E

    def mk(name, x):
        f = (K, M, E) if name in ENT_FIELDS else (K, M)
        return torch.zeros((N,) + f + (C,), dtype=x.dtype, device=device)

    z = torch.zeros((N, M, C), dtype=torch.int32, device=device)
    return Outbox(msgs=empty_msg(spec, shape, device).map(mk), counts=z,
                  sent_commit=z.clone(),
                  pend=empty_pending(spec, shape, device) if deferred else None)


def make_msg(spec: Spec, like: torch.Tensor, **kw) -> Msg:
    """A per-node Msg over the batch of ``like`` [N, C] with the given
    fields, the rest defaulted. Values may be Python numbers or tensors
    broadcasting to [N, C] (ent fields [N, E, C])."""
    base = empty_msg(spec, like.shape, like.device)
    conv = {}
    for k, v in kw.items():
        ref = getattr(base, k)
        if isinstance(v, torch.Tensor):
            v = v.to(ref.dtype)
        else:   # a device fill, not a copy from the host (CUDA-graph safe)
            v = torch.full((), v, dtype=ref.dtype, device=like.device)
        conv[k] = v.expand(ref.shape)
    return base.replace(**conv)


def bcast(spec: Spec, m: Msg) -> Msg:
    """A per-node Msg as per-destination leaves [N, M, (E,) C] (views)."""
    def f(_, x):
        return x.unsqueeze(1).expand(x.shape[:1] + (spec.M,) + x.shape[1:])
    return m.map(f)


# fields every receiver reads for every message (process_message's
# term/lease/vote plumbing): always written
HEADER_FIELDS = ("type", "term", "frm", "context", "reject")


def emit(spec: Spec, ob: Outbox, to_mask, m: Msg, fields=None) -> Outbox:
    """Write per-destination message ``m`` (leaves [N, M, (E,) C]) into the
    next free slot of every destination in ``to_mask`` [N, M, C]; drop on
    overflow. ``fields``: the non-header fields the message type sets (the
    rest stay as the round's zeroed slots left them); None writes all."""
    K = spec.K
    slot_idx = ob.counts
    can = to_mask & (slot_idx < K)
    ks = torch.arange(K, dtype=torch.int32, device=slot_idx.device).view(1, K, 1, 1)
    sel = can.unsqueeze(1) & (ks == slot_idx.unsqueeze(1))   # [N, K, M, C]
    sel_e = sel.unsqueeze(3)

    names = Msg.names() if fields is None else \
        tuple(dict.fromkeys(HEADER_FIELDS + tuple(fields)))
    upd = {}
    for k in names:
        old = getattr(ob.msgs, k)
        s = sel_e if k in ENT_FIELDS else sel
        upd[k] = torch.where(s, getattr(m, k).unsqueeze(1), old)
    return ob.replace(msgs=ob.msgs.replace(**upd),
                      counts=ob.counts + can.to(torch.int32))


def record_sent_commit(ob: Outbox, mask, value) -> Outbox:
    """Destinations in ``mask`` just received commit information ``value``
    (each [N, C] for all destinations, or [N, M, C])."""
    if mask.dim() == 2:
        mask = mask.unsqueeze(1)
    if value.dim() == 2:
        value = value.unsqueeze(1)
    return ob.replace(sent_commit=torch.where(
        mask, torch.maximum(ob.sent_commit, value), ob.sent_commit))


def emit_one(spec: Spec, ob: Outbox, to, m: Msg, enable, fields=None) -> Outbox:
    """Emit a per-node Msg to one destination id ``to`` [N, C] where
    ``enable``."""
    ids = torch.arange(spec.M, dtype=torch.int32, device=to.device).view(1, -1, 1)
    to_mask = (ids == to.unsqueeze(1)) & enable.unsqueeze(1)
    return emit(spec, ob, to_mask, bcast(spec, m), fields)
