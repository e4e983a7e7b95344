"""Run-level Raft knobs (counterpart of etcd_tpu/utils/config.py RaftConfig).

Every field and every ``__post_init__`` check of the JAX config, so a config
built for one package means the same in the other. The comments on each
field live in the JAX module.
"""
from __future__ import annotations

import dataclasses

from etcd_tpu_torch import types as _t


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    election_tick: int = 10
    heartbeat_tick: int = 1
    max_inflight: int = 4
    max_uncommitted: int = 0
    pre_vote: bool = False
    check_quorum: bool = False
    read_only_lease_based: bool = False
    disable_proposal_forwarding: bool = False
    local_steps: tuple = ("tick", "hup", "prop", "read_index")
    message_classes: tuple | None = None
    entry_classes: tuple | None = None
    inbox_bound: int = 0
    coalesce_commit_refresh: bool = False
    fleet_chunks: int = 1
    deferred_emit: bool = False
    packed_state: bool = False
    sparse_outbox: bool = False
    compact_wire: bool = False
    wire_int16: bool = False

    def __post_init__(self):
        if self.heartbeat_tick <= 0:
            raise ValueError("heartbeat tick must be greater than 0")
        if self.election_tick <= self.heartbeat_tick:
            raise ValueError("election tick must be greater than heartbeat tick")
        if self.read_only_lease_based and not self.check_quorum:
            raise ValueError("CheckQuorum must be enabled for lease-based reads")
        known = {"tick", "hup", "prop", "read_index"}
        bad = set(self.local_steps) - known
        if bad:
            raise ValueError(f"unknown local_steps {sorted(bad)}; known: "
                             f"{sorted(known)}")
        if "tick" in self.local_steps and "hup" not in self.local_steps:
            raise ValueError('local_steps with "tick" requires "hup" '
                             "(timeout campaigns ride the hup step)")
        if self.message_classes is not None:
            need = {"hup": _t.MSG_HUP, "prop": _t.MSG_PROP,
                    "read_index": _t.MSG_READ_INDEX}
            for step, mtype in need.items():
                if step in self.local_steps and mtype not in self.message_classes:
                    raise ValueError(
                        f'local step "{step}" is kept but its message type '
                        "is not in message_classes — its messages would be "
                        "silently swallowed"
                    )
        if self.entry_classes is not None:
            bad = set(self.entry_classes) - {"normal", "conf_change"}
            if bad:
                raise ValueError(
                    f"unknown entry_classes {sorted(bad)}; known: "
                    "['conf_change', 'normal']")
        if self.sparse_outbox:
            if not self.deferred_emit:
                raise ValueError("sparse_outbox requires deferred_emit "
                                 "(the scan-body handlers must record "
                                 "PendingWire intents, not emit)")
            steady = {_t.MSG_APP, _t.MSG_APP_RESP, _t.MSG_PROP}
            if self.message_classes is None or \
                    not set(self.message_classes) <= steady:
                raise ValueError(
                    "sparse_outbox requires message_classes ⊆ "
                    "{MSG_APP, MSG_APP_RESP, MSG_PROP} — other handler "
                    "classes emit inside the scan")
        if self.compact_wire and self.inbox_bound <= 0:
            raise ValueError("compact_wire stores the inbox in its "
                             "compacted form and needs inbox_bound > 0")
        if self.deferred_emit and not self.coalesce_commit_refresh:
            raise ValueError("deferred_emit requires "
                             "coalesce_commit_refresh")

    @property
    def max_uncommitted_entries(self) -> int:
        return self.max_uncommitted if self.max_uncommitted > 0 else (1 << 30)
