"""Run-level knobs (counterparts of etcd_tpu/utils/config.py RaftConfig,
CrashConfig and MemberChaosConfig).

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


@dataclasses.dataclass(frozen=True)
class CrashConfig:
    """The chaos tier's crash-restart fault model (etcd_tpu/utils/config.py
    CrashConfig): ``down_rounds`` a crashed node stays down; ``durability``
    "stable" keeps the log up to the fsync floor (one round behind
    last_index), "none" is the deliberately broken model that keeps nothing
    past the snapshot."""

    down_rounds: int = 3
    durability: str = "stable"

    def __post_init__(self):
        if self.down_rounds < 1:
            raise ValueError("down_rounds must be >= 1")
        if self.durability not in ("stable", "none"):
            raise ValueError(
                f"unknown durability {self.durability!r}; "
                "known: ['none', 'stable']")


# the membership tier's palette names (harness/chaos.py member_palette)
MEMBER_MIXES = ("standard", "simple", "shrink")


@dataclasses.dataclass(frozen=True)
class MemberChaosConfig:
    """The chaos tier's membership-change fault model
    (etcd_tpu/utils/config.py MemberChaosConfig): the palette ``mix``,
    ``initial_voters`` (0 = every member boots a voter), and the crash
    boosts inside the snapshot-install and membership windows (1.0 = no
    targeting)."""

    mix: str = "standard"
    initial_voters: int = 0
    snap_crash_boost: float = 1.0
    member_crash_boost: float = 1.0

    def __post_init__(self):
        if self.mix not in MEMBER_MIXES:
            raise ValueError(
                f"unknown member mix {self.mix!r}; known: "
                f"{sorted(MEMBER_MIXES)}")
        if self.initial_voters == 1 or self.initial_voters < 0:
            raise ValueError("initial_voters must be 0 (= all) or >= 2")
        if self.snap_crash_boost < 1.0 or self.member_crash_boost < 1.0:
            raise ValueError("crash boosts must be >= 1.0 (1.0 = uniform)")
