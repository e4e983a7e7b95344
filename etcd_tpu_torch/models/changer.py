"""Host-side validating config Changer — set semantics + invariants.

The device path applies conf changes unconditionally as mask algebra
(etcd_tpu/models/confchange.py) because the reference's raft core panics on
invalid post-commit changes (raft/raft.go:1623-1643): *validation happens at
proposal time*. This module is that proposal-time validator — a faithful
re-expression of ``confchange.Changer`` (raft/confchange/confchange.go:
EnterJoint:50, LeaveJoint:91, Simple:127, apply:150, makeVoter:178,
makeLearner:207, remove:231, initProgress:245, checkInvariants:276) over
Python sets, used by the server layer before encoding a change for the
device, and by the datadriven replay of confchange/testdata/*.txt.

Error strings match the reference so golden error cases replay verbatim.

The port's copy of etcd_tpu/models/changer.py, which it imports nothing of.
"""
from __future__ import annotations

import dataclasses

from etcd_tpu_torch.types import (
    CC_ADD_LEARNER,
    CC_ADD_NODE,
    CC_REMOVE_NODE,
    CC_UPDATE_NODE,
)


class ConfChangeError(ValueError):
    pass


@dataclasses.dataclass
class Config:
    """tracker.Config as id sets (ids are opaque ints; the device layer maps
    them to member slots)."""

    voters: set[int] = dataclasses.field(default_factory=set)        # incoming
    voters_outgoing: set[int] = dataclasses.field(default_factory=set)
    learners: set[int] = dataclasses.field(default_factory=set)
    learners_next: set[int] = dataclasses.field(default_factory=set)
    auto_leave: bool = False
    # ids with a Progress entry; IsLearner flags (the slice of ProgressMap
    # state that the invariants constrain)
    progress: set[int] = dataclasses.field(default_factory=set)
    progress_learner: set[int] = dataclasses.field(default_factory=set)

    @property
    def joint(self) -> bool:
        return len(self.voters_outgoing) > 0

    def clone(self) -> "Config":
        return Config(
            set(self.voters), set(self.voters_outgoing), set(self.learners),
            set(self.learners_next), self.auto_leave, set(self.progress),
            set(self.progress_learner),
        )


def check_invariants(cfg: Config) -> None:
    """confchange.go:276-334."""
    for ids in (cfg.voters | cfg.voters_outgoing, cfg.learners, cfg.learners_next):
        for id_ in ids:
            if id_ not in cfg.progress:
                raise ConfChangeError(f"no progress for {id_}")
    for id_ in cfg.learners_next:
        if id_ not in cfg.voters_outgoing:
            raise ConfChangeError(f"{id_} is in LearnersNext, but not Voters[1]")
        if id_ in cfg.progress_learner:
            raise ConfChangeError(
                f"{id_} is in LearnersNext, but is already marked as learner"
            )
    for id_ in cfg.learners:
        if id_ in cfg.voters_outgoing:
            raise ConfChangeError(f"{id_} is in Learners and Voters[1]")
        if id_ in cfg.voters:
            raise ConfChangeError(f"{id_} is in Learners and Voters[0]")
        if id_ not in cfg.progress_learner:
            raise ConfChangeError(
                f"{id_} is in Learners, but is not marked as learner"
            )
    if not cfg.joint:
        if cfg.learners_next:
            raise ConfChangeError("cfg.LearnersNext must be nil when not joint")
        if cfg.auto_leave:
            raise ConfChangeError("AutoLeave must be false when not joint")


class Changer:
    """Stateless validator: methods return a NEW validated Config or raise
    ConfChangeError (the caller swaps it in only after the entry commits)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg

    # -- public ops ---------------------------------------------------------
    def enter_joint(self, auto_leave: bool, ccs) -> Config:
        cfg = self._check_and_copy()
        if cfg.joint:
            raise ConfChangeError("config is already joint")
        if not cfg.voters:
            raise ConfChangeError("can't make a zero-voter config joint")
        cfg.voters_outgoing = set(cfg.voters)
        self._apply(cfg, ccs)
        cfg.auto_leave = auto_leave
        check_invariants(cfg)
        return cfg

    def leave_joint(self) -> Config:
        cfg = self._check_and_copy()
        if not cfg.joint:
            raise ConfChangeError("can't leave a non-joint config")
        for id_ in cfg.learners_next:
            cfg.learners.add(id_)
            cfg.progress_learner.add(id_)
        cfg.learners_next = set()
        for id_ in cfg.voters_outgoing:
            if id_ not in cfg.voters and id_ not in cfg.learners:
                cfg.progress.discard(id_)
                cfg.progress_learner.discard(id_)
        cfg.voters_outgoing = set()
        cfg.auto_leave = False
        check_invariants(cfg)
        return cfg

    def simple(self, ccs) -> Config:
        cfg = self._check_and_copy()
        if cfg.joint:
            raise ConfChangeError("can't apply simple config change in joint config")
        self._apply(cfg, ccs)
        if len(self.cfg.voters ^ cfg.voters) > 1:
            raise ConfChangeError(
                "more than one voter changed without entering joint config"
            )
        check_invariants(cfg)
        return cfg

    # -- internals ----------------------------------------------------------
    def _check_and_copy(self) -> Config:
        cfg = self.cfg.clone()
        check_invariants(cfg)
        return cfg

    def _apply(self, cfg: Config, ccs) -> None:
        for op, id_ in ccs:
            if id_ == 0:
                # zeroed changes are "refused upstream" markers (apply:155)
                continue
            if op == CC_ADD_NODE:
                self._make_voter(cfg, id_)
            elif op == CC_ADD_LEARNER:
                self._make_learner(cfg, id_)
            elif op == CC_REMOVE_NODE:
                self._remove(cfg, id_)
            elif op == CC_UPDATE_NODE:
                pass
            else:
                raise ConfChangeError(f"unexpected conf type {op}")
        if not cfg.voters:
            raise ConfChangeError("removed all voters")

    def _make_voter(self, cfg: Config, id_: int) -> None:
        if id_ not in cfg.progress:
            cfg.voters.add(id_)
            cfg.progress.add(id_)
            return
        cfg.progress_learner.discard(id_)
        cfg.learners.discard(id_)
        cfg.learners_next.discard(id_)
        cfg.voters.add(id_)

    def _make_learner(self, cfg: Config, id_: int) -> None:
        if id_ not in cfg.progress:
            cfg.learners.add(id_)
            cfg.progress.add(id_)
            cfg.progress_learner.add(id_)
            return
        if id_ in cfg.progress_learner:
            return
        self._remove(cfg, id_)
        cfg.progress.add(id_)  # ...but save the Progress (makeLearner:221)
        if id_ in cfg.voters_outgoing:
            cfg.learners_next.add(id_)
        else:
            cfg.progress_learner.add(id_)
            cfg.learners.add(id_)

    def _remove(self, cfg: Config, id_: int) -> None:
        if id_ not in cfg.progress:
            return
        cfg.voters.discard(id_)
        cfg.learners.discard(id_)
        cfg.learners_next.discard(id_)
        if id_ not in cfg.voters_outgoing:
            cfg.progress.discard(id_)
            cfg.progress_learner.discard(id_)


def restore(conf_state) -> Config:
    """confchange/restore.go:26-155 — rebuild a Config from a snapshot's
    ConfState by replaying synthesized single changes: first build the
    outgoing config as if it were the active one, then EnterJoint with the
    delta to the incoming one. conf_state: object with voters /
    voters_outgoing / learners / learners_next id-lists + auto_leave."""
    cs = conf_state
    out = [(CC_ADD_NODE, i) for i in cs.voters_outgoing]
    inc = (
        [(CC_REMOVE_NODE, i) for i in cs.voters_outgoing]
        + [(CC_ADD_NODE, i) for i in cs.voters]
        + [(CC_ADD_LEARNER, i) for i in cs.learners]
        + [(CC_ADD_LEARNER, i) for i in cs.learners_next]
    )
    cfg = Config()
    if not out:
        for cc in inc:
            cfg = Changer(cfg).simple([cc])
    else:
        for cc in out:
            cfg = Changer(cfg).simple([cc])
        cfg = Changer(cfg).enter_joint(cs.auto_leave, inc)
    return cfg
