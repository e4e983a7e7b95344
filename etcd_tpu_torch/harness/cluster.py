"""rafttest-style host driver over the batched engine
(etcd_tpu/harness/cluster.py ``Cluster``).

The reference's synchronous fake network (``type network`` in
raft/raft_test.go:4633-4748: send to quiescence, drop, cut, isolate,
recover) and the rafttest InteractionEnv verbs (campaign, propose,
stabilize). All C clusters advance in lockstep; the per-link fault state is
the engine's keep-mask. Layout: every state leaf is [M, feature..., C], the
inbox leaves [from, K*to(*E), C], the keep-mask [from, to, C]; accessors
take (m, c). ``telemetry=True`` and ``blackbox=True`` step the telemetry
plane (models/telemetry.py) and the black-box event ring
(models/blackbox.py) beside each round; both only read the state.
"""
from __future__ import annotations

import numpy as np
import torch

from etcd_tpu_torch.models.blackbox import (
    blackbox_update,
    init_blackbox,
    msg_activity,
    snapshot_pre,
)
from etcd_tpu_torch.models.engine import RaftEngine
from etcd_tpu_torch.models.telemetry import init_telemetry, telemetry_report, telemetry_update
from etcd_tpu_torch.types import (
    ENT_FIELDS,
    ENTRY_CONF_CHANGE,
    ENTRY_NORMAL,
    NONE_ID,
    ROLE_LEADER,
    Spec,
)
from etcd_tpu_torch.utils.config import RaftConfig


class Cluster:
    def __init__(self, n_members: int = 3, C: int = 1, spec: Spec | None = None,
                 cfg: RaftConfig = RaftConfig(), voters=None, learners=None,
                 seed: int = 0, telemetry: bool = False, blackbox: bool = False,
                 device=None):
        spec = spec or Spec(M=n_members)
        # the lane padding of the JAX Cluster (2..16 clusters run as 16), so
        # the two fleets hold the same lanes and seeds
        self.C = C
        self._Cp = C if C <= 1 else (16 if C <= 16 else C)
        voters = self._pad(voters)
        learners = self._pad(learners)
        self.eng = RaftEngine(spec, cfg, self._Cp, voters, learners, seed, device)
        self.spec, self.cfg = spec, cfg
        # the planes read NodeState leaves off the live engine state, which
        # the packed storage form does not have
        for on, plane in ((telemetry, "telemetry"), (blackbox, "blackbox")):
            if on and cfg.packed_state:
                raise ValueError(f"Cluster {plane} reads the unpacked fleet; "
                                 "construct with packed_state=False")
        self.tele = init_telemetry(spec, self.eng.state) if telemetry else None
        self.bb = init_blackbox(spec, self.eng.state) if blackbox else None
        self._next_ctx = 1
        self._reset_inputs()

    def _pad(self, mask):
        if mask is None:
            return None
        mask = np.asarray(mask, bool)
        if mask.ndim == 2 and mask.shape[0] != self._Cp:
            mask = np.concatenate([mask] + [mask[:1]] * (self._Cp - mask.shape[0]))
        return torch.from_numpy(mask)

    # -- queued inputs applied on the next round -----------------------------
    def _reset_inputs(self):
        C, M, E = self._Cp, self.spec.M, self.spec.E
        self._hup = np.zeros((M, C), bool)
        self._plen = np.zeros((M, C), np.int32)
        self._pdata = np.zeros((M, E, C), np.int32)
        self._ptype = np.zeros((M, E, C), np.int32)
        self._rictx = np.zeros((M, C), np.int32)

    def campaign(self, m: int, c: int = 0):
        self._hup[m, c] = True

    def propose(self, m: int, data: int, c: int = 0):
        """Queue one normal-entry proposal at node m."""
        i = int(self._plen[m, c])
        if i >= self.spec.E:
            raise ValueError("proposal batch full for this round")
        self._pdata[m, i, c] = data
        self._ptype[m, i, c] = ENTRY_NORMAL
        self._plen[m, c] = i + 1

    def propose_conf_change(self, m: int, data: int, c: int = 0):
        i = int(self._plen[m, c])
        self._pdata[m, i, c] = data
        self._ptype[m, i, c] = ENTRY_CONF_CHANGE
        self._plen[m, c] = i + 1

    def read_index(self, m: int, c: int = 0) -> int:
        ctx = self._next_ctx
        self._next_ctx += 1
        self._rictx[m, c] = ctx
        return ctx

    # -- faults (raft_test.go:4722-4748) --------------------------------------
    def _set_keep(self, km: np.ndarray):
        self.eng.keep_mask = torch.from_numpy(km).to(self.eng.device)

    def _keep(self) -> np.ndarray:
        return self.eng.keep_mask.cpu().numpy().copy()

    def isolate(self, m: int, c: int | None = None):
        km = self._keep()
        cs = slice(None) if c is None else c
        km[m, :, cs] = False
        km[:, m, cs] = False
        self._set_keep(km)

    def cut(self, a: int, b: int, c: int | None = None):
        km = self._keep()
        cs = slice(None) if c is None else c
        km[a, b, cs] = False
        km[b, a, cs] = False
        self._set_keep(km)

    def partition(self, groups: list[list[int]], c: int | None = None):
        """Only links within the same group stay up."""
        M = self.spec.M
        km = np.zeros((M, M), bool)
        for g in groups:
            for a in g:
                for b in g:
                    km[a, b] = True
        full = self._keep()
        cs = slice(None) if c is None else c
        full[:, :, cs] = km[:, :, None] if c is None else km
        self._set_keep(full)

    def recover(self, c: int | None = None):
        km = self._keep()
        km[:, :, slice(None) if c is None else c] = True
        self._set_keep(km)

    # -- stepping ---------------------------------------------------------------
    def step(self, tick: bool = False):
        # padding lanes never tick, so they stay quiet
        do_tick = np.zeros((self.spec.M, self._Cp), bool)
        if tick:
            do_tick[:, : self.C] = True
        planes = self.tele is not None or self.bb is not None
        pre = snapshot_pre(self.eng.state) if planes else None
        # the inbox this round consumes is the ring's receive side
        recv = msg_activity(self.spec, self.eng.inbox, "recv") if self.bb is not None else None
        self.eng.step(prop_len=self._plen, prop_data=self._pdata,
                      prop_type=self._ptype, ri_ctx=self._rictx, do_hup=self._hup,
                      do_tick=do_tick)
        if self.tele is not None:
            self.tele = telemetry_update(self.spec, self.tele, pre, self.eng.state)
        if self.bb is not None:
            self.bb = blackbox_update(self.spec, self.bb, pre, self.eng.state,
                                      inbox=recv, outbox=self.eng.inbox)
        self._reset_inputs()

    def reset_telemetry(self) -> None:
        """Open a fresh telemetry window (the counters are int32 and meant
        to be reset per window)."""
        if self.tele is not None:
            self.tele = init_telemetry(self.spec, self.eng.state)

    def telemetry_report(self) -> dict:
        """The telemetry report over the real lanes (the padding lanes stay
        out of the lane aggregates)."""
        if self.tele is None:
            raise ValueError("this Cluster has no telemetry plane; construct it "
                             "with telemetry=True")
        return telemetry_report(self.tele, groups=self.C)

    def tick(self, rounds: int = 1):
        for _ in range(rounds):
            self.step(tick=True)

    def _pending(self) -> int:
        """Pending messages over the real lanes only."""
        return int((self.eng.inbox.type[..., : self.C] != 0).sum())

    def stabilize(self, max_rounds: int = 64, tick: bool = False):
        """Deliver cascades to quiescence (network.send's loop-to-empty,
        raft_test.go:4713-4720)."""
        self.step(tick=tick)
        for _ in range(max_rounds):
            if self._pending() == 0:
                break
            self.step(tick=tick)
        return self

    # -- whitebox drivers -------------------------------------------------------
    def set_node(self, m: int, c: int = 0, **fields):
        """Overwrite state leaves of one node, e.g.
        set_node(1, term=2, vote=0, role=ROLE_FOLLOWER)."""
        upd = {}
        for k, v in fields.items():
            leaf = getattr(self.eng.state, k).clone()
            leaf[m, ..., c] = torch.as_tensor(v, dtype=leaf.dtype)
            upd[k] = leaf
        self.eng.state = self.eng.state.replace(**upd)

    def get(self, field: str, m: int, c: int = 0):
        v = getattr(self.eng.state, field)[m, ..., c].cpu().numpy()
        return v.item() if v.ndim == 0 else v

    def leaf(self, field: str, c: int = 0) -> np.ndarray:
        """One cluster's view of a state leaf, members leading: [M, ...]."""
        return getattr(self.eng.state, field)[..., c].cpu().numpy()

    def _slot(self, to: int, slot: int, ent: bool = False):
        """Index into the flat inbox middle axis (engine.empty_inbox)."""
        base = slot * self.spec.M + to
        if ent:
            return slice(base * self.spec.E, (base + 1) * self.spec.E)
        return base

    def inject(self, to: int, frm: int, c: int = 0, slot: int = 0, **fields):
        """Place a raw message into the pending inbox (delivered next step)."""
        fields.setdefault("frm", frm)
        upd = {}
        for k, v in fields.items():
            leaf = getattr(self.eng.inbox, k).clone()
            leaf[frm, self._slot(to, slot, k in ENT_FIELDS), c] = torch.as_tensor(
                v, dtype=leaf.dtype)
            upd[k] = leaf
        self.eng.inbox = self.eng.inbox.replace(**upd)

    def drain(self, c: int = 0):
        """Drop all pending messages (the fake network's filter-and-discard,
        raft_test.go:4750-4760)."""
        t = self.eng.inbox.type.clone()
        t[..., c] = 0
        self.eng.inbox = self.eng.inbox.replace(type=t)

    def pending(self, c: int = 0):
        """[(to, frm, slot, type), ...] of undelivered messages."""
        M = self.spec.M
        t = self.eng.inbox.type[..., c].cpu().numpy()     # [from, K*to]
        return [(int(kt % M), int(frm), int(kt // M), int(t[frm, kt]))
                for frm, kt in zip(*np.nonzero(t))]

    def msg_field(self, field: str, to: int, frm: int, slot: int = 0, c: int = 0):
        v = getattr(self.eng.inbox, field)[
            frm, self._slot(to, slot, field in ENT_FIELDS), c].cpu().numpy()
        return v.item() if v.ndim == 0 else v

    # -- inspection -------------------------------------------------------------
    @property
    def s(self):
        """The state restricted to the real lanes."""
        if self._Cp == self.C:
            return self.eng.state
        return self.eng.state.map(lambda _, x: x[..., : self.C])

    def roles(self, c: int = 0) -> np.ndarray:
        return self.leaf("role", c)

    def leaders(self, c: int = 0) -> list[int]:
        return [int(i) for i in np.nonzero(self.roles(c) == ROLE_LEADER)[0]]

    def leader(self, c: int = 0) -> int:
        """The leader at the highest term (an isolated stale leader may
        coexist, which is legal Raft)."""
        ids = self.leaders(c)
        if not ids:
            return NONE_ID
        terms = self.terms(c)
        return int(max(ids, key=lambda i: terms[i]))

    def terms(self, c: int = 0) -> np.ndarray:
        return self.leaf("term", c)

    def commits(self, c: int = 0) -> np.ndarray:
        return self.leaf("commit", c)

    def log_entries(self, m: int, c: int = 0) -> list[tuple[int, int]]:
        """[(term, data), ...] for indexes (snap, last]."""
        last = self.get("last_index", m, c)
        snap = self.get("snap_index", m, c)
        lt = self.get("log_term", m, c)
        ld = self.get("log_data", m, c)
        return [(int(lt[(i - 1) % self.spec.L]), int(ld[(i - 1) % self.spec.L]))
                for i in range(snap + 1, last + 1)]
