"""Replicated KV server runtime over the batched consensus engine
(etcd_tpu/server/kvserver.py on the port's torch ``Cluster``).

The reference's ``EtcdServer`` (server/etcdserver/server.go:202) owns the
raft node, MVCC, lessor and auth store, routes client requests through
consensus (v3_server.go:643 processInternalRaftRequestOnce: register wait id
-> Propose -> block until applied), applies committed entries to the state
machine (server.go:1829-1944), and serves linearizable reads via ReadIndex
(v3_server.go:709-879).

Here one :class:`EtcdCluster` drives cluster ``c`` of a batched engine; each
member has its own :class:`MemberState` (watchable MVCC + lessor + auth),
exactly like each etcd process has its own bbolt. Entry payloads live in a
host-side request table keyed by the int32 word the device replicates — the
"payloadRef" scheme of SURVEY.md §7: the device log replicates references,
the host resolves them at apply time. Apply results flow back through a
wait-map (pkg/wait/wait.go:33-41 analog) to the blocked caller.

The cluster's state leaves live on its device (``device=None``: CUDA). The
server reads them only through :meth:`EtcdCluster._read`, which takes the
leaves it names for this cluster's lane off the device in one transfer; on
CUDA the ``Cluster``'s round replays as one CUDA graph a step. With a
``data_dir`` each member keeps its applied state in a backend file
(storage/backend.py, storage/schema.py): ``_pump`` stages every apply batch
behind it, a crashed member restarts from that file, and ``boot_from_disk``
rebuilds a whole cluster from a directory, writing its restored raft
position into the device state through ``Cluster.set_node``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.models import confchange as ccdev
from etcd_tpu_torch.models.changer import Changer, Config as HostConfig, ConfChangeError
from etcd_tpu_torch.server.auth import AuthStore
from etcd_tpu_torch.server.lease import ErrLeaseNotFound, Lessor
from etcd_tpu_torch.server.mvcc import ErrCompacted, ErrFutureRev, KeyValue
from etcd_tpu_torch.server.version import (
    DowngradeInfo,
    MIN_CLUSTER_VERSION,
    SERVER_VERSION,
    VersionMonitor,
    allowed_downgrade_version,
    cluster_version_str,
    detect_downgrade,
    major_minor,
)
from etcd_tpu_torch.server.v2store import V2Store
from etcd_tpu_torch.server.watch import WatchableStore
from etcd_tpu_torch.types import ENTRY_CONF_CHANGE, NONE_ID, ROLE_LEADER


class ServerError(Exception):
    pass


class ErrNoLeader(ServerError):
    pass


class ErrTimeout(ServerError):
    pass


class ErrTooManyRequests(ServerError):
    """commit-apply gap backpressure (v3_server.go:45,646)."""


class ErrNoSpace(ServerError):
    """NOSPACE alarm raised through consensus (api/v3alarm)."""


class ErrCorrupt(ServerError):
    pass


class ErrInvalidDowngradeTargetVersion(ServerError):
    """target must be exactly one minor below the cluster version
    (v3_server.go:936-938)."""


class ErrDowngradeInProcess(ServerError):
    """a downgrade job is already live (v3_server.go:941-944)."""


class ErrNoInflightDowngrade(ServerError):
    """cancel with no live downgrade job (v3_server.go:979-983)."""


class ErrClusterVersionUnavailable(ServerError):
    """cluster version not yet decided (v3_server.go:930-932)."""


@dataclasses.dataclass
class ResponseHeader:
    cluster_id: int
    member_id: int
    revision: int
    raft_term: int


@dataclasses.dataclass
class Op:
    """clientv3.Op analog (client/v3/op.go)."""

    type: str  # "put" | "range" | "delete"
    key: bytes
    value: bytes = b""
    range_end: bytes | None = None
    lease: int = 0
    prev_kv: bool = False
    limit: int = 0
    rev: int = 0
    count_only: bool = False


@dataclasses.dataclass
class Compare:
    """clientv3.Compare (client/v3/compare.go): target in
    {version,create,mod,value,lease}, result in {=,!=,>,<}."""

    key: bytes
    target: str
    result: str
    value: Any


@dataclasses.dataclass
class MemberState:
    """One member's applied state machine bundle."""

    store: WatchableStore
    lessor: Lessor
    auth: AuthStore
    applied_index: int = 0
    # wait-map: req word -> apply result (pkg/wait analog)
    results: dict[int, Any] = dataclasses.field(default_factory=dict)
    alarms: set[str] = dataclasses.field(default_factory=set)
    # durable backend (bbolt analog; None = memory-only member)
    backend: Any = None
    persisted_rev: int = 0
    persisted_compact: int = 0
    # consistent index actually fsync'd — the replay floor after a crash
    durable_index: int = 0
    crashed: bool = False  # host process down: skip apply + donor duty
    _persist_sig: Any = None  # last persisted (applied, rev, compact)
    # this member binary's version (version.Version; overridable per
    # member for mixed-version fleets) and its APPLIED view of the
    # negotiated cluster version + downgrade job — replicated state,
    # set only through consensus (cluster.go SetVersion/SetDowngradeInfo)
    server_version: str = SERVER_VERSION
    cluster_version: str | None = None
    downgrade: DowngradeInfo = dataclasses.field(default_factory=DowngradeInfo)
    # legacy v2 applied state machine (api/v2store), mutated only by
    # committed kind="v2" entries (the applyV2Request path, apply_v2.go)
    v2store: "V2Store" = dataclasses.field(default_factory=lambda: V2Store())


class EtcdCluster:
    """Drives one batched cluster as an etcd-like multi-member deployment."""

    MAX_APPLY_WAIT_ROUNDS = 64
    MAX_GAP = 5000  # maxGapBetweenApplyAndCommitIndex (v3_server.go:45)

    def __init__(
        self,
        n_members: int = 3,
        cluster: Cluster | None = None,
        c: int = 0,
        quota_bytes: int = 0,
        lease_min_ttl: int = 1,
        data_dir: str | None = None,
        auth_token: str = "simple",
        auth_jwt_key: bytes | None = None,
        durable_proposes: bool = False,
        apply_plane: str = "host",
        kv_keys: int = 64,
        telemetry: bool = False,
        blackbox: bool = False,
        device=None,
    ):
        # telemetry=True attaches the fleet telemetry plane to the
        # backing Cluster (harness/cluster.py): /metrics then serves the
        # latency-histogram families (v3rpc) from it; blackbox=True adds
        # the per-round EventRing (models/blackbox.py), exportable as a
        # Chrome trace alongside the host request spans below. Ignored
        # when an explicit `cluster` is injected — its owner decides, and
        # its device is the server's.
        self.cl = cluster or Cluster(n_members=n_members,
                                     telemetry=telemetry,
                                     blackbox=blackbox,
                                     device=device)
        # acknowledged ⇒ on disk: fsync the members' backends before a
        # propose returns (the reference gets this from WAL MustSync
        # before the Ready is acked, storage.go; here the device ring
        # is the log and dies with the process, so the durable floor is
        # the backend record log). Off by default for in-process
        # harness/test clusters; embed turns it on unless the operator
        # passes --unsafe-no-fsync.
        self.durable_proposes = durable_proposes
        self.c = c
        self.M = self.cl.spec.M
        self.quota_bytes = quota_bytes
        self.requests: dict[int, dict] = {}  # word -> request payload
        self._next_word = 1
        self.data_dir = data_dir
        self._gc_floor = 0  # lowest applied index with payloads retained
        # --auth-token analog (embed.Config.AuthToken): every member (and
        # every restart incarnation) shares the provider spec + signing key
        self.auth_token = auth_token
        self.auth_jwt_key = auth_jwt_key
        # armed by embed's ticker (utils/contention.py): late host ticks
        # are the TPU analog of the reference's late leader heartbeats
        self.contention = None
        # slow-request counters served by /metrics
        # (etcd_server_slow_apply_total / etcd_server_slow_read_indexes_
        # total — the reference's applyTook>warningApplyDuration and
        # slowReadIndex signals, server.go / v3_server.go)
        self.slow_apply_total = 0
        self.slow_read_index_total = 0
        # completed request spans (Trace.to_span dicts) for the Chrome
        # trace exporter; bounded ring so long-lived servers don't grow
        self.req_spans: list[dict] = []
        # per-member binary-version overrides for mixed-version fleets
        # (the reference's rolling binary swap); applies at construction
        # AND at restart-from-disk (see _member_from_backend)
        self.server_versions: dict[int, str] = {}
        # wall clock for v2 TTL stamping (injectable for deterministic
        # TTL tests; replicated state never reads it directly — only
        # propose-time stamps do)
        import time as _time

        self.v2_now = _time.time
        # apply_plane="device": each member's KV store is one lane of the
        # device-resident apply plane (etcd_tpu/device_mvcc) behind the
        # DeviceBackedStore facade — puts/deletes/compactions dispatch as
        # int32 op words, reads/digests come back from device tensors,
        # and watch events fan out of the per-op delta readbacks.  The
        # host plane stays the default; the device plane serves the
        # canonical key space only (scheme.key_bytes) and is exercised
        # end-to-end by tests/test_device_mvcc.py.
        if apply_plane not in ("host", "device"):
            raise ServerError(f"unknown apply_plane {apply_plane!r}")
        self.apply_plane = apply_plane
        self.device_plane = None
        if apply_plane == "device":
            if data_dir:
                raise ServerError(
                    "apply_plane='device' has no backend persistence path "
                    "yet; the durable floor is the device snapshot tier"
                )
            from etcd_tpu_torch.device_mvcc import DevicePlane, KVSpec

            self.device_plane = DevicePlane(KVSpec(keys=kv_keys), C=self.M,
                                            device=self.cl.eng.device)
        self.members = [
            MemberState(self._fresh_store(m), Lessor(lease_min_ttl),
                        self._new_auth())
            for m in range(self.M)
        ]
        if data_dir:
            import os

            from etcd_tpu_torch.storage.backend import Backend

            os.makedirs(data_dir, exist_ok=True)
            for m, ms in enumerate(self.members):
                # fresh incarnation: any file from a previous cluster in
                # this directory must not leak phantom revisions
                ms.backend = Backend(self._backend_path(m), fresh=True)
        self._root_token: str | None = None

    @staticmethod
    def member_db_path(data_dir: str, m: int) -> str:
        import os

        return os.path.join(data_dir, f"member{m}.db")

    def _backend_path(self, m: int) -> str:
        return self.member_db_path(self.data_dir, m)

    def _read(self, *names: str, m: int | None = None) -> list[np.ndarray]:
        """This cluster's view of state leaves (``[M, ...]``, or member
        ``m``'s ``[...]``), taken off the device in one transfer: the one
        place the server reads the device state."""
        st = self.cl.eng.state
        idx = (Ellipsis, self.c) if m is None else (m, Ellipsis, self.c)
        parts = [getattr(st, n)[idx] for n in names]
        flat = torch.cat([x.reshape(-1).to(torch.int64) for x in parts]).cpu().numpy()
        out, at = [], 0
        for x in parts:
            k = x.numel()
            out.append(flat[at:at + k].reshape(tuple(x.shape)).astype(
                np.bool_ if x.dtype == torch.bool else np.int64))
            at += k
        return out

    def _new_auth(self) -> AuthStore:
        return AuthStore(token=self.auth_token, jwt_key=self.auth_jwt_key)

    def _fresh_store(self, m: int) -> WatchableStore:
        """An empty applied KV store for member m — a host MVCCStore, or
        (device plane) the member's device lane wiped back to boot state
        (a crash drops the applied state machine either way; recovery is
        ring replay or a peer snapshot through _pump)."""
        if self.device_plane is None:
            return WatchableStore()
        from etcd_tpu_torch.server.mvcc import DeviceBackedStore

        self.device_plane.load_lane(m, {}, 1, 0)
        return WatchableStore(DeviceBackedStore(self.device_plane, m))

    # ------------------------------------------------------------------ raft
    def leader(self) -> int:
        return self.cl.leader(self.c)

    def ensure_leader(self) -> int:
        lead = self.leader()
        if lead == NONE_ID:
            for _ in range(40):
                self.tick()
                lead = self.leader()
                if lead != NONE_ID:
                    break
        if lead == NONE_ID:
            raise ErrNoLeader()
        return lead

    def tick(self, lease_clock: bool = True) -> None:
        """One raft tick. `lease_clock=False` advances only the raft
        timers: lease/auth TTLs are denominated in SECONDS like the
        reference (lease/lessor.go), so a sub-second raft ticker (e.g.
        embed's 100ms loop) must advance the lease clock on a 1s cadence,
        not per raft tick."""
        self.cl.step(tick=True)
        self._pump()
        if lease_clock:
            self.advance_lease_clock()

    def advance_lease_clock(self) -> None:
        """One lease-clock second: TTL countdowns + expiry proposals."""
        for ms in self.members:
            ms.lessor.tick()
            ms.auth.tick()
        self._expire_leases()

    def step(self) -> None:
        self.cl.step()
        self._pump()

    def sync_for_shutdown(self, max_rounds: int = 16) -> None:
        """Drain commit -> apply -> persist before a clean close, so every
        member's backend reaches the committed front. A reference follower
        gets this durability from WAL replay of its committed tail
        (storage.go MustSync + bootstrapWithWAL); here the device ring is
        the log and dies with the process, so the drain runs eagerly.

        The staged batches are then COMMITTED: _persist only flushes at
        the batch threshold, so a short-lived cluster that drained its
        applies could still lose the whole applied_meta record to a
        subsequent crash (found by test_restart_refused_mid_downgrade —
        the restart recovered via peer snapshot instead of its own disk,
        masking the mustDetectDowngrade boot check)."""
        for _ in range(max_rounds):
            live = [
                ms.applied_index for ms in self.members if not ms.crashed
            ]
            if len(set(live)) <= 1:
                break
            self.step()
        self.commit_backends()

    def stabilize(self, max_rounds: int = 64) -> None:
        self.cl.step()
        self._pump()
        for _ in range(max_rounds):
            if self.cl.eng.pending_messages() == 0:
                break
            self.cl.step()
            self._pump()

    # -------------------------------------------------------------- applying
    def _pump(self) -> None:
        """Drain newly-applied entries device->host for every member
        (the applyAll path, server.go:903-1104)."""
        # one device-to-host transfer a step: the apply cursors, the ring,
        # the terms _persist records and the config masks _gc_requests
        # reads (the host's applies do not move the device state, so one
        # read serves the whole pump)
        applied, snap, terms, datas, types, terms_now, *conf = self._read(
            "applied", "snap_index", "log_term", "log_data", "log_type", "term",
            "voters", "voters_out", "learners")
        L = self.cl.spec.L

        def apply_range(m, ms, lo, hi):
            for idx in range(lo + 1, hi + 1):
                sl = (idx - 1) % L
                self._apply_entry(
                    m, ms, idx, int(types[m, sl]), int(datas[m, sl]),
                    int(terms[m, sl]),
                )
            ms.applied_index = hi

        # pass 1: members whose ring still covers their gap — pumping them
        # first means their fresh host state is available as snapshot donor
        # material for pass 2
        gapped = []
        for m, ms in enumerate(self.members):
            if ms.crashed:
                continue
            hi, lo = int(applied[m]), ms.applied_index
            if hi <= lo:
                continue
            # a member is gapped when the ring compacted past its cursor
            # OR the host payload table was GC'd below it (a restarted
            # member replaying from 0): ring replay would silently skip
            # entries — install a peer snapshot instead
            if int(snap[m]) > lo or lo < self._gc_floor:
                gapped.append(m)
                continue
            apply_range(m, ms, lo, hi)
        # pass 2: the device compacted past these members' host-applied
        # cursors — entries (lo, snap] are gone from the ring. Install a
        # peer's state-machine snapshot first (the applySnapshot path,
        # server.go:925-1061); silently skipping the gap would diverge this
        # member's MVCC from its peers.
        for m in gapped:
            ms = self.members[m]
            self._install_peer_snapshot(
                m, ms, max(int(snap[m]), self._gc_floor)
            )
            hi, lo = int(applied[m]), ms.applied_index
            if hi > lo:
                apply_range(m, ms, lo, hi)
        for m, ms in enumerate(self.members):
            if ms.backend is not None and not ms.crashed:
                self._persist(ms, int(terms_now[m]))
        self._gc_requests(*conf)

    def commit_backends(self) -> None:
        """Flush + fsync every live member's staged batch so the durable
        floor reaches the current applied front (the per-ack half of
        sync_for_shutdown's drain)."""
        for ms in self.members:
            if ms.backend is not None and not ms.crashed:
                ms.backend.commit()
                ms.durable_index = ms.applied_index

    def _persist(self, ms: MemberState, term: int) -> None:
        """Write the apply batch behind the member: new MVCC revisions +
        one atomic applied-meta record (consistent index, cursors, lease/
        auth/alarm snapshots) — the batchTx + cindex discipline of
        backend/batch_tx.go + cindex/cindex.go:30-38. Flushing happens on
        the backend's batch limit; a crash between commits rolls the
        member back to the last committed point and WAL/ring replay
        resumes from its consistent index."""
        from etcd_tpu_torch.storage import schema
        from etcd_tpu_torch.utils import failpoints

        kv = ms.store.kv
        sig = (ms.applied_index, kv.current_rev, kv.compact_rev)
        if sig == getattr(ms, "_persist_sig", None):
            return  # nothing applied since the last persist: no-op
        # gofail raftBeforeSave marker (etcdserver/raft.go:221): the batch
        # is about to be staged behind this member
        failpoints.fire("raftBeforeSave")
        if kv.compact_rev > ms.persisted_compact:
            schema.persist_compaction(ms.backend, kv)
            ms.persisted_compact = kv.compact_rev
        ms.persisted_rev = schema.persist_mvcc_delta(
            ms.backend, kv, ms.persisted_rev
        )
        schema.save_applied_meta(
            ms.backend,
            index=ms.applied_index,
            term=term,
            store=kv,
            lease_snap=ms.lessor.to_snapshot(),
            auth_snap=ms.auth.to_snapshot(),
            alarms=ms.alarms,
            cluster_version=ms.cluster_version,
            downgrade=ms.downgrade.to_dict(),
            v2=ms.v2store.save(),
        )
        # sig records success only after the batch is fully staged: a crash
        # at any marker above re-stages the whole batch on the next pump
        ms._persist_sig = sig
        # gofail raftAfterSave (etcdserver/raft.go:228): staged but not
        # necessarily fsync'd — a crash here loses the uncommitted batch
        failpoints.fire("raftAfterSave")
        # half-full batch -> flush now so the durable floor advances and
        # the payload table can GC (the 100ms batchInterval analog)
        if ms.backend._pending_ops >= ms.backend.batch_limit // 2:
            ms.backend.commit()
        if not ms.backend._pending_ops:
            ms.durable_index = ms.applied_index

    def crash_member(self, m: int) -> None:
        """Simulate a member process crash: all host applied state is
        dropped; only what the backend committed survives on disk."""
        from etcd_tpu_torch.utils.logging import get_logger

        get_logger().warning("member %d crashed (host state dropped)", m)
        ms = self.members[m]
        if ms.backend is not None:
            ms.backend._f.close()  # no commit: the pending batch is lost
        husk = MemberState(
            self._fresh_store(m), Lessor(ms.lessor.min_ttl), self._new_auth()
        )
        husk.crashed = True
        self.members[m] = husk

    def restart_member_from_disk(self, m: int) -> None:
        """Rebuild a member's applied state machine from its backend (the
        bootstrapBackend path, server/etcdserver/bootstrap.go:145): MVCC
        from the key bucket trimmed to the atomic applied-meta record,
        lease/auth/alarms from that record, applied cursor = consistent
        index — entries <= cindex replay as no-ops (dedup across restart,
        server.go:1879-1885)."""
        from etcd_tpu_torch.storage.backend import Backend

        if self.data_dir is None:
            # memory-only member: nothing on disk — come back empty and
            # catch up from the ring / a peer snapshot through _pump. The
            # restarting binary keeps its override version, and the boot
            # check runs AFTER catch-up against whatever cluster state the
            # peer snapshot restored (the bootstrapExistingClusterNoWAL
            # case of mustDetectDowngrade).
            husk = MemberState(
                self._fresh_store(m),
                Lessor(self.members[m].lessor.min_ttl), self._new_auth(),
            )
            if m in self.server_versions:
                husk.server_version = self.server_versions[m]
            self.members[m] = husk
            self._pump()
            ms = self.members[m]
            try:
                detect_downgrade(
                    ms.server_version, ms.cluster_version, ms.downgrade
                )
            except Exception:
                ms.crashed = True  # refuse to serve on an illegal mix
                raise
            return

        be = Backend(self._backend_path(m))
        ms, _ = self._member_from_backend(
            be, self.members[m].lessor.min_ttl, m=m
        )
        self.members[m] = ms
        # catch up from the device ring (or a peer snapshot if compacted)
        self._pump()

    def _member_from_backend(
        self, be, lease_min_ttl: int = 1, m: int | None = None
    ) -> tuple[MemberState, dict]:
        """Rebuild one member's applied state bundle from an open backend
        (the shared tail of bootstrapBackend, bootstrap.go:145)."""
        from etcd_tpu_torch.storage import schema

        meta = schema.load_applied_meta(be) or {
            "consistent_index": 0, "term": 0, "current_rev": 1,
            "compact_rev": 0, "lease": None, "auth": None, "alarms": [],
        }
        store = schema.load_mvcc(
            be, max_rev=meta["current_rev"], compact_rev=meta["compact_rev"]
        )
        ws = WatchableStore()
        ws.restore(store)
        ms = MemberState(ws, Lessor(lease_min_ttl), self._new_auth())
        if meta["lease"] is not None:
            ms.lessor.restore(meta["lease"])
        if meta["auth"] is not None:
            ms.auth.restore(meta["auth"])
        ms.alarms = set(meta["alarms"])
        ms.applied_index = meta["consistent_index"]
        ms.backend = be
        ms.persisted_rev = store.current_rev
        ms.persisted_compact = store.compact_rev
        ms.durable_index = meta["consistent_index"]
        # recover the replicated version records (cluster.go:263-269),
        # then refuse to serve on an illegal version mix — the
        # mustDetectDowngrade boot check (downgrade.go:41-75). The
        # restarting "binary"'s version comes from the per-member
        # override map (a rolling binary swap in the reference world).
        if m is not None and m in self.server_versions:
            ms.server_version = self.server_versions[m]
        ms.cluster_version = meta.get("cluster_version")
        ms.downgrade = DowngradeInfo.from_dict(meta.get("downgrade"))
        if meta.get("v2"):
            ms.v2store.recovery(meta["v2"])
        detect_downgrade(ms.server_version, ms.cluster_version, ms.downgrade)
        return ms, meta

    @classmethod
    def boot_from_disk(
        cls,
        data_dir: str,
        n_members: int = 3,
        missing_ok: bool = False,
        uniform: bool = True,
        members: list[int] | None = None,
        **kw,
    ) -> "EtcdCluster":
        """Boot a cluster from an EXISTING data dir (the bootstrapWithWAL /
        etcdutl-restore boot path, bootstrap.go:253 +
        etcdutl/snapshot_command.go:122): each member's applied state
        machine loads from its backend, and the device raft state starts
        from a synthetic snapshot at the restored consistent index — the
        analog of the fresh WAL whose first record is the snapshot marker
        that `etcdutl snapshot restore` writes. Contrast __init__ with
        data_dir=..., which wipes for a fresh incarnation.

        ``missing_ok``: members whose backend file is absent boot empty
        and catch up from a peer snapshot — the in-process analog of
        bootstrapExistingClusterNoWAL (bootstrap.go:182): a data-less
        member joining a cluster that already has state.

        ``uniform``: require every present member at ONE consistent index
        (the etcdutl-restore contract — a restored dir is written from a
        single snapshot). Restarting a live data dir (embed's haveWAL
        path) passes False: members legitimately shut down a few applied
        entries apart, and the laggards catch up from the most advanced
        peer exactly as a slow member would at runtime.

        ``members``: which on-disk member files back each new member
        (defaults to identity). force-new-cluster passes the surviving
        member's index so a 1-member recovery can start from whichever
        data file still exists; the loaded backend stays bound to that
        file, so subsequent persists continue it."""
        import os

        from etcd_tpu_torch.storage.backend import Backend

        ec = cls(n_members=n_members, **kw)  # memory boot; no wipe
        ec.data_dir = data_dir
        disk = members if members is not None else list(range(ec.M))
        if len(disk) != ec.M:
            raise ServerError(
                f"members maps {len(disk)} disk files onto {ec.M} members"
            )
        metas = []
        missing: list[int] = []
        for m in range(ec.M):
            path = cls.member_db_path(data_dir, disk[m])
            if missing_ok and not os.path.exists(path):
                missing.append(m)
                metas.append(None)
                continue
            be = Backend(path)
            ms, meta = ec._member_from_backend(be, m=m)
            ec.members[m] = ms
            metas.append(meta)
        present = [meta for meta in metas if meta is not None]
        if not present:
            raise ServerError(
                f"no member data found under {data_dir}; cannot join an "
                "existing cluster that has none"
            )
        idx = max(meta["consistent_index"] for meta in present)
        term = max(meta["term"] for meta in present)
        behind: list[int] = []
        for m, meta in enumerate(metas):
            if meta is not None and meta["consistent_index"] != idx:
                if uniform:
                    raise ServerError(
                        f"member {m} restored at index "
                        f"{meta['consistent_index']} != {idx}; a restored "
                        "data dir must be uniform (snapshot restore writes "
                        "every member from the same snapshot)"
                    )
                behind.append(m)
        if idx > 0:
            # synthetic device snapshot: log starts at (idx, term) with an
            # empty tail, exactly like handle_snapshot's restore field set
            # (models/raft.py:718-736) minus the config masks, which a
            # restored cluster keeps at the boot-time full-voter set
            for m in range(ec.M):
                ec.cl.set_node(
                    m, c=ec.c,
                    term=term, commit=idx, applied=idx, last_index=idx,
                    snap_index=idx, snap_term=term,
                    applied_hash=0, snap_hash=0,
                )
            ec._gc_floor = idx
        for m in missing:
            # data-less joiner: fresh backend + applied state from the
            # most advanced restored peer, then persist the baseline
            ec.members[m].backend = Backend(
                cls.member_db_path(data_dir, disk[m]), fresh=True
            )
            if idx > 0:
                ec._install_peer_snapshot(m, ec.members[m], idx)
            ec._persist(ec.members[m], term)
        for m in behind:
            # shut down a few entries behind the front: catch up the
            # applied state machine from the most advanced peer
            ec._install_peer_snapshot(m, ec.members[m], idx)
            ec._persist(ec.members[m], term)
        return ec

    def _install_peer_snapshot(self, m: int, ms: "MemberState",
                               need: int) -> None:
        """Restore member m's applied state machine from the most advanced
        peer whose snapshot covers index `need` (SendSnapshot/applySnapshot:
        rafthttp snapshot_sender.go + server.go:925). Raises ErrCorrupt if
        no peer can cover the gap — failing loudly beats silent divergence."""
        donors = [
            d for d in range(self.M)
            if d != m and not self.members[d].crashed
            and self.members[d].applied_index >= need
        ]
        if not donors:
            raise ErrCorrupt(
                f"member {m} needs applied state at index {need} but no peer "
                f"has applied that far; host state machine cannot catch up"
            )
        donor = max(donors, key=lambda d: self.members[d].applied_index)
        from etcd_tpu_torch.utils import failpoints
        from etcd_tpu_torch.utils.logging import get_logger

        # gofail raftBeforeApplySnap/raftAfterApplySnap
        # (etcdserver/raft.go:242,256)
        failpoints.fire("raftBeforeApplySnap")
        get_logger().info(
            "installing peer snapshot on member %d from donor %d at "
            "index %d", m, donor, self.members[donor].applied_index,
        )
        # the snapshot moves through the streamed side-channel (chunked,
        # per-chunk + total CRC — snapshot_sender.go / snap/db.go), so a
        # torn or corrupted transfer raises instead of installing
        from etcd_tpu_torch.storage.snapstream import transfer

        self.restore_member(m, transfer(self.member_snapshot(donor)))
        failpoints.fire("raftAfterApplySnap")

    # -- state-machine snapshots (full applied state, not just KV) ----------
    def member_snapshot(self, m: int) -> dict:
        """Everything needed to reconstruct a member's applied state at its
        applied_index: MVCC + lessor + auth + alarms (the merged
        WAL-snapshot + backend `.snap.db` of snapshot_merge.go:85)."""
        ms = self.members[m]
        return {
            "applied_index": ms.applied_index,
            "term": int(self._read("term", m=m)[0]),
            "kv": ms.store.kv.to_snapshot(),
            "lease": ms.lessor.to_snapshot(),
            "auth": ms.auth.to_snapshot(),
            "alarms": sorted(ms.alarms),
            # replicated version records: a snapshot-restored member must
            # not revert to "version unknown" — that would wedge
            # versions_match_target (and so monitor_downgrade) forever
            "cluster_version": ms.cluster_version,
            "downgrade": ms.downgrade.to_dict(),
            # v2 tree rides the snapshot like the reference's v2store
            # snap (server.go snapshot() marshals the v2 store)
            "v2": ms.v2store.save(),
        }

    def restore_member(self, m: int, snap: dict) -> None:
        from etcd_tpu_torch.server.mvcc import DeviceBackedStore, MVCCStore

        ms = self.members[m]
        if self.device_plane is not None:
            # install into the device lane, then re-sync watchers against
            # the same facade object (the applySnapshot path, device form)
            kv = ms.store.kv
            if not isinstance(kv, DeviceBackedStore):
                kv = DeviceBackedStore(self.device_plane, m)
            kv.load_snapshot(snap["kv"])
            ms.store.restore(kv)
        else:
            ms.store.restore(MVCCStore.from_snapshot(snap["kv"]))
        ms.lessor.restore(snap["lease"])
        ms.auth.restore(snap["auth"])
        ms.alarms = set(snap["alarms"])
        ms.applied_index = snap["applied_index"]
        ms.cluster_version = snap.get("cluster_version")
        ms.downgrade = DowngradeInfo.from_dict(snap.get("downgrade"))
        if snap.get("v2"):
            ms.v2store.recovery(snap["v2"])
        ms.results.clear()

    def _gc_requests(self, voters, voters_out, learners) -> None:
        """Drop request payloads every configured member has applied (the
        analog of log compaction for the host-side payload table); the
        masks are every member's ``[M, M]`` config rows, as _pump read them."""
        ref = max(range(self.M), key=lambda m: self.members[m].applied_index)
        conf = voters[ref] | voters_out[ref] | learners[ref]
        # The floor is what's DURABLE per member: a backend member may
        # restart and replay everything past its last committed consistent
        # index, so its payloads must survive until that index advances
        # (the WAL-retained-until-snapshot contract). A crashed husk pins
        # the floor at 0 until restart.
        def _floor(ms: MemberState) -> int:
            if ms.crashed:
                return 0
            if ms.backend is not None:
                return min(ms.applied_index, ms.durable_index)
            return ms.applied_index

        floor = min(_floor(self.members[m]) for m in range(self.M) if conf[m])
        self._gc_floor = max(self._gc_floor, floor)
        for word in [
            w for w, r in self.requests.items()
            if r.get("_index", 1 << 62) <= floor
        ]:
            del self.requests[word]

    def _apply_entry(self, m, ms, index, etype, word, term) -> None:
        if etype == ENTRY_CONF_CHANGE:
            return  # device applied it to the config masks already
        if word == 0:
            return  # empty (leader-election) entry
        req = self.requests.get(word)
        if req is None:
            return  # foreign/unknown ref (e.g. replay after restart)
        req["_index"] = index  # for payload-table GC once all members apply
        t0 = time.perf_counter()
        try:
            res = self._dispatch(m, ms, req)
        except (ServerError, Exception) as e:  # applier must never crash
            res = e
        dt = time.perf_counter() - t0
        if dt > self.SLOW_APPLY_THRESHOLD_S:
            # the applyTook > warningApplyDuration signal
            # (etcdserver/server.go) behind etcd_server_slow_apply_total
            self.slow_apply_total += 1
            from etcd_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "slow apply: member=%d kind=%s index=%d took %.3fs",
                m, req.get("kind", "?"), index, dt)
        # only the serving member's wait-map entry has a consumer; recording
        # results on every member would leak one entry per request per peer
        if m == req.get("_serve_m"):
            ms.results[word] = res

    # dispatch of InternalRaftRequest (apply.go:64-99 applierV3 surface)
    def _dispatch(self, m: int, ms: MemberState, req: dict) -> Any:
        kind = req["kind"]
        if kind == "put":
            return self._apply_put(ms, req)
        if kind == "delete_range":
            return self._apply_delete(ms, req)
        if kind == "txn":
            return self._apply_txn(ms, req)
        if kind == "compact":
            ms.store.kv.compact(req["rev"])
            return req["rev"]
        if kind == "lease_grant":
            l = ms.lessor.grant(req["id"], req["ttl"])
            return (l.id, l.ttl)
        if kind == "lease_revoke":
            keys = ms.lessor.revoke(req["id"])
            txn = ms.store.kv.write_txn()
            for k in keys:
                txn.delete_range(k)
            txn.end()
            ms.store.notify(txn.events)
            return len(keys)
        if kind == "lease_checkpoint":
            for lid, rem in req["checkpoints"]:
                ms.lessor.apply_checkpoint(lid, rem)
            return True
        if kind == "alarm":
            if req["action"] == "activate":
                ms.alarms.add(req["alarm"])
            else:
                ms.alarms.discard(req["alarm"])
            return sorted(ms.alarms)
        if kind == "cluster_version_set":
            # ClusterVersionSetRequest apply (membership SetVersion):
            # every member adopts the leader-decided version
            ms.cluster_version = cluster_version_str(req["ver"])
            return ms.cluster_version
        if kind == "downgrade_info_set":
            # DowngradeInfoSetRequest apply (SetDowngradeInfo)
            ms.downgrade = DowngradeInfo(
                req.get("ver", ""), bool(req["enabled"])
            )
            return ms.downgrade.enabled
        if kind == "v2":
            return self._apply_v2(ms, req)
        if kind.startswith("auth_"):
            return self._apply_auth(ms, kind, req)
        raise ServerError(f"unknown request kind {kind}")

    def _apply_v2(self, ms: MemberState, req: dict):
        """applyV2Request (apply_v2.go:124-148): interpret a committed
        RequestV2 as a v2store call. TTLs arrive as absolute expirations
        stamped at propose time (RequestV2.Expiration) so every member's
        tree — including its TTL heap — is bit-identical."""
        st = ms.v2store
        method = req["method"]
        if method == "SYNC":  # pathless: just an expiry cutoff
            st.delete_expired_keys(req["time"])
            return None
        path = req["path"]
        exp = req.get("expiration")
        refresh = bool(req.get("refresh"))
        if method == "POST":
            return st.create(path, req.get("dir", False),
                             req.get("val", ""), unique=True,
                             expire_time=exp)
        if method == "PUT":
            pv, pi = req.get("prev_value", ""), req.get("prev_index", 0)
            pe = req.get("prev_exist")
            if pe is not None:
                if pe:
                    if pi == 0 and pv == "":
                        return st.update(path, req.get("val", ""),
                                         expire_time=exp, refresh=refresh)
                    return st.compare_and_swap(path, pv, pi,
                                              req.get("val", ""),
                                              expire_time=exp,
                                              refresh=refresh)
                return st.create(path, req.get("dir", False),
                                 req.get("val", ""), unique=False,
                                 expire_time=exp)
            if pi > 0 or pv != "":
                return st.compare_and_swap(path, pv, pi,
                                          req.get("val", ""),
                                          expire_time=exp, refresh=refresh)
            return st.set(path, req.get("dir", False), req.get("val", ""),
                          expire_time=exp, refresh=refresh)
        if method == "DELETE":
            pv, pi = req.get("prev_value", ""), req.get("prev_index", 0)
            if pi > 0 or pv != "":
                return st.compare_and_delete(path, pv, pi)
            return st.delete(path, req.get("dir", False),
                             req.get("recursive", False))
        if method == "QGET":
            return st.get(path, req.get("recursive", False),
                          req.get("sorted", False))
        raise ServerError(f"unknown v2 method {method}")

    def _check_quota(self, ms: MemberState) -> None:
        if "NOSPACE" in ms.alarms:
            raise ErrNoSpace()

    def _apply_put(self, ms: MemberState, req: dict):
        self._check_quota(ms)
        txn = ms.store.kv.write_txn()
        prev = None
        if req.get("prev_kv"):
            kvs, _, _ = ms.store.kv.range(req["key"])
            prev = kvs[0] if kvs else None
        lease = req.get("lease", 0)
        if lease:
            ms.lessor.attach(lease, req["key"])
        else:
            ms.lessor.detach(req["key"])
        rev = txn.put(req["key"], req["value"], lease)
        txn.end()
        ms.store.notify(txn.events)
        return {"rev": rev, "prev_kv": prev}

    def _apply_delete(self, ms: MemberState, req: dict):
        txn = ms.store.kv.write_txn()
        prev = []
        if req.get("prev_kv"):
            prev, _, _ = ms.store.kv.range(req["key"], req.get("range_end"))
        n = txn.delete_range(req["key"], req.get("range_end"))
        rev = txn.end()
        ms.store.notify(txn.events)
        for ev in txn.events:
            ms.lessor.detach(ev[1].key)
        return {"deleted": n, "rev": rev, "prev_kvs": prev}

    def _eval_compare(self, ms: MemberState, cmp: Compare) -> bool:
        kvs, _, _ = ms.store.kv.range(cmp.key)
        kv = kvs[0] if kvs else None
        if cmp.target == "value":
            actual = kv.value if kv else b""
        elif cmp.target == "version":
            actual = kv.version if kv else 0
        elif cmp.target == "create":
            actual = kv.create_revision if kv else 0
        elif cmp.target == "mod":
            actual = kv.mod_revision if kv else 0
        elif cmp.target == "lease":
            actual = kv.lease if kv else 0
        else:
            raise ServerError(f"bad compare target {cmp.target}")
        if cmp.result == "=":
            return actual == cmp.value
        if cmp.result == "!=":
            return actual != cmp.value
        if cmp.result == ">":
            return actual > cmp.value
        if cmp.result == "<":
            return actual < cmp.value
        raise ServerError(f"bad compare result {cmp.result}")

    def _apply_txn(self, ms: MemberState, req: dict):
        self._check_quota(ms)
        succeeded = all(self._eval_compare(ms, c) for c in req["compare"])
        ops: list[Op] = req["success"] if succeeded else req["failure"]
        txn = ms.store.kv.write_txn()
        results = []
        for op in ops:
            if op.type == "put":
                # lease bookkeeping identical to the standalone put path
                if op.lease:
                    ms.lessor.attach(op.lease, op.key)
                else:
                    ms.lessor.detach(op.key)
                results.append(("put", txn.put(op.key, op.value, op.lease)))
            elif op.type == "delete":
                n_before = len(txn.events)
                results.append(("delete", txn.delete_range(op.key, op.range_end)))
                for ev in txn.events[n_before:]:
                    ms.lessor.detach(ev[1].key)
            elif op.type == "range":
                if op.rev:
                    kvs, cnt, rv = ms.store.kv.range(
                        op.key, op.range_end, op.rev, op.limit, op.count_only
                    )
                else:
                    # mid-txn reads observe this txn's earlier writes
                    kvs, cnt, rv = txn.range(
                        op.key, op.range_end, op.limit, op.count_only
                    )
                results.append(("range", kvs, cnt))
            else:
                raise ServerError(f"bad txn op {op.type}")
        rev = txn.end()
        ms.store.notify(txn.events)
        return {"succeeded": succeeded, "responses": results, "rev": rev}

    def _apply_auth(self, ms: MemberState, kind: str, req: dict):
        a = ms.auth
        fn = {
            "auth_enable": lambda: a.auth_enable(),
            "auth_disable": lambda: a.auth_disable(),
            "auth_user_add": lambda: a.user_add(
                req["name"], no_password=req.get("no_password", False),
                salt=req.get("salt"), pw_hash=req.get("pw_hash"),
            ),
            "auth_user_delete": lambda: a.user_delete(req["name"]),
            "auth_user_change_password": lambda: a.user_change_password(
                req["name"], salt=req.get("salt"), pw_hash=req.get("pw_hash")
            ),
            "auth_user_grant_role": lambda: a.user_grant_role(
                req["name"], req["role"]
            ),
            "auth_user_revoke_role": lambda: a.user_revoke_role(
                req["name"], req["role"]
            ),
            "auth_role_add": lambda: a.role_add(req["name"]),
            "auth_role_delete": lambda: a.role_delete(req["name"]),
            "auth_role_grant_permission": lambda: a.role_grant_permission(
                req["role"], req["perm"]
            ),
            "auth_role_revoke_permission": lambda: a.role_revoke_permission(
                req["role"], req["key"], req.get("range_end")
            ),
        }.get(kind)
        if fn is None:
            raise ServerError(f"unknown auth request {kind}")
        fn()
        return True

    # ------------------------------------------------------- request routing
    # log-if-slower-than threshold for request traces (the
    # warningApplyDuration dump rule, v3_server.go:602-610), seconds
    TRACE_THRESHOLD_S = 0.5
    # per-entry apply threshold feeding etcd_server_slow_apply_total
    # (applyTook > warningApplyDuration, etcdserver/server.go)
    SLOW_APPLY_THRESHOLD_S = 0.1
    # read-index wait threshold feeding
    # etcd_server_slow_read_indexes_total (slowReadIndex,
    # v3_server.go linearizableReadLoop)
    SLOW_READ_INDEX_THRESHOLD_S = 0.5
    # how many completed request spans to keep for to_chrome_trace
    REQ_SPAN_CAP = 256

    def _record_span(self, trace) -> None:
        """Retire a finished Trace into the bounded span buffer that
        blackbox.to_chrome_trace exports (host-request tracks)."""
        if trace is None or trace.is_empty:
            return
        self.req_spans.append(trace.to_span())
        if len(self.req_spans) > self.REQ_SPAN_CAP:
            del self.req_spans[: len(self.req_spans) - self.REQ_SPAN_CAP]

    def _propose(self, req: dict, member: int | None = None,
                 trace=None) -> Any:
        """processInternalRaftRequestOnce (v3_server.go:643-704)."""
        from etcd_tpu_torch.utils.trace import Field, Trace

        if trace is None or trace.is_empty:
            trace = Trace(req.get("kind", "?"), Field("member", member))
        else:
            trace.add_field(Field("member", member))
        lead = self.ensure_leader()
        at = member if member is not None else lead
        # backpressure: commit-apply gap (v3_server.go:644-648)
        (commit,) = self._read("commit", m=at)
        gap = int(commit) - self.members[at].applied_index
        if gap > self.MAX_GAP:
            raise ErrTooManyRequests()
        word = self._next_word
        self._next_word += 1
        req["_serve_m"] = at
        self.requests[word] = req
        self.cl.propose(at, word, c=self.c)
        trace.step("proposed through raft", Field("word", word))
        serving = self.members[at]
        try:
            for _ in range(self.MAX_APPLY_WAIT_ROUNDS):
                self.step()
                if word in serving.results:
                    trace.step("applied; result ready")
                    res = serving.results.pop(word)
                    if isinstance(res, Exception):
                        raise res
                    if self.durable_proposes:
                        self.commit_backends()
                        trace.step("backends fsynced")
                    return res
            raise ErrTimeout(req["kind"])
        finally:
            trace.log_if_long(self.TRACE_THRESHOLD_S)
            self._record_span(trace)

    def _header(self, m: int) -> ResponseHeader:
        (term,) = self._read("term", m=m)
        return ResponseHeader(
            cluster_id=self.c,
            member_id=m,
            revision=self.members[m].store.kv.current_rev,
            raft_term=int(term),
        )

    # ------------------------------------------------------------- public KV
    def put(self, key: bytes, value: bytes, lease: int = 0,
            prev_kv: bool = False, token: str | None = None, trace=None):
        self._authz(token, key, None, write=True)
        res = self._propose(
            {"kind": "put", "key": key, "value": value, "lease": lease,
             "prev_kv": prev_kv}, trace=trace
        )
        self._maybe_raise_nospace()
        return res

    def delete_range(self, key: bytes, range_end: bytes | None = None,
                     prev_kv: bool = False, token: str | None = None,
                     trace=None):
        self._authz(token, key, range_end, write=True)
        return self._propose(
            {"kind": "delete_range", "key": key, "range_end": range_end,
             "prev_kv": prev_kv}, trace=trace
        )

    def txn(self, compare: list[Compare], success: list[Op],
            failure: list[Op] | None = None, token: str | None = None,
            trace=None):
        for cmp_ in compare:
            self._authz(token, cmp_.key, None, write=False)
        for op in success + (failure or []):
            self._authz(token, op.key, op.range_end, write=op.type != "range")
        return self._propose(
            {"kind": "txn", "compare": compare, "success": success,
             "failure": failure or []}, trace=trace
        )

    def range(self, key: bytes, range_end: bytes | None = None, rev: int = 0,
              limit: int = 0, serializable: bool = False, member: int | None = None,
              count_only: bool = False, token: str | None = None, trace=None):
        """Range: linearizable by default via ReadIndex barrier
        (v3_server.go:95-133,709)."""
        from etcd_tpu_torch.utils.trace import Field, Trace

        if trace is None or trace.is_empty:
            trace = Trace("range", Field("serializable", serializable))
        else:
            trace.add_field(Field("serializable", serializable))
        self._authz(token, key, range_end, write=False)
        m = member if member is not None else self.ensure_leader()
        if not serializable:
            self.linearizable_read_notify(m, trace=trace)
            trace.step("read index confirmed; applied caught up")
        kvs, count, used = self.members[m].store.kv.range(
            key, range_end, rev, limit, count_only
        )
        trace.step("range keys from mvcc", Field("count", count))
        trace.log_if_long(self.TRACE_THRESHOLD_S)
        self._record_span(trace)
        return {"kvs": kvs, "count": count, "rev": used,
                "header": self._header(m)}

    def compact(self, rev: int):
        return self._propose({"kind": "compact", "rev": rev})

    def linearizable_read_notify(self, member: int, trace=None) -> None:
        """linearizableReadLoop round (v3_server.go:709-879): ReadIndex, then
        wait until applied >= read index. A wait past
        SLOW_READ_INDEX_THRESHOLD_S (or a timeout) counts into
        etcd_server_slow_read_indexes_total, the reference's slowReadIndex
        signal."""
        t0 = time.perf_counter()

        def _settle(ok: bool) -> None:
            dt = time.perf_counter() - t0
            if not ok or dt > self.SLOW_READ_INDEX_THRESHOLD_S:
                self.slow_read_index_total += 1
                from etcd_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    "slow read index: member=%d waited %.3fs (%s)",
                    member, dt, "confirmed" if ok else "timed out")

        self.ensure_leader()
        ctx = self.cl.read_index(member, c=self.c)
        if trace is not None:
            trace.step("read index requested")
        for _ in range(self.MAX_APPLY_WAIT_ROUNDS):
            self.step()
            rs_ctx, rs_idx = self._read("rs_ctx", "rs_index", m=member)
            hits = np.nonzero(rs_ctx == ctx)[0]
            if hits.size:
                need = int(rs_idx[hits[0]])
                # consume the ReadStates queue (the app drains rd.ReadStates
                # every Ready, etcdserver/raft.go:192-200; leaving them would
                # fill the R-slot device ring and drop later reads)
                self.cl.set_node(
                    member, c=self.c,
                    rs_ctx=np.zeros_like(rs_ctx),
                    rs_index=np.zeros_like(rs_idx),
                    rs_count=0,
                )
                while self.members[member].applied_index < need:
                    self.step()
                _settle(True)
                return
        _settle(False)
        raise ErrTimeout("read index")

    # ---------------------------------------------------------------- leases
    def lease_grant(self, lease_id: int, ttl: int):
        lid, granted = self._propose(
            {"kind": "lease_grant", "id": lease_id, "ttl": ttl}
        )
        return {"id": lid, "ttl": granted}

    def lease_revoke(self, lease_id: int):
        return self._propose({"kind": "lease_revoke", "id": lease_id})

    def lease_keepalive(self, lease_id: int):
        """Primary lessor renews directly (leasehttp fronted in the ref);
        replicate a checkpoint so followers learn the new remaining TTL."""
        lead = self.ensure_leader()
        ttl = self.members[lead].lessor.renew(lease_id)
        self._propose(
            {"kind": "lease_checkpoint",
             "checkpoints": [(lease_id, ttl)]}
        )
        return {"id": lease_id, "ttl": ttl}

    def lease_time_to_live(self, lease_id: int):
        lead = self.ensure_leader()
        ttl, keys = self.members[lead].lessor.time_to_live(lease_id)
        return {"id": lease_id, "ttl": ttl, "keys": keys}

    def leases(self):
        lead = self.ensure_leader()
        return sorted(self.members[lead].lessor.leases)

    def _expire_leases(self) -> None:
        """Leader lessor's due leases become LeaseRevoke proposals
        (lessor.go runLoop -> server revoke)."""
        lead = self.leader()
        if lead == NONE_ID:
            return
        lessor = self.members[lead].lessor
        if not lessor.primary:
            # promotion follows raft leadership (lessor.go Promote)
            lessor.promote(extend=self.cl.cfg.election_tick)
            for m, ms in enumerate(self.members):
                if m != lead and ms.lessor.primary:
                    ms.lessor.demote()
        due = lessor.expired()
        for i, lid in enumerate(due):
            try:
                self._propose({"kind": "lease_revoke", "id": lid})
            except ErrLeaseNotFound:
                # the revoke raced an earlier one (double expiry across
                # ticks, or the previous leader's queued revoke landed
                # first): already gone is SUCCESS for the expiry loop,
                # like the reference's expired-lease retry loop treating
                # ErrLeaseNotFound as completed (etcdserver/server.go
                # revokeExpiredLeases)
                continue
            except ServerError:
                # retry this id and the rest next tick; their heap entries
                # were popped by expired()
                lessor.defer_expiry(due[i:])
                return

    # ----------------------------------------------------------------- watch
    def watch(self, member: int, key: bytes, range_end: bytes | None = None,
              start_rev: int = 0, prev_kv: bool = False,
              fragment: bool = False, progress_notify: bool = False,
              filters: tuple = ()):
        return self.members[member].store.watch(
            key, range_end, start_rev, prev_kv,
            fragment=fragment, progress_notify=progress_notify,
            filters=filters,
        )

    def watch_events(self, member: int, watch_id: int,
                     limit: int | None = None):
        self.members[member].store.sync_watchers()
        return self.members[member].store.take_events(watch_id, limit)

    def watch_pending(self, member: int, watch_id: int) -> int:
        return self.members[member].store.pending_events(watch_id)

    def watch_progress(self, member: int, watch_id: int | None = None):
        """WatchProgressRequest analog. Per-watcher (watch_id given):
        current revision only if that watcher is synced and drained, else
        None (mvcc watchStream.RequestProgress). Stream-level
        (watch_id=None): the bare current revision unconditionally — the
        reference's ProgressRequest path sends newResponseHeader(Rev())
        with WatchId -1 without any sync check (api/v3rpc/watch.go:339-345)
        and leaves interpretation to the client."""
        store = self.members[member].store
        if watch_id is not None:
            return store.progress(watch_id)
        return store.kv.current_rev

    def cancel_watch(self, member: int, watch_id: int) -> bool:
        return self.members[member].store.cancel(watch_id)

    # ------------------------------------------------------------ membership
    # ------------------------------------------------------------ v2 API
    # the v2 request front (v2_server.go): every mutation — and QGET, the
    # quorum read — is ordered through consensus; plain gets are served
    # from the serving member's applied tree (the v2 "serializable" read)

    def v2_request(self, method: str, path: str, *, val: str = "",
                   dir: bool = False, prev_value: str = "",
                   prev_index: int = 0, prev_exist: bool | None = None,
                   recursive: bool = False, sorted_: bool = False,
                   refresh: bool = False, ttl: int | None = None,
                   member: int | None = None):
        req: dict[str, Any] = {
            "kind": "v2", "method": method, "path": path, "val": val,
            "dir": dir, "prev_value": prev_value,
            "prev_index": prev_index, "prev_exist": prev_exist,
            "recursive": recursive, "sorted": sorted_, "refresh": refresh,
        }
        if ttl is not None:
            # RequestV2.Expiration: absolute, stamped at propose time so
            # the apply is identical on every member (client.go:496-523)
            req["expiration"] = self.v2_now() + ttl
        return self._propose(req, member=member)

    def v2_get(self, path: str, recursive: bool = False,
               sorted_: bool = False, member: int | None = None):
        m = member if member is not None else self.ensure_leader()
        return self.members[m].v2store.get(path, recursive, sorted_)

    def v2_sync(self, member: int | None = None) -> None:
        """The SYNC proposal (etcdserver sync): the serving member's
        clock decides the expiry cutoff, consensus orders it, every
        member expires the same keys."""
        self._propose({"kind": "v2", "method": "SYNC",
                       "time": self.v2_now()}, member=member)

    def v2_watch(self, path: str, recursive: bool = False,
                 stream: bool = False, since_index: int = 0,
                 member: int | None = None):
        m = member if member is not None else self.ensure_leader()
        return self.members[m].v2store.watch(path, recursive, stream,
                                             since_index)

    def v2_stats(self, member: int | None = None) -> dict:
        m = member if member is not None else self.ensure_leader()
        return self.members[m].v2store.json_stats()

    def member_config(self) -> HostConfig:
        """Current config from the leader's applied masks."""
        lead = self.ensure_leader()
        cfg = HostConfig()
        v, vo, l, ln, auto_leave = self._read(
            "voters", "voters_out", "learners", "learners_next", "auto_leave",
            m=lead)
        cfg.voters = {i for i in range(self.M) if v[i]}
        cfg.voters_outgoing = {i for i in range(self.M) if vo[i]}
        cfg.learners = {i for i in range(self.M) if l[i]}
        cfg.learners_next = {i for i in range(self.M) if ln[i]}
        cfg.auto_leave = bool(auto_leave)
        cfg.progress = cfg.voters | cfg.voters_outgoing | cfg.learners
        cfg.progress_learner = set(cfg.learners)
        return cfg

    def _conf_change(self, ccs, validate) -> None:
        """mayAddMember-style guard (server.go:1293) then propose the
        encoded change and wait for it to apply on the leader."""
        lead = self.ensure_leader()
        validate(Changer(self.member_config()))  # raises ConfChangeError
        word = ccdev.encode(ccs)
        before = self.member_config()
        self.cl.propose_conf_change(lead, word, c=self.c)
        self.stabilize()
        self.stabilize()

    def member_add(self, member_id: int, learner: bool = False):
        from etcd_tpu_torch.types import CC_ADD_LEARNER, CC_ADD_NODE

        cfg = self.member_config()
        if member_id in cfg.progress:
            # membership.ErrIDExists (api/membership/cluster.go AddMember)
            raise ServerError(f"member {member_id} already exists")
        op = CC_ADD_LEARNER if learner else CC_ADD_NODE
        self._conf_change(
            [(op, member_id)],
            lambda ch: ch.simple([(op, member_id)]),
        )

    def member_remove(self, member_id: int):
        from etcd_tpu_torch.types import CC_REMOVE_NODE

        cfg = self.member_config()
        if member_id not in cfg.progress:
            # membership.ErrIDRemoved/NotFound (RemoveMember guards)
            raise ServerError(f"member {member_id} not found")
        # strict-reconfig-check analog (mayRemoveMember, server.go:1293):
        # refuse a removal that would leave no quorum of started members
        if member_id in cfg.voters and len(cfg.voters) - 1 < 1:
            raise ServerError("removing last voter would break the cluster")
        self._conf_change(
            [(CC_REMOVE_NODE, member_id)],
            lambda ch: ch.simple([(CC_REMOVE_NODE, member_id)]),
        )

    def member_promote(self, member_id: int):
        """PromoteMember with the readiness guard (server.go:1341,1445:
        learner must be within 90% of the leader's last index)."""
        from etcd_tpu_torch.types import CC_ADD_NODE

        lead = self.ensure_leader()
        match_row, last = self._read("match", "last_index", m=lead)
        match, last = int(match_row[member_id]), int(last)
        if last > 0 and match < last * 9 // 10:
            raise ServerError("learner is not ready to be promoted")
        self._conf_change(
            [(CC_ADD_NODE, member_id)],
            lambda ch: ch.simple([(CC_ADD_NODE, member_id)]),
        )

    # ------------------------------------------------------------------ auth
    def _authz(self, token, key, range_end, write):
        lead = self.leader()
        if lead == NONE_ID:
            return
        a = self.members[lead].auth
        if not a.enabled:
            return
        if token is None:
            raise ServerError("auth token required")
        a.check(token, key, range_end, write)

    def auth_request(self, kind: str, **kw):
        # Hash passwords once at propose time and replicate (salt, hash) in
        # the entry, like auth/store.go replicating the bcrypt hash inside
        # AuthUserAdd — apply stays deterministic across members and replays.
        if kind in ("auth_user_add", "auth_user_change_password"):
            import os as _os

            from etcd_tpu_torch.server.auth import _hash

            if not kw.get("no_password"):
                salt = _os.urandom(16)
                kw["salt"] = salt
                kw["pw_hash"] = _hash(kw.pop("password", ""), salt)
            else:
                # no_password users still need a deterministic (empty) salt,
                # or each member would roll its own urandom at apply time
                kw.pop("password", None)
                kw["salt"] = b""
                kw["pw_hash"] = b""
        return self._propose({"kind": kind, **kw})

    def authenticate(self, name: str, password: str) -> str:
        lead = self.ensure_leader()
        return self.members[lead].auth.authenticate(name, password)

    # ----------------------------------------------------------- maintenance
    # -- cluster version negotiation + downgrade (monitorVersions /
    # monitorDowngrade, server.go:2160-2280; Downgrade RPC,
    # v3_server.go:901-990) ------------------------------------------------
    def set_server_version(self, m: int, version: str) -> None:
        """Swap member m's binary version (mixed-version fleets / rolling
        up-/downgrades). Recorded in the override map so a later
        restart-from-disk boots the same \"binary\"."""
        self.server_versions[m] = version
        self.members[m].server_version = version

    def member_versions(self) -> dict[int, dict | None]:
        """Per-member {server, cluster} versions; None for unreachable
        (crashed) members — the cluster_util.go getVersions analog, read
        in-process instead of over peer HTTP."""
        return {
            m: (
                None
                if ms.crashed
                else {
                    "server": ms.server_version,
                    "cluster": ms.cluster_version or MIN_CLUSTER_VERSION,
                }
            )
            for m, ms in enumerate(self.members)
        }

    def cluster_version(self, member: int | None = None) -> str | None:
        """A member's applied view of the negotiated cluster version
        (EtcdServer.ClusterVersion)."""
        if member is None:
            member = self.leader()
            if member == NONE_ID or member < 0:
                member = 0
        return self.members[member].cluster_version

    def _version_monitor(self, lead: int) -> VersionMonitor:
        ec = self

        class _Adapter:
            def get_cluster_version(self):
                return ec.members[lead].cluster_version

            def get_downgrade_info(self):
                return ec.members[lead].downgrade

            def get_versions(self):
                return ec.member_versions()

            def update_cluster_version(self, ver: str):
                ec._propose(
                    {"kind": "cluster_version_set", "ver": ver}, member=lead
                )

            def downgrade_cancel(self):
                ec._propose(
                    {"kind": "downgrade_info_set", "enabled": False},
                    member=lead,
                )

        return VersionMonitor(_Adapter())

    def monitor_versions(self) -> str | None:
        """One leader monitor pass: decide min member version, propose a
        cluster-version bump through consensus when the change is valid.
        Returns the proposed version, or None. The embed tick loop calls
        this on the monitorVersionInterval; tests call it directly."""
        lead = self.leader()
        if lead == NONE_ID or lead < 0 or self.members[lead].crashed:
            return None
        return self._version_monitor(lead).update_cluster_version_if_needed()

    def monitor_downgrade(self) -> bool:
        """Cancel the live downgrade job once every member's cluster
        version reached the target (monitorDowngrade)."""
        lead = self.leader()
        if lead == NONE_ID or lead < 0 or self.members[lead].crashed:
            return False
        return self._version_monitor(lead).cancel_downgrade_if_needed()

    def downgrade(self, action: str, version: str | None = None,
                  member: int | None = None) -> dict:
        """Downgrade VALIDATE/ENABLE/CANCEL (v3_server.go:901-990)."""
        at = member if member is not None else self.ensure_leader()
        if action == "validate":
            self.linearizable_read_notify(at)
            cv = self.members[at].cluster_version
            if cv is None:
                raise ErrClusterVersionUnavailable()
            try:
                want = major_minor(version or "")
            except ValueError:
                raise ErrInvalidDowngradeTargetVersion()
            if want != major_minor(allowed_downgrade_version(cv)):
                raise ErrInvalidDowngradeTargetVersion()
            if self.members[at].downgrade.enabled:
                raise ErrDowngradeInProcess()
            return {"version": cv}
        if action == "enable":
            res = self.downgrade("validate", version, member=at)
            target = cluster_version_str(version or "")
            self._propose(
                {"kind": "downgrade_info_set", "enabled": True,
                 "ver": target},
                member=at,
            )
            # the version monitor will now lower the cluster version to
            # the target (is_valid_version_change accepts the one-minor
            # downgrade) as its next pass
            return {"version": res["version"]}
        if action == "cancel":
            self.linearizable_read_notify(at)
            if not self.members[at].downgrade.enabled:
                raise ErrNoInflightDowngrade()
            self._propose(
                {"kind": "downgrade_info_set", "enabled": False}, member=at
            )
            return {"version": self.members[at].cluster_version}
        raise ServerError(f"unknown downgrade action {action}")

    def status(self, member: int) -> dict:
        ms = self.members[member]
        term, last, learners = self._read("term", "last_index", "learners",
                                          m=member)
        return {
            "leader": self.leader(),
            "raft_term": int(term),
            "raft_index": int(last),
            "raft_applied_index": ms.applied_index,
            "db_size": ms.store.kv.size,
            "is_learner": bool(learners[member]),
            "alarms": sorted(ms.alarms),
            "version": ms.server_version,
            "cluster_version": ms.cluster_version,
            "downgrade": ms.downgrade.to_dict(),
        }

    def hash_kv(self, member: int, rev: int = 0) -> int:
        return self.members[member].store.kv.hash_kv(rev)

    def corruption_check(self) -> None:
        """Cross-member KV-hash comparison at a common revision
        (etcdserver/corrupt.go): members at the same applied index must have
        identical hashes."""
        by_applied: dict[int, set[int]] = {}
        for m, ms in enumerate(self.members):
            by_applied.setdefault(ms.applied_index, set()).add(
                ms.store.kv.hash_kv()
            )
        for applied, hashes in by_applied.items():
            if len(hashes) > 1:
                raise ErrCorrupt(f"applied={applied} hashes={hashes}")

    def alarm(self, action: str, alarm: str):
        return self._propose({"kind": "alarm", "action": action, "alarm": alarm})

    def _maybe_raise_nospace(self) -> None:
        if not self.quota_bytes:
            return
        lead = self.leader()
        if lead == NONE_ID:
            return
        ms = self.members[lead]
        if ms.store.kv.size > self.quota_bytes and "NOSPACE" not in ms.alarms:
            from etcd_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "quota exceeded (%d > %d bytes); raising NOSPACE alarm",
                ms.store.kv.size, self.quota_bytes,
            )
            self.alarm("activate", "NOSPACE")

    def snapshot(self, member: int) -> dict:
        """Maintenance.Snapshot analog: serialize the member's applied KV."""
        ms = self.members[member]
        return {
            "applied_index": ms.applied_index,
            "kv": ms.store.kv.to_snapshot(),
        }
