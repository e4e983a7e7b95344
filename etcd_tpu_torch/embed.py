"""Process assembly: embed.Config + start_etcd.

The reference's ``embed`` package is the library form of the server
process: one Config struct carrying every flag (server/embed/config.go),
``StartEtcd(cfg)`` wiring listeners + EtcdServer + v3rpc together
(server/embed/etcd.go:104), and etcdmain as the CLI shell around it.

Here ``start_etcd(Config)`` boots the batched fleet (one simulated
multi-member cluster), serves the v3 JSON/HTTP API on the client URL,
and runs the tick loop (heartbeats, lease expiry, auto-compaction) on a
background thread — the process-level analog of raftNode's ticker +
the compactor + lessor runLoop goroutines.

The port's copy of etcd_tpu/embed.py. ``Config.device`` picks the device the
cluster's state lives on: ``None`` is the CUDA card (and raises without
one), ``"cpu"`` the plain PyTorch path. On a card each raft step is one
replay of the round's CUDA graph; the graph is captured by the first step,
inside ``Etcd`` before the gateway's and the ticker's threads start, and
every later step runs under the gateway's one lock (``V3Api.lock``), so no
thread touches the device while another replays.
"""
from __future__ import annotations

import dataclasses
import threading

from etcd_tpu_torch.server.compactor import Compactor
from etcd_tpu_torch.server.kvserver import EtcdCluster
from etcd_tpu_torch.server.v3rpc import V3Server


@dataclasses.dataclass
class Config:
    """The embed.Config analog (server/embed/config.go), trimmed to the
    knobs the TPU runtime honors."""

    name: str = "default"
    data_dir: str | None = None
    listen_client_host: str = "127.0.0.1"
    listen_client_port: int = 0  # 0 = ephemeral
    cluster_size: int = 3
    tick_ms: int = 100                  # --heartbeat-interval
    election_ticks: int = 10            # --election-timeout / tick
    quota_backend_bytes: int = 0        # --quota-backend-bytes
    auto_compaction_mode: str = "off"   # --auto-compaction-mode
    auto_compaction_retention: int = 0  # --auto-compaction-retention
    pre_vote: bool = True               # --pre-vote
    check_quorum: bool = True
    auto_tick: bool = True              # background ticker on/off
    # --auth-token (embed/config.go AuthToken): "simple" or
    # "jwt[,sign-method=HS256][,ttl=SECONDS]"; jwt needs auth_jwt_key
    # (the priv-key= file contents of the reference flag)
    auth_token: str = "simple"
    auth_jwt_key: bytes | None = None
    # --initial-cluster-state (config.go ClusterState): "new" boots a
    # fresh cluster; "existing" joins one that already has data
    initial_cluster_state: str = "new"
    # --force-new-cluster (config.go ForceNewCluster): disaster recovery —
    # restart from this data dir as a ONE-member cluster, discarding the
    # other members (bootstrap.go:327-341)
    force_new_cluster: bool = False
    # cluster-version monitor cadence in ticks (monitorVersionInterval =
    # 5s at the reference's 100ms tick, server.go:2160); 0 disables.
    # The manual tick() path (tests) leaves monitoring to explicit
    # monitor_versions() calls so tick counts stay deterministic.
    monitor_version_ticks: int = 50
    # Transport security (embed/config.go ClientTLSInfo + ClientAutoTLS).
    # client_tls serves the gateway over HTTPS; client_auto_tls
    # generates a self-signed cert under data_dir/fixtures/client
    # (config.go:677 self-signed path). The reference's PeerTLSInfo has
    # NO analog on purpose: member-to-member consensus inside one fleet
    # is an on-device tensor exchange — there is no peer socket to
    # encrypt, and offering a knob that protects nothing would mislead.
    client_tls: "object | None" = None   # transport.TLSInfo
    client_auto_tls: bool = False
    # --unsafe-no-fsync (embed/config.go UnsafeNoFsync): skip the
    # fsync-before-ack durability barrier. Faster, loses acknowledged
    # writes on kill -9.
    unsafe_no_fsync: bool = False
    # --metrics extensive analog: attach the fleet telemetry plane
    # (models/telemetry.py) so /metrics serves latency-histogram
    # families (commit latency, election duration) beside the gauges.
    # One extra small fused dispatch per raft step.
    telemetry: bool = False
    # black-box event ring (models/blackbox.py): per-round packed event
    # words per member, exportable with the host request spans as a
    # Chrome/Perfetto trace (blackbox.to_chrome_trace). Same
    # one-extra-dispatch cost profile as telemetry.
    blackbox: bool = False
    # where the cluster's state lives: None = the CUDA card (raises when
    # there is none), "cpu" = the plain PyTorch path
    device: str | None = None

    def validate(self) -> None:
        if self.cluster_size < 1:
            raise ValueError("cluster size must be >= 1")
        if self.tick_ms <= 0:
            raise ValueError("tick interval must be positive")
        if self.auto_compaction_mode not in ("off", "periodic", "revision"):
            raise ValueError(
                f"unknown auto-compaction mode {self.auto_compaction_mode}"
            )
        if self.auth_token.split(",")[0] not in ("simple", "jwt"):
            raise ValueError(f"unknown auth token provider {self.auth_token}")
        if self.auth_token.split(",")[0] == "jwt" and not self.auth_jwt_key:
            raise ValueError("auth_token=jwt requires auth_jwt_key")
        if self.initial_cluster_state not in ("new", "existing"):
            raise ValueError(
                "initial cluster state must be 'new' or 'existing', got "
                f"{self.initial_cluster_state!r}"
            )
        if self.force_new_cluster and not self.data_dir:
            raise ValueError("force_new_cluster requires a data_dir")
        if self.client_tls is not None and self.client_auto_tls:
            raise ValueError(
                "client_tls and client_auto_tls are mutually exclusive")
        if self.client_auto_tls and not self.data_dir:
            # the self-signed keypair lives under data_dir/fixtures
            # like the reference's auto-TLS (embed/config.go:677)
            raise ValueError("auto TLS requires a data_dir")


class Etcd:
    """A running embedded server (embed.Etcd analog)."""

    def __init__(self, cfg: Config):
        cfg.validate()
        self.config = cfg
        from etcd_tpu_torch.utils.config import RaftConfig

        raft_cfg = RaftConfig(
            election_tick=max(cfg.election_ticks, 2),
            heartbeat_tick=1,
            pre_vote=cfg.pre_vote,
            check_quorum=cfg.check_quorum,
        )
        self.server = self._bootstrap(cfg, raft_cfg)
        self.server.ensure_leader()
        self.compactor = Compactor(
            self.server, cfg.auto_compaction_mode,
            cfg.auto_compaction_retention,
        )
        self.client_tls = self._resolve_tls(cfg)
        self.http = V3Server(
            self.server, cfg.listen_client_host, cfg.listen_client_port,
            tls_info=self.client_tls,
        ).start()
        # contention detector over the tick cadence (pkg/contention armed
        # at 2x the interval, etcdserver/raft.go:133)
        from etcd_tpu_torch.utils.contention import TimeoutDetector

        self.contention = TimeoutDetector(2 * cfg.tick_ms / 1000.0)
        self.server.contention = self.contention
        self._stop = threading.Event()
        self._ticker: threading.Thread | None = None
        if cfg.auto_tick:
            self._ticker = threading.Thread(target=self._tick_loop,
                                            daemon=True)
            self._ticker.start()

    @staticmethod
    def _resolve_tls(cfg: Config):
        """ClientTLSInfo resolution incl. the auto-TLS self-signed path
        (embed/config.go:677): the generated keypair lives under
        data_dir/fixtures/client and is reused across restarts."""
        import os

        from etcd_tpu_torch.transport import self_cert

        client = cfg.client_tls
        if client is None and cfg.client_auto_tls:
            hosts = [cfg.listen_client_host, "localhost", "127.0.0.1"]
            if cfg.listen_client_host in ("0.0.0.0", "::", ""):
                # a wildcard listen address is never what clients dial:
                # cover this machine's name + addresses in the SANs
                import socket

                name = socket.gethostname()
                hosts.append(name)
                try:
                    hosts.extend({ai[4][0] for ai in
                                  socket.getaddrinfo(name, None)})
                except OSError:
                    pass
            client = self_cert(
                os.path.join(cfg.data_dir, "fixtures", "client"), hosts)
        return client

    @staticmethod
    def _bootstrap(cfg: Config, raft_cfg) -> EtcdCluster:
        """The cold-start selection tree (bootstrap.go:51-99): data on
        disk (haveWAL) always wins and restarts the cluster from it;
        otherwise initial_cluster_state picks between bootstrapping a new
        cluster and joining an existing one.

        | disk state        | new            | existing               |
        |-------------------|----------------|------------------------|
        | no data_dir       | fresh (memory) | error: nothing to join |
        | empty dir         | fresh (wipes)  | error: nothing to join |
        | any member data   | restart from disk; absent members catch  |
        |                   | up from peers (missing_ok)               |
        | + force_new_...   | 1-member cluster from member 0's data    |
        """
        import os

        from etcd_tpu_torch.harness.cluster import Cluster
        from etcd_tpu_torch.utils.logging import get_logger

        kw = dict(
            quota_bytes=cfg.quota_backend_bytes,
            auth_token=cfg.auth_token,
            auth_jwt_key=cfg.auth_jwt_key,
            # a server process must not lose acknowledged writes to
            # kill -9 (--unsafe-no-fsync is the reference's opt-out)
            durable_proposes=not cfg.unsafe_no_fsync,
        )
        n = cfg.cluster_size
        have = [
            os.path.exists(EtcdCluster.member_db_path(cfg.data_dir, m))
            for m in range(n)
        ] if cfg.data_dir else []
        if any(have):
            # bootstrap.go:91 bootstrapWithWAL: on-disk state wins over
            # the initial-cluster-state flag
            if cfg.force_new_cluster:
                # recover from the first member whose data survived —
                # never silently start empty while peer data exists
                src = have.index(True)
                get_logger().warning(
                    "forcing new cluster from member %d of %s",
                    src, cfg.data_dir,
                )
                return EtcdCluster.boot_from_disk(
                    cfg.data_dir, n_members=1, members=[src],
                    cluster=Cluster(n_members=1, cfg=raft_cfg,
                        telemetry=cfg.telemetry,
                        blackbox=cfg.blackbox, device=cfg.device), **kw,
                )
            return EtcdCluster.boot_from_disk(
                cfg.data_dir, n_members=n, missing_ok=True, uniform=False,
                cluster=Cluster(n_members=n, cfg=raft_cfg,
                        telemetry=cfg.telemetry,
                        blackbox=cfg.blackbox, device=cfg.device), **kw,
            )
        if cfg.initial_cluster_state == "existing":
            # bootstrapExistingClusterNoWAL (bootstrap.go:182) fails the
            # same way when the named cluster cannot be reached
            raise ValueError(
                "initial_cluster_state='existing' but no member data "
                f"exists under {cfg.data_dir!r}; nothing to join"
            )
        return EtcdCluster(
            n_members=n,
            cluster=Cluster(n_members=n, cfg=raft_cfg,
                        telemetry=cfg.telemetry,
                        blackbox=cfg.blackbox, device=cfg.device),
            data_dir=cfg.data_dir,
            **kw,
        )

    @property
    def client_url(self) -> str:
        return (f"{self.http.scheme}://"
                f"{self.config.listen_client_host}:{self.http.port}")

    def _tick_loop(self) -> None:
        period = self.config.tick_ms / 1000.0
        # lease TTLs are seconds (lease/lessor.go): accumulate wall time
        # and advance the lease clock once per elapsed second, whatever
        # the raft tick rate (sub-second or multi-second) is
        owed = 0.0
        ticks = 0
        mon_every = self.config.monitor_version_ticks
        # v2 TTL expiry is driven by committed SYNC proposals (the
        # reference's syncer fires every 500ms, etcdserver/server.go);
        # without this, expired v2 keys stay visible forever on a
        # running server
        sync_every = max(1, round(0.5 / period))
        sync_failed = False
        while not self._stop.wait(period):
            owed += period
            advance = int(owed)
            owed -= advance
            ticks += 1
            on_time, exceed = self.contention.observe("tick")
            if not on_time:
                from etcd_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    "ticker took %.3fs longer than expected; host loop "
                    "contended (disk/CPU starvation)", exceed,
                )
            with self.http.api.lock:
                self.server.tick(lease_clock=advance >= 1)
                for _ in range(advance - 1):  # tick_ms > 1000: catch up
                    self.server.advance_lease_clock()
                self.compactor.tick()
                if ticks % sync_every == 0:
                    from etcd_tpu_torch.types import NONE_ID
                    from etcd_tpu_torch.utils.logging import get_logger

                    try:
                        # leader() is a pure probe: ensure_leader()'s
                        # forced ticks would fast-forward the lease
                        # clock during leaderless windows
                        lead = self.server.leader()
                        if lead != NONE_ID and self.server.members[lead] \
                                .v2store.has_ttl_keys():
                            self.server.v2_sync()
                        sync_failed = False
                    except Exception as e:
                        # lost leadership, backpressure, or an apply
                        # error — the next pass retries; NOTHING may
                        # escape and kill the ticker thread (raft
                        # ticks, lease clock and compaction all ride
                        # it). Say so once per failure streak.
                        if not sync_failed:
                            get_logger().warning(
                                "v2 SYNC proposal failed: %s", e)
                        sync_failed = True
                if mon_every and ticks % mon_every == 0:
                    # monitorVersions + monitorDowngrade passes (leader
                    # only; no-ops otherwise). Proposal failures (lost
                    # leadership mid-pass) are the next pass's problem.
                    try:
                        self.server.monitor_versions()
                        self.server.monitor_downgrade()
                    except Exception:
                        pass

    def tick(self, n: int = 1) -> None:
        """Manual clock (auto_tick=False mode, for tests): each call is
        one raft tick AND one lease-clock second."""
        with self.http.api.lock:
            for _ in range(n):
                self.server.tick()
                self.compactor.tick()

    def close(self) -> None:
        from etcd_tpu_torch.utils.logging import get_logger

        self._stop.set()
        if self._ticker:
            # the tick pass in flight ends before anything else here runs:
            # on a card a pass that proposes outlasts any fixed timeout, and
            # no step may run beside the drain below or a new Cluster's
            # graph capture
            self._ticker.join()
        self.http.stop()
        # a gateway request still in flight holds the lock until it ends
        with self.http.api.lock:
            try:
                # clean shutdown leaves every member at the committed front
                self.server.sync_for_shutdown()
            except Exception:
                pass  # crashy members can't block close
            for ms in self.server.members:
                if ms.backend is not None:
                    ms.backend.close()
        get_logger().info("etcd %r stopped", self.config.name)


def start_etcd(cfg: Config) -> Etcd:
    """embed.StartEtcd (server/embed/etcd.go:104)."""
    from etcd_tpu_torch.utils.logging import get_logger

    e = Etcd(cfg)
    get_logger().info(
        "etcd %r serving %d members at %s", cfg.name, cfg.cluster_size,
        e.client_url,
    )
    return e
