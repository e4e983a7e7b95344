"""Cluster version negotiation + downgrade machinery.

Host-side control plane, redesigned from the reference's:
  * server/etcdserver/version/monitor.go — Monitor (UpdateClusterVersionIfNeeded,
    CancelDowngradeIfNeeded, decideClusterVersion, versionsMatchTarget)
  * server/etcdserver/api/membership/downgrade.go — DowngradeInfo,
    isValidDowngrade, mustDetectDowngrade, AllowedDowngradeVersion
  * server/etcdserver/api/membership/cluster.go:709-724 — IsValidVersionChange
  * server/etcdserver/v3_server.go:901-990 — Downgrade VALIDATE/ENABLE/CANCEL

The decided cluster version and the downgrade record are REPLICATED state:
the leader proposes them through consensus ("cluster_version_set" /
"downgrade_info_set" request kinds, the ClusterVersionSetRequest /
DowngradeInfoSetRequest analogs) and every member applies them to its
MemberState, so mixed-version behavior survives crash/restart via the
applied_meta record. Only parsing/compare logic lives here; proposal and
apply live in kvserver.py.

The port's copy of etcd_tpu/server/version.py, which it imports nothing of.
"""
from __future__ import annotations

import dataclasses

# The local build's server version (version.Version analog). v3rpc's
# /version reports this as "etcdserver" and the negotiated cluster
# version as "etcdcluster".
SERVER_VERSION = "3.6.0-tpu.4"
# version.MinClusterVersion: the version a cluster starts at while member
# versions are still unknown.
MIN_CLUSTER_VERSION = "3.0.0"


def parse(v: str) -> tuple[int, int, int]:
    """\"major.minor.patch[-extra]\" -> (major, minor, patch). Raises
    ValueError on garbage (semver.NewVersion analog, no dependency)."""
    core = v.split("-", 1)[0].split("+", 1)[0]
    parts = core.split(".")
    if len(parts) != 3:
        raise ValueError(f"invalid semver {v!r}")
    return tuple(int(p) for p in parts)  # type: ignore[return-value]


def fmt(t: tuple[int, int, int]) -> str:
    return f"{t[0]}.{t[1]}.{t[2]}"


def major_minor(v: str) -> tuple[int, int, int]:
    """Truncate to major.minor (cluster versions always carry patch 0 —
    version.Cluster analog)."""
    ma, mi, _ = parse(v)
    return (ma, mi, 0)


def cluster_version_str(v: str) -> str:
    return fmt(major_minor(v))


@dataclasses.dataclass
class DowngradeInfo:
    """membership.DowngradeInfo: target version while a downgrade job is
    live; enabled=False <=> target_version == \"\"."""

    target_version: str = ""
    enabled: bool = False

    def to_dict(self) -> dict:
        return {"target-version": self.target_version, "enabled": self.enabled}

    @classmethod
    def from_dict(cls, d: dict | None) -> "DowngradeInfo":
        if not d:
            return cls()
        return cls(d.get("target-version", ""), bool(d.get("enabled", False)))


def allowed_downgrade_version(ver: str) -> str:
    """One minor below (AllowedDowngradeVersion, downgrade.go:77-80)."""
    ma, mi, _ = major_minor(ver)
    return fmt((ma, mi - 1, 0))


def is_valid_downgrade(ver_from: str, ver_to: str) -> bool:
    ma, mi, _ = major_minor(ver_from)
    if mi < 1:
        return False  # x.0 has no one-minor-down target
    return major_minor(ver_to) == (ma, mi - 1, 0)


def is_valid_version_change(cluster_ver: str, new_ver: str) -> bool:
    """IsValidVersionChange (cluster.go:709-724): the cluster version may
    move DOWN by exactly one minor (a live downgrade) or UP toward the
    min member version (normal negotiation at cluster start/upgrade)."""
    cv, nv = major_minor(cluster_ver), major_minor(new_ver)
    if is_valid_downgrade(fmt(cv), fmt(nv)):
        return True
    return cv[0] == nv[0] and cv < nv


class InvalidDowngrade(Exception):
    """mustDetectDowngrade's Fatal, surfaced as an exception: the member
    process must refuse to serve (downgrade.go:41-75)."""


def detect_downgrade(server_ver: str, cluster_ver: str | None,
                     d: DowngradeInfo | None) -> None:
    """Run at member boot/restart (mustDetectDowngrade): with a downgrade
    job live only target-version servers may join; without one a server
    older than the cluster version may not."""
    lv = major_minor(server_ver)
    if d is not None and d.enabled and d.target_version:
        if lv == major_minor(d.target_version):
            return
        raise InvalidDowngrade(
            f"server {server_ver} is not allowed to join while the cluster "
            f"downgrades to {d.target_version}"
        )
    if cluster_ver is not None and lv < major_minor(cluster_ver):
        raise InvalidDowngrade(
            f"server version {server_ver} is lower than the determined "
            f"cluster version {cluster_ver}"
        )


class VersionMonitor:
    """Leader-side monitor (monitor.go). ``server`` duck-types:
    get_cluster_version() -> str|None, get_downgrade_info() -> DowngradeInfo,
    get_versions() -> dict[member, {"server": str, "cluster": str}|None],
    update_cluster_version(str), downgrade_cancel(). The host driver calls
    update_cluster_version_if_needed()/cancel_downgrade_if_needed() on its
    monitor interval (the monitorVersions/monitorDowngrade goroutines'
    synchronous analog)."""

    def __init__(self, server):
        self.s = server

    def decide_cluster_version(self) -> str | None:
        """Min member server version, or None while any member's version
        is unknown (decideClusterVersion, monitor.go:91-126)."""
        vers = self.s.get_versions()
        cv: tuple[int, int, int] | None = None
        for _, ver in sorted(vers.items()):
            if ver is None:
                return None
            try:
                v = parse(ver["server"])
            except (ValueError, KeyError):
                return None
            if cv is None or v < cv:
                cv = v
        return fmt(cv) if cv is not None else None

    def update_cluster_version_if_needed(self) -> str | None:
        """Returns the version string it decided to propose (or None)."""
        v = self.decide_cluster_version()
        if v is not None:
            v = fmt(major_minor(v))
        cur = self.s.get_cluster_version()
        if cur is None:
            target = v if v is not None else MIN_CLUSTER_VERSION
            self.s.update_cluster_version(target)
            return target
        if v is not None and is_valid_version_change(cur, v):
            self.s.update_cluster_version(v)
            return v
        return None

    def versions_match_target(self, target: str) -> bool:
        """All members' CLUSTER versions equal the target (monitor.go:
        130-160) — the signal that the downgrade job finished."""
        want = major_minor(target)
        for _, ver in self.s.get_versions().items():
            if ver is None:
                return False
            try:
                if major_minor(ver["cluster"]) != want:
                    return False
            except (ValueError, KeyError):
                return False
        return True

    def cancel_downgrade_if_needed(self) -> bool:
        d = self.s.get_downgrade_info()
        if not d.enabled:
            return False
        if self.versions_match_target(d.target_version):
            self.s.downgrade_cancel()
            return True
        return False
