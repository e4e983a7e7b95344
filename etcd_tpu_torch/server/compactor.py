"""Auto-compaction: periodic and revision modes.

The reference's v3compactor (server/etcdserver/api/v3compactor) runs one
of two policies behind the ``--auto-compaction-mode`` flag:
  * periodic: every interval, compact to the revision observed one
    retention window ago (periodic.go's revolving sample wheel);
  * revision: every 5 minutes, compact to (current - retention)
    revisions (revision.go).

Here the compactor is tick-driven (the host tick loop is the clock) and
proposes the same replicated ``compact`` request a client would.

The port's copy of etcd_tpu/server/compactor.py, which it imports nothing of.
"""
from __future__ import annotations

from etcd_tpu_torch.server.kvserver import EtcdCluster, ServerError


class Compactor:
    def __init__(self, ec: EtcdCluster, mode: str = "off",
                 retention: int = 0, interval_ticks: int = 10):
        """mode: "off" | "periodic" (retention = ticks of history kept)
        | "revision" (retention = revisions kept)."""
        if mode not in ("off", "periodic", "revision"):
            raise ValueError(f"unknown auto-compaction mode {mode}")
        self.ec = ec
        self.mode = mode
        self.retention = retention
        self.interval = max(interval_ticks, 1)
        self._ticks = 0
        self._samples: list[tuple[int, int]] = []  # (tick, rev)
        self.last_compacted = 0

    def tick(self) -> None:
        if self.mode == "off" or self.retention <= 0:
            return
        self._ticks += 1
        if self._ticks % self.interval:
            return
        try:
            lead = self.ec.leader()
            if lead < 0:
                return
            rev = self.ec.members[lead].store.kv.current_rev
            if self.mode == "revision":
                target = rev - self.retention
            else:  # periodic: compact to the revision seen `retention`
                # ticks ago (the sample wheel)
                self._samples.append((self._ticks, rev))
                cutoff = self._ticks - self.retention
                old = [r for t, r in self._samples if t <= cutoff]
                self._samples = [
                    (t, r) for t, r in self._samples if t > cutoff
                ]
                target = old[-1] if old else 0
            if target > self.last_compacted:
                self.ec.compact(target)
                self.last_compacted = target
        except ServerError:
            pass  # no quorum right now; retry next interval
