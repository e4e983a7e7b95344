"""Starvation / contention detector (pkg/contention/contention.go;
etcd_tpu/utils/contention.py).

The reference arms one around the leader's heartbeat sends
(etcdserver/raft.go:133: max = 2 x heartbeat interval; raft.go:357 observes
per-follower and warns "leader failed to send out heartbeat on time") —
late heartbeats mean the raft loop is starved by slow disk or an
overloaded scheduler. The TPU runtime's equivalent hot loop is the host
tick/pump cadence driving the device fleet: embed's ticker observes here
every tick, a late tick increments the counters surfaced in /metrics and
warns through the wired logger.
"""
from __future__ import annotations

import threading
import time


class TimeoutDetector:
    """Observes events that should recur within ``max_duration`` seconds;
    reports (on_time, exceeded_by_seconds) per observation."""

    def __init__(self, max_duration: float, clock=None):
        self.max_duration = max_duration
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._records: dict = {}
        # rollup for metrics/tests (the prometheus counter analog)
        self.late_total = 0
        self.max_exceeded = 0.0

    def reset(self) -> None:
        """Forget history — e.g. after a leadership change, when lateness
        blame does not carry over (raft.go:189)."""
        with self._lock:
            self._records.clear()

    def observe(self, which=0) -> tuple[bool, float]:
        now = self._clock()
        with self._lock:
            prev = self._records.get(which)
            self._records[which] = now
            if prev is None:
                return True, 0.0
            exceeded = (now - prev) - self.max_duration
            if exceeded > 0:
                self.late_total += 1
                self.max_exceeded = max(self.max_exceeded, exceeded)
                return False, exceeded
            return True, 0.0
