"""Deterministic failpoints — the gofail analog (a copy of
etcd_tpu/utils/failpoints.py).

The reference compiles crash markers into the hot path
(`// gofail: var raftBeforeSave struct{}` at
server/etcdserver/raft.go:221,228,235,242,256,301, enabled by
FAILPOINTS=1 builds) and the functional tester trips them over HTTP
(tests/functional/tester/case_failpoints.go:207). Here a failpoint is a
named site in the host pipeline; enabling it with the "panic" action makes
the next passage raise :class:`FailpointPanic`, which tests treat as the
process dying at exactly that boundary. Activation comes from the
programmatic API or the ``ETCD_TPU_FAILPOINTS`` env var
(``name=panic;other=off`` — gofail's GOFAIL_FAILPOINTS wire format).

Registered sites (kvserver/backend analogs of the reference markers):
  raftBeforeSave      before the apply batch's MVCC delta hits the backend
  raftAfterSave       after the atomic applied-meta record is staged
  backendBeforeCommit before the backend's fsync'd batch commit
  backendAfterCommit  after it
  raftBeforeApplySnap before installing a peer state snapshot
  raftAfterApplySnap  after it
"""
from __future__ import annotations

import os
import threading


class FailpointPanic(Exception):
    """The 'process' died at a failpoint (gofail panic action)."""

    def __init__(self, name: str):
        super().__init__(f"failpoint {name} triggered")
        self.name = name


_lock = threading.Lock()
_active: dict[str, str] = {}
_hits: dict[str, int] = {}

KNOWN = (
    "raftBeforeSave",
    "raftAfterSave",
    "backendBeforeCommit",
    "backendAfterCommit",
    "raftBeforeApplySnap",
    "raftAfterApplySnap",
)


def _load_env() -> None:
    spec = os.environ.get("ETCD_TPU_FAILPOINTS", "")
    for part in spec.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, action = part.split("=", 1)
        if action != "off":
            _active[name] = action


_load_env()


def enable(name: str, action: str = "panic", count: int = 0) -> None:
    """Arm a failpoint. `count` > 0 = trigger only on the count-th passage
    (gofail's `N*panic` terms collapse to this)."""
    with _lock:
        _active[name] = action
        _hits[name] = -(count - 1) if count > 0 else 0


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)
        _hits.pop(name, None)


def clear() -> None:
    with _lock:
        _active.clear()
        _hits.clear()


def enabled(name: str) -> bool:
    return name in _active


def fire(name: str) -> None:
    """Marker call placed at the instrumented site. No-op unless armed."""
    with _lock:
        action = _active.get(name)
        if action is None:
            return
        hits = _hits.get(name, 0) + 1
        _hits[name] = hits
        if hits <= 0:  # armed with a count that hasn't elapsed yet
            return
        if action == "panic":
            # one-shot, like a dead process: re-arm explicitly to fire again
            _active.pop(name, None)
            _hits.pop(name, None)
            raise FailpointPanic(name)
        # other actions (e.g. "sleep(...)"/"print") are accepted but inert
