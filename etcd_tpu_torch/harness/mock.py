"""Test doubles: the server/mock package analogs (etcd_tpu/harness/mock.py).

``RecordingStorage`` (mockstorage/storage_recorder.go) wraps a real
Storage, records every call as (action, args), and injects configured
errors — for driving RawNode/KVServer error paths deterministically.
``RecordingWait`` (mockwait/wait_recorder.go) does the same over
utils.wait.Wait. The v2-store mock (mockstore) has no analog because the
v2 API is deliberately omitted.
"""
from __future__ import annotations

from etcd_tpu_torch.storage.raftstorage import MemoryStorage, Storage
from etcd_tpu_torch.utils.wait import Wait


class RecordingStorage(Storage):
    """Wraps a Storage; records actions; raises injected failures.

    ``fail``: {method_name: exception} — the next call of that method
    raises the exception (one-shot, then cleared), modeling the
    reference's error-injecting storage doubles."""

    def __init__(self, inner: Storage | None = None):
        self.inner = inner or MemoryStorage()
        self.actions: list[tuple] = []
        self.fail: dict[str, Exception] = {}

    def _do(self, name: str, *args, **kw):
        self.actions.append((name,) + args)
        exc = self.fail.pop(name, None)
        if exc is not None:
            raise exc
        return getattr(self.inner, name)(*args, **kw)

    # -- Storage contract -------------------------------------------------
    def initial_state(self):
        return self._do("initial_state")

    def entries(self, lo, hi, max_entries=None):
        # forward the limit: a wrapped storage's size-limited reads must
        # behave identically under recording
        return self._do("entries", lo, hi, max_entries=max_entries)

    def term(self, i):
        return self._do("term", i)

    def first_index(self):
        return self._do("first_index")

    def last_index(self):
        return self._do("last_index")

    def snapshot(self):
        return self._do("snapshot")

    # -- MemoryStorage write surface (storage_recorder.go Save/SaveSnap) --
    def append(self, entries):
        return self._do("append", entries)

    def set_hard_state(self, hs):
        return self._do("set_hard_state", hs)

    def apply_snapshot(self, snap):
        return self._do("apply_snapshot", snap)

    def compact(self, index):
        return self._do("compact", index)

    def names(self) -> list[str]:
        """Recorded action names in order (testutil.Recorder.Wait analog)."""
        return [a[0] for a in self.actions]


class RecordingWait(Wait):
    """mockwait.WaitRecorder: record register/trigger traffic."""

    def __init__(self):
        super().__init__()
        self.actions: list[tuple] = []

    def register(self, id: int):
        self.actions.append(("Register", id))
        return super().register(id)

    def trigger(self, id: int, value) -> None:
        self.actions.append(("Trigger", id))
        super().trigger(id, value)
