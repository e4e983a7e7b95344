"""pkg/wait parity: id-keyed and logical-deadline waiters
(etcd_tpu/utils/wait.py).

``Wait`` (pkg/wait/wait.go:31-41) matches apply results to the requests
blocked on them: Register(id) hands back a waiter, Trigger(id, value)
completes it. ``WaitTime`` (pkg/wait/wait_time.go:18-27) completes every
waiter at or before a triggered logical deadline — the v3 server uses it
for read-index waits keyed by applied index.

Channels become :class:`Waiter` objects (threading.Event + value):
``wait()`` blocks, ``done`` / ``value`` poll — both usable from the
synchronous test harness and the embed tick thread.
"""
from __future__ import annotations

import threading


class Waiter:
    __slots__ = ("_ev", "value")

    def __init__(self, done: bool = False):
        self._ev = threading.Event()
        self.value = None
        if done:
            self._ev.set()

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("waiter timed out")
        return self.value

    def _complete(self, value) -> None:
        self.value = value
        self._ev.set()


class Wait:
    """wait.New() (wait.go:52-60); the 64-way striping collapses — one
    dict + lock serves the in-process scale."""

    def __init__(self):
        self._l = threading.Lock()
        self._m: dict[int, Waiter] = {}

    def register(self, id: int) -> Waiter:
        with self._l:
            if id in self._m:
                raise ValueError(f"duplicate id {id:x}")
            w = self._m[id] = Waiter()
            return w

    def trigger(self, id: int, value) -> None:
        with self._l:
            w = self._m.pop(id, None)
        if w is not None:
            w._complete(value)

    def is_registered(self, id: int) -> bool:
        with self._l:
            return id in self._m


class WaitTime:
    """wait.NewTimeList() (wait_time.go:37-67): Wait(deadline) completes
    once Trigger is called with deadline >= it."""

    def __init__(self):
        self._l = threading.Lock()
        self._last = 0
        self._m: dict[int, Waiter] = {}

    def wait(self, deadline: int) -> Waiter:
        with self._l:
            if self._last >= deadline:
                return Waiter(done=True)
            w = self._m.get(deadline)
            if w is None:
                w = self._m[deadline] = Waiter()
            return w

    def trigger(self, deadline: int) -> None:
        with self._l:
            self._last = max(self._last, deadline)
            due = [d for d in self._m if d <= deadline]
            ws = [self._m.pop(d) for d in due]
        for w in ws:
            w._complete(None)
