"""Watch layer over the MVCC store (a copy of etcd_tpu/server/watch.py,
with ``events_from_delta`` reading the port's ``WatchDelta``).

Mirrors ``server/storage/mvcc/watchable_store.go``: watchers live in a
*synced* group (caught up; notified inline at write-txn end,
watchable_store_txn.go:22) or an *unsynced* group (start revision in the
past; drained by a catch-up pass reading history — syncWatchersLoop,
watchable_store.go:211,331). Slow receivers move to a *victims* list and are
retried (watchable_store.go:47-67). Range membership uses simple interval
checks (the reference's adt.IntervalTree in watcher_group.go:293 — at host
scale a linear scan over active watchers is the right-sized structure).
"""
from __future__ import annotations

import dataclasses

from etcd_tpu_torch.device_mvcc import scheme
from etcd_tpu_torch.server.mvcc import KeyValue, MVCCStore


@dataclasses.dataclass
class Event:
    """mvccpb.Event."""

    type: str  # "put" | "delete"
    kv: KeyValue
    prev_kv: KeyValue | None = None


def events_from_delta(delta, c: int) -> list:
    """Fan one group's device-extracted watch delta
    (etcd_tpu_torch/device_mvcc/apply.py extract_deltas) out as
    ``(type, KeyValue, prev_kv)`` tuples, the shape a host write txn's
    ``events`` list has, so ``WatchableStore.notify`` consumes the return
    value directly:

        ws.notify(events_from_delta(delta, c))

    Device deltas are revision-coalesced (one event per key per round,
    carrying the newest record; prev_kv is always None: history below the
    latest record does not exist on the device). One host read of the
    group's column."""
    mask = delta.mask[..., c]
    if not bool(mask.any()):
        return []
    cols = {k: getattr(delta, k)[..., c].tolist()
            for k in ("mask", "tomb", "mod", "create", "version", "vword", "lease")}
    out = []
    for kid, hit in enumerate(cols["mask"]):
        if not hit:
            continue
        if cols["tomb"][kid]:
            kv = KeyValue(scheme.key_bytes(kid), b"", 0, cols["mod"][kid], 0)
            out.append(("delete", kv, None))
        else:
            kv = KeyValue(
                scheme.key_bytes(kid), scheme.encode_value(cols["vword"][kid]),
                cols["create"][kid], cols["mod"][kid], cols["version"][kid],
                cols["lease"][kid],
            )
            out.append(("put", kv, None))
    return out


@dataclasses.dataclass
class Watcher:
    id: int
    key: bytes
    range_end: bytes | None
    start_rev: int  # next revision this watcher needs
    prev_kv: bool = False
    # fragment: client opted into split delivery of oversized event
    # batches (WatchCreateRequest.Fragment, api/v3rpc/watch.go:303-305)
    fragment: bool = False
    # progress_notify: client wants periodic empty revision headers when
    # idle (WatchCreateRequest.ProgressNotify, watch.go:296-298)
    progress_notify: bool = False
    # event-type filters (WatchCreateRequest.Filters NOPUT/NODELETE,
    # watch.go FiltersFromRequest:570-583); lowercase event type names
    filters: tuple = ()
    buffer: list[Event] = dataclasses.field(default_factory=list)
    # victim: buffer overflowed; excluded from synced until retried
    victim: bool = False
    compacted: bool = False

    MAX_BUFFER = 1024  # chanBufLen analog (watcher.go)

    def matches(self, key: bytes) -> bool:
        if self.range_end is None:
            return key == self.key
        if self.range_end == b"\x00":
            return key >= self.key
        return self.key <= key < self.range_end

    def filtered(self, typ: str) -> bool:
        """True if events of this type are dropped for this watcher
        (filterNoPut/filterNoDelete, watch.go:565-568)."""
        return typ in self.filters


class WatchableStore:
    """One member's watchable MVCC store."""

    def __init__(self, store: MVCCStore | None = None):
        self.kv = store or MVCCStore()
        self.synced: dict[int, Watcher] = {}
        self.unsynced: dict[int, Watcher] = {}
        self._next_id = 1

    # -- watch lifecycle (watcher.go watchStream.Watch) ----------------------
    def watch(
        self,
        key: bytes,
        range_end: bytes | None = None,
        start_rev: int = 0,
        prev_kv: bool = False,
        watch_id: int = 0,
        fragment: bool = False,
        progress_notify: bool = False,
        filters: tuple = (),
    ) -> Watcher:
        if watch_id == 0:
            watch_id = self._next_id
        self._next_id = max(self._next_id, watch_id) + 1
        cur = self.kv.current_rev
        if start_rev == 0:
            start_rev = cur + 1
        w = Watcher(watch_id, key, range_end, start_rev, prev_kv,
                    fragment=fragment, progress_notify=progress_notify,
                    filters=tuple(filters))
        if start_rev > cur:
            self.synced[watch_id] = w  # watchable_store.go:47-63
        else:
            self.unsynced[watch_id] = w
        return w

    def cancel(self, watch_id: int) -> bool:
        return (
            self.synced.pop(watch_id, None) is not None
            or self.unsynced.pop(watch_id, None) is not None
        )

    def restore(self, store: MVCCStore) -> None:
        """Install a snapshot store (the applySnapshot path,
        server.go:925-1061: the state machine jumps to the snapshot and
        every watcher re-syncs from history). Watchers whose start_rev was
        compacted away are cancelled with `compacted` by the next
        sync_watchers pass."""
        self.kv = store
        cur = store.current_rev
        for wid, w in list(self.synced.items()):
            if w.start_rev <= cur:  # future-rev watchers stay synced
                del self.synced[wid]
                self.unsynced[wid] = w

    # -- write-path publication (watchable_store_txn.go:22) ------------------
    def notify(self, events: list[tuple[str, KeyValue, KeyValue | None]]):
        for typ, kv, prev in events:
            for w in self.synced.values():
                if w.victim or not w.matches(kv.key):
                    continue
                if w.filtered(typ):
                    # filtered events are consumed, not deferred: the
                    # watcher stays current past them
                    w.start_rev = kv.mod_revision + 1
                    continue
                if len(w.buffer) >= Watcher.MAX_BUFFER:
                    # slow watcher becomes a victim; it will be re-synced
                    # from history later (victims queue). The catch-up path
                    # replays whole revisions, so roll back to the start of
                    # this (possibly multi-op) revision and drop its
                    # already-buffered prefix — otherwise those events would
                    # be delivered twice (sync_watchers' split-at-main-
                    # revision rule, applied to the victim path).
                    w.victim = True
                    rev = kv.mod_revision
                    while w.buffer and w.buffer[-1].kv.mod_revision == rev:
                        w.buffer.pop()
                    w.start_rev = rev
                    continue
                w.buffer.append(
                    Event(typ, kv, prev if w.prev_kv else None)
                )
                w.start_rev = kv.mod_revision + 1

    def apply_txn_events(self, txn_events) -> None:
        self.notify(txn_events)

    # -- catch-up (syncWatchersLoop, watchable_store.go:211-331) -------------
    def sync_watchers(self, batch: int = 512) -> int:
        """One catch-up pass: move ready unsynced/victim watchers to synced,
        emitting their missed history. Returns number synced."""
        moved = 0
        # victims rejoin the unsynced path
        for wid, w in list(self.synced.items()):
            if w.victim:
                del self.synced[wid]
                self.unsynced[wid] = w
        cur = self.kv.current_rev
        for wid, w in list(self.unsynced.items()):
            if w.start_rev <= self.kv.compact_rev:
                w.compacted = True  # client must restart (ErrCompacted)
                del self.unsynced[wid]
                moved += 1
                continue
            evs = self._history(w, w.start_rev, cur)
            room = Watcher.MAX_BUFFER - len(w.buffer)
            if len(evs) > room:
                # split only at a main-revision boundary: a multi-op txn's
                # events share one mod_revision, and resuming mid-revision
                # would re-emit the already-buffered part of it
                split = room
                while (
                    split > 0
                    and evs[split].kv.mod_revision
                    == evs[split - 1].kv.mod_revision
                ):
                    split -= 1
                if split == 0:
                    continue  # no room for a whole revision yet
                w.buffer.extend(evs[:split])
                w.start_rev = evs[split].kv.mod_revision
                continue  # still unsynced
            w.buffer.extend(evs)
            w.start_rev = cur + 1
            w.victim = False
            del self.unsynced[wid]
            self.synced[wid] = w
            moved += 1
        return moved

    def _history(self, w: Watcher, lo: int, hi: int) -> list[Event]:
        """Events for w in revision range [lo, hi] from the rev-keyed store
        (the kvsToEvents read of the backend, watchable_store.go:331)."""
        out = []
        for (main, sub), (kv, tomb) in sorted(self.kv.revs.items()):
            if main < lo or main > hi:
                continue
            if not w.matches(kv.key):
                continue
            typ = "delete" if tomb else "put"
            if w.filtered(typ):
                continue
            out.append(Event(typ, kv))
        return out

    # -- consumption (serverWatchStream sendLoop analog) ---------------------
    def take_events(self, watch_id: int, limit: int | None = None) -> list[Event]:
        """Drain up to `limit` buffered events (all if None). A fragmenting
        consumer passes a limit and re-polls; the remainder stays queued."""
        w = self.synced.get(watch_id) or self.unsynced.get(watch_id)
        if w is None:
            return []
        if limit is None or len(w.buffer) <= limit:
            evs, w.buffer = w.buffer, []
        else:
            evs, w.buffer = w.buffer[:limit], w.buffer[limit:]
        return evs

    def pending_events(self, watch_id: int) -> int:
        w = self.synced.get(watch_id) or self.unsynced.get(watch_id)
        return 0 if w is None else len(w.buffer)

    def get_watcher(self, watch_id: int) -> Watcher | None:
        return self.synced.get(watch_id) or self.unsynced.get(watch_id)

    def progress(self, watch_id: int) -> int | None:
        """Revision header for a progress notification: only a synced,
        fully-drained watcher may report progress (mvcc watchStream.
        RequestProgress: progress is sent iff the watcher is synced —
        otherwise the header would claim delivery through a revision whose
        events are still queued)."""
        w = self.synced.get(watch_id)
        if w is None or w.buffer or w.victim:
            return None
        return self.kv.current_rev
