"""Pluggable Storage contract + MemoryStorage (etcd_tpu/storage/raftstorage.py).

This is the host-side half of the seam the reference defines at
raft/storage.go:46-72 — the ``Storage`` interface (InitialState / Entries /
Term / LastIndex / FirstIndex / Snapshot) with its error taxonomy
(ErrCompacted / ErrUnavailable / ErrSnapshotTemporarilyUnavailable,
raft/storage.go:24-38) — plus the universal fake, ``MemoryStorage``
(raft/storage.go:76-273), which every reference test tier drives.

Design differences from the reference (deliberate, device-first):
  * Entries are fixed-width integer records (index, term, type, data word),
    matching the device log ring (etcd_tpu_torch/models/state.py log_term/
    log_data/log_type); arbitrary byte payloads live in a host-side intern
    table (:class:`PayloadTable`), the same payload-ref discipline the
    server layer uses. ``MaxSizePerMsg``-style limits therefore count
    entries, not bytes.
  * Member ids are 0-based; NONE_ID is -1 (see etcd_tpu_torch/types.py).
  * No mutex: the engine is single-threaded per group by construction
    (lockstep rounds), so MemoryStorage needs no locking discipline.
"""
from __future__ import annotations

import dataclasses

from etcd_tpu_torch.types import ENTRY_NORMAL, NONE_ID


class ErrCompacted(Exception):
    """Requested index predates the last snapshot (raft/storage.go:27)."""


class ErrSnapOutOfDate(Exception):
    """Snapshot request older than the existing one (raft/storage.go:30)."""


class ErrUnavailable(Exception):
    """Requested entry is not yet available (raft/storage.go:33)."""


class ErrSnapshotTemporarilyUnavailable(Exception):
    """Snapshot is being prepared; retry later (raft/storage.go:36)."""


@dataclasses.dataclass(frozen=True)
class Entry:
    """One log entry record (raftpb.Entry analog, raft.proto:69-79)."""

    index: int
    term: int
    type: int = ENTRY_NORMAL
    data: int = 0  # payload word (PayloadTable ref or conf-change word)


@dataclasses.dataclass
class HardState:
    """raftpb.HardState (raft.proto:102-106)."""

    term: int = 0
    vote: int = NONE_ID
    commit: int = 0

    def is_empty(self) -> bool:
        return self == HardState()


@dataclasses.dataclass
class ConfState:
    """raftpb.ConfState (raft.proto:115-130) as 0-based id lists."""

    voters: tuple[int, ...] = ()
    voters_outgoing: tuple[int, ...] = ()
    learners: tuple[int, ...] = ()
    learners_next: tuple[int, ...] = ()
    auto_leave: bool = False

    @staticmethod
    def from_masks(voters, voters_out, learners, learners_next, auto_leave):
        ids = lambda m: tuple(int(i) for i in range(len(m)) if m[i])
        return ConfState(
            ids(voters), ids(voters_out), ids(learners), ids(learners_next),
            bool(auto_leave),
        )

    def masks(self, m: int):
        import numpy as np

        def mk(ids):
            a = np.zeros((m,), bool)
            for i in ids:
                a[i] = True
            return a

        return (
            mk(self.voters), mk(self.voters_outgoing), mk(self.learners),
            mk(self.learners_next),
        )


@dataclasses.dataclass
class SnapshotMeta:
    index: int = 0
    term: int = 0
    conf_state: ConfState = dataclasses.field(default_factory=ConfState)
    app_hash: int = 0  # applied-state hash at `index` (KV_HASH analog)


@dataclasses.dataclass
class Snapshot:
    meta: SnapshotMeta = dataclasses.field(default_factory=SnapshotMeta)
    data: tuple[int, ...] = ()  # applied payload words (appender history)

    def is_empty(self) -> bool:
        return self.meta.index == 0


class Storage:
    """The pluggable persistence contract (raft/storage.go:46-72).

    Implementations: :class:`MemoryStorage` below (host lists) and
    ``DeviceLaneStorage`` (etcd_tpu_torch/models/rawnode.py), which reads one
    lane of the device fleet.
    """

    def initial_state(self) -> tuple[HardState, ConfState]:
        raise NotImplementedError

    def entries(self, lo: int, hi: int, max_entries: int | None = None) -> list[Entry]:
        """Entries [lo, hi). Raises ErrCompacted / ErrUnavailable."""
        raise NotImplementedError

    def term(self, i: int) -> int:
        raise NotImplementedError

    def first_index(self) -> int:
        raise NotImplementedError

    def last_index(self) -> int:
        raise NotImplementedError

    def snapshot(self) -> Snapshot:
        raise NotImplementedError


class MemoryStorage(Storage):
    """In-memory Storage (raft/storage.go:76-273), list-backed.

    The reference marks the log truncation point with a dummy zeroth
    entry, kept *separate* from the retained snapshot (Compact moves only
    the dummy; CreateSnapshot replaces only the snapshot). Here the dummy
    is the explicit ``(_offset, _offset_term)`` pair: ``ents`` holds
    exactly (_offset, last_index].
    """

    def __init__(self):
        self.hard_state = HardState()
        self.snap = Snapshot()
        self.ents: list[Entry] = []
        self._offset = 0
        self._offset_term = 0

    # -- Storage interface ---------------------------------------------------
    def initial_state(self):
        return self.hard_state, self.snap.meta.conf_state

    def first_index(self) -> int:
        return self._offset + 1

    def last_index(self) -> int:
        return self._offset + len(self.ents)

    def entries(self, lo, hi, max_entries=None):
        if lo <= self._offset:
            raise ErrCompacted(lo)
        if hi > self.last_index() + 1:
            raise ErrUnavailable(hi)
        out = self.ents[lo - self._offset - 1 : hi - self._offset - 1]
        if max_entries is not None:
            out = out[:max_entries]
        return list(out)

    def term(self, i) -> int:
        if i < self._offset:
            raise ErrCompacted(i)
        if i == self._offset:
            return self._offset_term
        if i > self.last_index():
            raise ErrUnavailable(i)
        return self.ents[i - self._offset - 1].term

    def snapshot(self) -> Snapshot:
        return self.snap

    # -- mutators (raft/storage.go:170-273) ----------------------------------
    def set_hard_state(self, hs: HardState) -> None:
        self.hard_state = dataclasses.replace(hs)

    def apply_snapshot(self, snap: Snapshot) -> None:
        if snap.meta.index <= self.snap.meta.index:
            raise ErrSnapOutOfDate(snap.meta.index)
        self.snap = snap
        self.ents = []
        self._offset = snap.meta.index
        self._offset_term = snap.meta.term

    def create_snapshot(self, i: int, cs: ConfState | None, data=(),
                        app_hash: int = 0) -> Snapshot:
        """Make (and retain) a snapshot at applied index i
        (raft/storage.go:180-205). Does NOT move first_index."""
        if i <= self.snap.meta.index:
            raise ErrSnapOutOfDate(i)
        if i > self.last_index():
            raise ErrUnavailable(i)
        cs = cs if cs is not None else self.snap.meta.conf_state
        self.snap = Snapshot(
            meta=SnapshotMeta(index=i, term=self.term(i), conf_state=cs,
                              app_hash=app_hash),
            data=tuple(data),
        )
        return self.snap

    def compact(self, compact_index: int) -> None:
        """Discard entries <= compact_index (raft/storage.go:208-233).
        Moves first_index; the retained snapshot is untouched."""
        if compact_index <= self._offset:
            raise ErrCompacted(compact_index)
        if compact_index > self.last_index():
            raise ErrUnavailable(compact_index)
        term = self.term(compact_index)
        self.ents = self.ents[compact_index - self._offset :]
        self._offset = compact_index
        self._offset_term = term

    def append(self, ents: list[Entry]) -> None:
        """Append with truncate-on-conflict (raft/storage.go:236-273)."""
        if not ents:
            return
        first, last = self.first_index(), ents[0].index + len(ents) - 1
        if last < first:
            return  # all compacted away
        if first > ents[0].index:
            ents = ents[first - ents[0].index :]
        pos = ents[0].index - self._offset - 1
        if pos > len(self.ents):
            raise ErrUnavailable(
                f"missing log entries [last: {self.last_index()}, "
                f"append at: {ents[0].index}]"
            )
        self.ents = self.ents[:pos] + list(ents)


def bootstrap_from_wal(wal) -> tuple["MemoryStorage", bytes]:
    """Crash–restart recovery: replay a WAL into a fresh MemoryStorage —
    the host-storage mirror of the chaos tier's on-device crash model
    (etcdserver/storage.go readWAL + raft restart path). ``wal`` is any
    object with the :meth:`etcd_tpu_torch.storage.wal.WAL.read_all` contract;
    read_all itself repairs a torn tail, so what arrives here is exactly
    the durable prefix.

    Validates the recovery invariant the device checkers enforce per
    round: the persisted HardState's commit must be covered by the
    surviving log (WAL.save writes a batch's entries BEFORE its
    hardstate record, so a prefix tear can drop a batch's hardstate but
    never keep a hardstate whose entries it dropped). A violation means
    the WAL bytes are inconsistent in a way repair cannot have
    produced — fail loudly rather than boot a node that breaks leader
    completeness. (Snapshot-vs-tail consistency needs no check:
    apply_snapshot resets the storage window to the snapshot cursor, so
    the replayed tail can never sit behind it.)

    Returns (storage, metadata).
    """
    from etcd_tpu_torch.storage.wal import WALError

    metadata, hs, ents, snap = wal.read_all()
    ms = MemoryStorage()
    # index 0 is the initial empty-snapshot marker some WALs open with;
    # a fresh MemoryStorage already sits at index 0 and apply_snapshot
    # would reject it as out of date
    if snap and snap["index"] > 0:
        ms.apply_snapshot(Snapshot(
            meta=SnapshotMeta(index=snap["index"], term=snap["term"]),
        ))
    if hs is not None:
        ms.set_hard_state(HardState(
            term=hs["term"], vote=hs["vote"], commit=hs["commit"],
        ))
    ms.append([
        Entry(index=e["index"], term=e["term"],
              type=e.get("type", ENTRY_NORMAL), data=e.get("data", 0))
        for e in ents
    ])
    if ms.hard_state.commit > ms.last_index():
        raise WALError(
            f"persisted commit {ms.hard_state.commit} exceeds the durable "
            f"log tail {ms.last_index()} — WAL bytes are inconsistent"
        )
    return ms, metadata


class PayloadTable:
    """Intern table mapping arbitrary payloads <-> int32 data words.

    The device log carries int32 payload refs; real bytes stay host-side —
    the same discipline the server layer's payload-ref table uses. Word 0
    is the empty payload.
    """

    def __init__(self):
        self._by_word: dict[int, bytes] = {0: b""}
        self._by_payload: dict[bytes, int] = {b"": 0}

    def intern(self, payload: bytes | str) -> int:
        if isinstance(payload, str):
            payload = payload.encode()
        w = self._by_payload.get(payload)
        if w is None:
            w = len(self._by_word)
            self._by_word[w] = payload
            self._by_payload[payload] = w
        return w

    def lookup(self, word: int) -> bytes:
        return self._by_word.get(int(word), b"")
