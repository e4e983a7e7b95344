"""Write-ahead log — segmented, CRC-chained, fsync-disciplined
(etcd_tpu/storage/wal.py; the same bytes on disk).

Mirrors ``server/storage/wal/wal.go``: append-only segments named
``<seq>-<index>.wal`` holding {metadata, entries, hardstate, snapshot-marker,
crc} records; ``Save`` appends entries+hardstate and fsyncs iff MustSync
(raft/node.go:586-593: vote/term changed or entries non-empty); ``cut`` at
the segment size limit; ``ReadAll`` replays from the last snapshot marker and
truncates a torn tail in place (wal/repair.go). Record payloads here are
pickled host dicts — the device engine's HardState/entry deltas — rather
than protobufs; the framing/CRC layer is walcodec (C++ with Python fallback).
"""
from __future__ import annotations

import os
import pickle

from etcd_tpu_torch.storage.walcodec import (
    HEADER_SIZE,
    first_frame_bytes_needed,
    frame_is_incomplete,
    get_codec,
    tail_chains_cleanly,
)

REC_METADATA = 1
REC_ENTRIES = 2
REC_HARDSTATE = 3
REC_SNAPSHOT = 4  # marker: {index, term} the log is valid from

SEGMENT_BYTES = 8 * 1024 * 1024  # wal.SegmentSizeBytes is 64MB; host-scale 8MB


class WALError(Exception):
    pass


class WAL:
    def __init__(self, dirpath: str, metadata: bytes = b""):
        self.dir = dirpath
        self.codec = get_codec()
        self.crc = 0
        self._f = None
        self.seq = 0
        self.enti = 0  # index of the last entry record appended
        self.metadata = metadata
        os.makedirs(dirpath, exist_ok=True)
        if not self._segments():
            self._cut_to(0, 0, metadata)
        else:
            # opening an existing log: replay to the tail so crc/enti/seq are
            # restored and the last segment is open for append — save()
            # before an explicit read_all() must not write blind (wal.go
            # Open reads to tail before the WAL is appendable)
            self.read_all()

    # -- segments ------------------------------------------------------------
    def _segments(self) -> list[str]:
        return sorted(
            f for f in os.listdir(self.dir) if f.endswith(".wal")
        )

    def _seg_path(self, seq: int, index: int) -> str:
        return os.path.join(self.dir, f"{seq:016x}-{index:016x}.wal")

    def _cut_to(self, seq: int, index: int, metadata: bytes = b"") -> None:
        if self._f:
            self.sync()
            self._f.close()
        self.seq = seq
        path = self._seg_path(seq, index)
        self._f = open(path, "ab")
        # each segment carries an independent crc chain starting at 0 so any
        # segment decodes standalone (the reference instead seeds with a
        # crcType record, wal.go cut; a per-segment chain is equivalent
        # tamper/tear protection with less special-casing)
        self.crc = 0
        if metadata:
            self._append(REC_METADATA, metadata)

    def _maybe_cut(self) -> None:
        if self._f.tell() >= SEGMENT_BYTES:
            # every segment re-carries the metadata record so any suffix of
            # segments replays standalone (wal.go cut writes metadata into
            # each new file)
            self._cut_to(self.seq + 1, self.enti + 1, self.metadata)

    # -- append --------------------------------------------------------------
    def _append(self, rtype: int, payload: bytes) -> None:
        frame, self.crc = self.codec.encode(rtype, payload, self.crc)
        self._f.write(frame)

    def save(self, hardstate: dict | None, entries: list[dict]) -> None:
        """WAL.Save (wal/wal.go): entry records then the hardstate record,
        one fsync for the batch (MustSync rule)."""
        must_sync = bool(entries) or hardstate is not None
        for e in entries:
            self._append(REC_ENTRIES, pickle.dumps(e))
            self.enti = e["index"]
        if hardstate is not None:
            self._append(REC_HARDSTATE, pickle.dumps(hardstate))
        if must_sync:
            self.sync()
        self._maybe_cut()

    def save_snapshot(self, index: int, term: int) -> None:
        self._append(REC_SNAPSHOT, pickle.dumps({"index": index, "term": term}))
        self.sync()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f:
            self.sync()
            self._f.close()
            self._f = None

    # -- replay --------------------------------------------------------------
    def _probe_first_frame(self, seg: str) -> str:
        """Classify a segment by its FIRST frame (each segment carries an
        independent crc chain from 0, so frame one is self-checking; if
        it is broken, nothing after it can be verified either) without
        reading the whole file:

          * ``"valid"``: decodes cleanly — the segment holds records;
          * ``"corrupt"``: the frame is COMPLETE but its crc fails —
            bit rot on durable bytes, never a crash artifact;
          * ``"debris"``: no complete frame — a torn first append.
        """
        path = os.path.join(self.dir, seg)
        with open(path, "rb") as f:
            head = f.read(HEADER_SIZE)
            need = first_frame_bytes_needed(head)
            if need is None or need > os.path.getsize(path):
                return "debris"
            buf = head + f.read(need - len(head))
        if self.codec.decode(buf, 0, 0) is not None:
            return "valid"
        return "corrupt"

    def read_all(self, from_index: int = 0):
        """(metadata, hardstate, entries, snapshot) replay; truncates a torn
        or corrupted final record like wal.openAtTail+repair (repair.go)
        instead of raising. entries are those with
        index > max(from_index, last snapshot marker).

        A torn frame is tolerated at the tail of the LOG, not just the
        last file: a crash inside ``cut`` (or an fsync-lagged filesystem
        dropping a synced-late tail) can leave the torn record in the
        penultimate segment with nothing but unsynced debris after it.
        The repair truncates the torn tail and REMOVES the later
        record-free debris segments. Corruption followed by any segment
        with decodable records is genuinely mid-log and still fails
        loudly — patching it would make a silent hole."""
        metadata = b""
        hardstate: dict | None = None
        snapshot: dict | None = None
        by_index: dict[int, dict] = {}
        crc = 0
        torn = False
        segs = self._segments()
        for si, seg in enumerate(segs):
            if torn:
                break
            path = os.path.join(self.dir, seg)
            with open(path, "rb") as f:
                buf = f.read()
            off = 0
            crc = 0  # per-segment chain
            while off < len(buf):
                hit = self.codec.decode(buf, off, crc)
                if hit is None:
                    debris = segs[si + 1:]
                    probes = {s: self._probe_first_frame(s) for s in debris}
                    if "valid" in probes.values():
                        # records exist PAST the tear: this is mid-log
                        # corruption, not a torn tail; it must not be
                        # patched into a silent hole
                        raise WALError(f"corrupt record mid-log in {seg}")
                    if not frame_is_incomplete(buf, off):
                        # COMPLETE frame, bad crc. In a non-final
                        # segment the bytes were durable (cut() fsyncs
                        # a segment before opening the next), so this
                        # is bit rot, and repairing it would silently
                        # drop fsynced records. In the final segment
                        # the torn-append window CAN leave a junk tail
                        # that happens to parse as a complete frame —
                        # it is rot (refuse) only when what follows the
                        # frame is a self-consistent crc-chained record
                        # run to EOF, i.e. real records stand behind it.
                        end = off + first_frame_bytes_needed(
                            buf[off:off + HEADER_SIZE])
                        if debris or tail_chains_cleanly(buf, end):
                            raise WALError(
                                f"corrupt durable record in {seg} "
                                "(complete frame, crc mismatch)")
                    rotted = [s for s, p in probes.items() if p == "corrupt"]
                    if rotted:
                        # same rule for the segments we would unlink: a
                        # complete-but-crc-broken first frame is bit rot
                        # on durable bytes, not torn-append debris —
                        # removing it would silently delete records
                        raise WALError(
                            f"corrupt durable record in {rotted[0]} "
                            "(complete frame, crc mismatch)")
                    # torn tail: truncate in place, drop record-free
                    # debris segments, stop replay (repair.go)
                    from etcd_tpu_torch.utils.logging import get_logger

                    get_logger().warning(
                        "repaired torn wal tail in %s at offset %d", seg, off
                    )
                    if self._f and not self._f.closed:
                        # the open append handle may point at a debris
                        # segment about to be unlinked
                        self._f.close()
                        self._f = None
                    with open(path, "ab") as f:
                        f.truncate(off)
                    for s in debris:
                        get_logger().warning("dropping torn wal debris %s", s)
                        os.remove(os.path.join(self.dir, s))
                    torn = True
                    break
                consumed, rtype, payload, crc = hit
                off += consumed
                if rtype == REC_METADATA:
                    metadata = payload
                elif rtype == REC_ENTRIES:
                    e = pickle.loads(payload)
                    by_index[e["index"]] = e  # later write wins (truncate+append)
                    for stale in [i for i in by_index if i > e["index"]]:
                        del by_index[stale]
                elif rtype == REC_HARDSTATE:
                    hardstate = pickle.loads(payload)
                elif rtype == REC_SNAPSHOT:
                    snapshot = pickle.loads(payload)
        self.crc = crc
        start = max(
            from_index, snapshot["index"] if snapshot else 0
        )
        entries = [by_index[i] for i in sorted(by_index) if i > start]
        if metadata:
            self.metadata = metadata
        # reopen tail for appending
        if self._f is None or self._f.closed:
            segs = self._segments()
            self.seq = int(segs[-1].split("-")[0], 16)
            self._f = open(os.path.join(self.dir, segs[-1]), "ab")
        if by_index:
            self.enti = max(by_index)
        return metadata, hardstate, entries, snapshot

    def release_to(self, index: int) -> int:
        """Drop whole segments whose entries all precede `index`
        (WAL.ReleaseLockTo after a snapshot). Returns segments removed."""
        segs = self._segments()
        removed = 0
        # a segment is removable if the NEXT segment starts at or before index
        for i in range(len(segs) - 1):
            nxt_start = int(segs[i + 1].split("-")[1].split(".")[0], 16)
            if nxt_start <= index:
                os.remove(os.path.join(self.dir, segs[i]))
                removed += 1
            else:
                break
        return removed
