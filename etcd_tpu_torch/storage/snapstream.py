"""Streamed member-snapshot transfer — the merged-db snapshot channel.

Re-design of ``server/etcdserver/api/rafthttp/snapshot_sender.go`` +
``api/snap/message.go`` + ``api/snap/db.go``: the reference ships a
raft snapshot as a long-running side-channel POST whose body is the
snap message followed by the whole bbolt file, trailed by a size/CRC
check before the receiver renames it into place (db.go:52-79 writes
to a temp file and verifies). Here the member snapshot (MVCC + lease +
auth + v2 tree) streams as fixed-size chunks, each carrying its own
CRC32 and offset; the receiver verifies every chunk and the total
length before the snapshot becomes visible — a torn or corrupted
transfer never reaches ``restore_member``.

Chunks are plain dicts so any transport that moves JSON/pickle frames
(the gateway, a pipe, a file) can carry them.

The port's copy of etcd_tpu/storage/snapstream.py, which it imports nothing of.
"""
from __future__ import annotations

import pickle
import zlib
from typing import Iterator

DEFAULT_CHUNK = 64 * 1024  # snapshotSendBufSize-ish granularity


class SnapStreamError(Exception):
    """Chunk CRC/offset/length mismatch: the transfer is corrupt."""


def send_snapshot(snap: dict, chunk_size: int = DEFAULT_CHUNK
                  ) -> Iterator[dict]:
    """Serialize a member snapshot into self-verifying chunks.

    First frame is the header (total length + whole-payload CRC —
    the snap.Message size/CRC trailer moved up front); each following
    frame carries (seq, offset, data, crc)."""
    blob = pickle.dumps(snap, protocol=4)
    total_crc = zlib.crc32(blob)
    yield {"kind": "header", "total_len": len(blob),
           "total_crc": total_crc, "chunk_size": chunk_size}
    for seq, off in enumerate(range(0, len(blob), chunk_size)):
        data = blob[off:off + chunk_size]
        yield {"kind": "chunk", "seq": seq, "offset": off,
               "data": data, "crc": zlib.crc32(data)}


class SnapshotReceiver:
    """Reassemble and verify a chunk stream (snap/db.go SaveDBFrom:
    write to a staging buffer, verify, only then expose)."""

    def __init__(self):
        self._header: dict | None = None
        self._parts: list[bytes] = []
        self._next_seq = 0
        self._got = 0

    def feed(self, frame: dict) -> None:
        if frame["kind"] == "header":
            if self._header is not None:
                raise SnapStreamError("duplicate header")
            self._header = frame
            return
        if self._header is None:
            raise SnapStreamError("chunk before header")
        if frame["seq"] != self._next_seq:
            raise SnapStreamError(
                f"out-of-order chunk {frame['seq']} != {self._next_seq}")
        if frame["offset"] != self._got:
            raise SnapStreamError("offset mismatch")
        if zlib.crc32(frame["data"]) != frame["crc"]:
            raise SnapStreamError(f"chunk {frame['seq']} CRC mismatch")
        self._parts.append(frame["data"])
        self._got += len(frame["data"])
        self._next_seq += 1

    def close(self) -> dict:
        """Verify totals and yield the snapshot (the rename-into-place
        moment: nothing partial ever escapes)."""
        if self._header is None:
            raise SnapStreamError("no header received")
        if self._got != self._header["total_len"]:
            raise SnapStreamError(
                f"short transfer: {self._got}/{self._header['total_len']}")
        blob = b"".join(self._parts)
        if zlib.crc32(blob) != self._header["total_crc"]:
            raise SnapStreamError("total CRC mismatch")
        return pickle.loads(blob)


def transfer(snap: dict, chunk_size: int = DEFAULT_CHUNK,
             corrupt_frame: int | None = None) -> dict:
    """One in-process transfer: sender -> receiver, optionally flipping
    a byte of frame `corrupt_frame` (fault injection for tests and the
    chaos harness)."""
    rx = SnapshotReceiver()
    for i, frame in enumerate(send_snapshot(snap, chunk_size)):
        if corrupt_frame is not None and i == corrupt_frame \
                and frame["kind"] == "chunk" and frame["data"]:
            data = bytearray(frame["data"])
            data[0] ^= 0xFF
            frame = dict(frame, data=bytes(data))
        rx.feed(frame)
    return rx.close()
