"""Durable transactional backend — the bbolt analog
(etcd_tpu/storage/backend.py).

The reference keeps all applied state in a mmap'd copy-on-write B+tree
(go.etcd.io/bbolt) behind ``backend.Backend``/``BatchTx``/``ReadTx``
(server/storage/backend/backend.go:88-118): writes buffer in a batch
transaction flushed every batchInterval/batchLimit, reads see the
buffered view, and Defrag rewrites the file compactly.

The TPU-native host runtime wants the same durability contract with a
simpler mechanical design: a CRC-chained append-only record log (sharing
the WAL's frame codec, native/walcodec.cpp) replayed into an in-memory
bucket map on open. Appends are sequential (the fast path on any disk),
batch commits fsync, torn tails truncate at the first bad frame exactly
like WAL repair, and ``defrag()`` rewrites live records only. Batched
tail loss is safe by construction: the consistent-index record
(etcd_tpu_torch/storage/schema.py) tells the replay path where to resume, the
same WAL+backend recovery contract as the reference
(cindex/cindex.go:30-38).
"""
from __future__ import annotations

import os
import struct

from etcd_tpu_torch.storage.walcodec import get_codec

REC_PUT = 11
REC_DEL = 12

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")


def _enc_kvrec(bucket: str, key: bytes, value: bytes | None) -> bytes:
    b = bucket.encode()
    out = _U16.pack(len(b)) + b + _U32.pack(len(key)) + key
    if value is not None:
        out += value
    return out


def _dec_kvrec(payload: bytes) -> tuple[str, bytes, bytes]:
    (bl,) = _U16.unpack_from(payload, 0)
    bucket = payload[2 : 2 + bl].decode()
    off = 2 + bl
    (kl,) = _U32.unpack_from(payload, off)
    off += 4
    key = payload[off : off + kl]
    return bucket, key, payload[off + kl :]


class Backend:
    """Bucketed durable KV with batched transactional appends."""

    def __init__(self, path: str, batch_limit: int = 128,
                 fresh: bool = False):
        """fresh=True truncates any existing file — a NEW cluster
        incarnation must not inherit a previous incarnation's records
        (reopening is only for the restart-from-disk path)."""
        self.path = path
        self.batch_limit = batch_limit  # backend.go:106-108 defaultBatchLimit
        self.codec = get_codec()
        self.data: dict[str, dict[bytes, bytes]] = {}
        self._pending: list[bytes] = []
        self._pending_ops = 0
        self._crc = 0
        self._size_logical = 0
        if os.path.exists(path):
            if fresh:
                os.remove(path)
            else:
                self._replay()
        self._f = open(path, "ab")

    # -- recovery ------------------------------------------------------------
    def _replay(self) -> None:
        with open(self.path, "rb") as f:
            buf = memoryview(f.read())
        off, crc = 0, 0
        good = 0
        while True:
            out = self.codec.decode(buf, off, crc)
            if out is None:
                break
            consumed, rtype, payload, crc = out
            off += consumed
            if rtype == REC_PUT:
                bucket, key, value = _dec_kvrec(bytes(payload))
                self.data.setdefault(bucket, {})[key] = value
            elif rtype == REC_DEL:
                bucket, key, _ = _dec_kvrec(bytes(payload))
                self.data.get(bucket, {}).pop(key, None)
            good = off
        self._crc = crc
        if good < len(buf):  # torn tail: truncate at the last good frame
            with open(self.path, "r+b") as f:
                f.truncate(good)
        self._size_logical = good

    # -- batch tx (backend.go BatchTx) ---------------------------------------
    def put(self, bucket: str, key: bytes, value: bytes) -> None:
        self.data.setdefault(bucket, {})[key] = value
        self._append(REC_PUT, _enc_kvrec(bucket, key, value))

    def delete(self, bucket: str, key: bytes) -> None:
        if self.data.get(bucket, {}).pop(key, None) is not None:
            self._append(REC_DEL, _enc_kvrec(bucket, key, None))

    def _append(self, rtype: int, payload: bytes) -> None:
        frame, self._crc = self.codec.encode(rtype, payload, self._crc)
        self._pending.append(frame)
        self._pending_ops += 1
        if self._pending_ops >= self.batch_limit:
            self.commit()

    def commit(self) -> None:
        """Flush + fsync the batch (batchTxBuffered.commit)."""
        if not self._pending:
            return
        from etcd_tpu_torch.utils import failpoints

        # gofail beforeCommit/afterCommit analogs (backend/batch_tx.go's
        # commit path; tester/case_failpoints.go trips these mid-batch)
        failpoints.fire("backendBeforeCommit")
        blob = b"".join(self._pending)
        self._f.write(blob)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._size_logical += len(blob)
        self._pending = []
        self._pending_ops = 0
        failpoints.fire("backendAfterCommit")

    # -- reads (always see the buffered view, like txReadBuffer) -------------
    def get(self, bucket: str, key: bytes) -> bytes | None:
        return self.data.get(bucket, {}).get(key)

    def range(self, bucket: str, key: bytes = b"", range_end: bytes | None = None
              ) -> list[tuple[bytes, bytes]]:
        b = self.data.get(bucket, {})
        if range_end is None:
            v = b.get(key)
            return [(key, v)] if v is not None else []
        out = [
            (k, v) for k, v in b.items()
            if k >= key and (range_end == b"\x00" or k < range_end)
        ]
        return sorted(out)

    def buckets(self) -> list[str]:
        return sorted(self.data)

    # -- maintenance ----------------------------------------------------------
    def size(self) -> int:
        """Bytes in the file (grows with history until defrag)."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def size_in_use(self) -> int:
        """Bytes of live records (the defragmented size)."""
        total = 0
        for bucket, kvs in self.data.items():
            for k, v in kvs.items():
                total += len(bucket) + len(k) + len(v) + 17
        return total

    def defrag(self) -> None:
        """Rewrite only live records (backend.Defrag), atomically."""
        self.commit()
        self._f.close()
        tmp = self.path + ".defrag"
        crc = 0
        with open(tmp, "wb") as f:
            for bucket in sorted(self.data):
                for key in sorted(self.data[bucket]):
                    frame, crc = self.codec.encode(
                        REC_PUT,
                        _enc_kvrec(bucket, key, self.data[bucket][key]),
                        crc,
                    )
                    f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._crc = crc
        self._size_logical = os.path.getsize(self.path)
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self.commit()
        self._f.close()
