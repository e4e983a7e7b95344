"""WAL record codec binding: C++ fast path + pure-Python fallback
(etcd_tpu/storage/walcodec.py).

The framing matches native/walcodec.cpp (and mirrors the reference's
wal/encoder.go:124 record layout): ``u32 len | u8 type | u32 crc | payload |
pad8`` with a chained CRC32 so decode stops at the first torn/corrupt frame
(wal/repair.go behavior). ctypes over the source's C ABI is the bridge.

The port compiles the repo's ``native/walcodec.cpp`` with ``g++`` at first
use into ``etcd_tpu_torch/kernels/_build/walcodec_<key>.so`` (keyed by a hash
of the source bytes, the flags and the compiler's version; the directory is
not tracked), writing a temporary file and moving it into place, so that
processes building at once never load a half-written library. It writes
nothing under ``native/``. If the build or the load fails, the Python codec
(the same bytes) serves and the failure is logged; :func:`is_native` says
which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import zlib

_HEADER = struct.Struct("<IBI")  # len, type, crc

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "walcodec.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


HEADER_SIZE = _HEADER.size


def first_frame_bytes_needed(header: bytes) -> int | None:
    """Total on-disk size of a frame whose first ``HEADER_SIZE`` bytes are
    ``header`` (None if the header itself is short) — lets a caller probe
    a segment's first frame without reading the whole file."""
    if len(header) < _HEADER.size:
        return None
    return _HEADER.size + _pad8(_HEADER.unpack_from(header, 0)[0])


def tail_chains_cleanly(buf, off: int) -> bool:
    """Whether the bytes at ``off`` parse as one or more COMPLETE frames
    whose chained crcs are self-consistent (the first frame's stored crc
    taken as the chain seed — the chain up to here is broken, so it
    cannot be verified absolutely) and end exactly at EOF. That is the
    signature of real fsync'd records surviving PAST a corrupt frame
    (bit rot), as opposed to the unstructured junk a torn append leaves;
    a WAL reader uses it to keep mid-segment rot loud while still
    repairing a genuinely torn tail."""
    n = len(buf)
    if off >= n:
        return False
    crc = None
    while off < n:
        if n - off < _HEADER.size:
            return False
        plen, _, want = _HEADER.unpack_from(buf, off)
        total = _HEADER.size + _pad8(plen)
        if n - off < total:
            return False
        if crc is not None:
            payload = bytes(buf[off + _HEADER.size:off + _HEADER.size + plen])
            if zlib.crc32(payload, crc) != want:
                return False
        crc = want
        off += total
    return True


def frame_is_incomplete(buf, off: int) -> bool:
    """Whether the bytes at ``off`` cannot hold a complete frame — the
    buffer ends mid-record, the signature of a torn append (segments are
    plain appends, never preallocated, so a crash tears at EOF). A
    COMPLETE frame that fails its CRC is the other way decode returns
    None, and means bit rot on durable bytes, not a tear — a WAL reader
    uses the distinction to keep mid-log corruption loud.
    """
    remaining = len(buf) - off
    if remaining < _HEADER.size:
        return True
    plen = _HEADER.unpack_from(buf, off)[0]
    return remaining < _HEADER.size + _pad8(plen)


class _PyCodec:
    """Fallback codec (identical framing)."""

    @staticmethod
    def encode(rtype: int, payload: bytes, crc: int) -> tuple[bytes, int]:
        crc = zlib.crc32(payload, crc)
        frame = _HEADER.pack(len(payload), rtype, crc) + payload
        frame += b"\x00" * (_pad8(len(payload)) - len(payload))
        return frame, crc

    @staticmethod
    def decode(buf: memoryview, off: int, crc: int):
        """(consumed, rtype, payload, crc) or None on torn/corrupt frame."""
        if len(buf) - off < _HEADER.size:
            return None
        plen, rtype, want_crc = _HEADER.unpack_from(buf, off)
        total = _HEADER.size + _pad8(plen)
        if len(buf) - off < total:
            return None
        payload = bytes(buf[off + _HEADER.size : off + _HEADER.size + plen])
        crc = zlib.crc32(payload, crc)
        if crc != want_crc:
            return None
        return total, rtype, payload, crc


class _NativeCodec:
    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.wal_encode.restype = ctypes.c_uint64
        lib.wal_decode.restype = ctypes.c_uint64
        lib.wal_frame_size.restype = ctypes.c_uint64
        lib.wal_crc32.restype = ctypes.c_uint32

    def encode(self, rtype: int, payload: bytes, crc: int) -> tuple[bytes, int]:
        out = ctypes.create_string_buffer(
            int(self.lib.wal_frame_size(ctypes.c_uint64(len(payload))))
        )
        crc_io = ctypes.c_uint32(crc)
        n = self.lib.wal_encode(
            ctypes.c_uint8(rtype), payload, ctypes.c_uint64(len(payload)),
            ctypes.byref(crc_io), out,
        )
        return out.raw[: int(n)], crc_io.value

    def decode(self, buf, off: int, crc: int):
        """Zero-copy: pass base+off into the C ABI directly (a per-record
        bytes(buf[off:]) copy would make segment replay O(n^2))."""
        if not isinstance(buf, bytes):
            buf = bytes(buf)  # memoryview callers pay one conversion
        base = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
        crc_io = ctypes.c_uint32(crc)
        ty = ctypes.c_uint8()
        poff = ctypes.c_uint64()
        plen = ctypes.c_uint64()
        n = self.lib.wal_decode(
            ctypes.c_void_p(base + off), ctypes.c_uint64(len(buf) - off),
            ctypes.byref(crc_io), ctypes.byref(ty), ctypes.byref(poff),
            ctypes.byref(plen),
        )
        if n == 0:
            return None
        payload = buf[off + poff.value : off + poff.value + plen.value]
        return int(n), ty.value, payload, crc_io.value


def build() -> pathlib.Path:
    """Compile native/walcodec.cpp unless a library built from the same
    source bytes, flags and compiler exists; returns its path. Raises when
    the source or ``g++`` is missing or the compile fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("walcodec: g++ not found")
    if not SOURCE.exists():
        raise RuntimeError(f"walcodec: {SOURCE} not found")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update("\0".join(CXX_FLAGS + (version,)).encode())
    lib = BUILD_DIR / f"walcodec_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=120, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"walcodec: g++ failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _build_native():
    try:
        return _NativeCodec(ctypes.CDLL(str(build())))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        from etcd_tpu_torch.utils.logging import get_logger

        get_logger().warning("walcodec: the native codec is unavailable, the "
                             "Python codec serves (same bytes): %s", e)
        return None


_codec = None


def get_codec():
    global _codec
    if _codec is None:
        _codec = _build_native() or _PyCodec()
    return _codec


def is_native() -> bool:
    return isinstance(get_codec(), _NativeCodec)
