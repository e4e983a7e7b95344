"""The port's storage layer (etcd_tpu_torch/storage/{walcodec,backend,schema}.py)
against the reference's (etcd_tpu/storage/), on the CPU.

Both codecs frame, decode and find torn tails exactly as the reference's do
on seeded records (an empty and a 1 MiB payload among them); a ``Backend``
script writes the same file bytes in both packages, reads back the same
after a reopen, loses an uncommitted batch, truncates a torn tail and
defragments alike; a ``schema`` db written by either package loads in the
other to an equal store, and no record pickles a class of either package
(a record that did would import that package on load)."""
from __future__ import annotations

import os
import pickletools

import numpy as np
import pytest

from etcd_tpu.storage import backend as jbackend
from etcd_tpu.storage import schema as jschema
from etcd_tpu.storage import walcodec as jcodec
from etcd_tpu.server import auth as jauth, lease as jlease, mvcc as jmvcc
from etcd_tpu_torch.server import auth as tauth, lease as tlease, mvcc as tmvcc
from etcd_tpu_torch.storage import backend as tbackend
from etcd_tpu_torch.storage import schema as tschema
from etcd_tpu_torch.storage import walcodec as tcodec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records(seed: int):
    """(type, payload) pairs: an empty and a 1 MiB payload among seeded ones."""
    rng = np.random.default_rng(seed)
    out = [(3, b""), (7, rng.bytes(1 << 20))]
    for _ in range(40):
        out.append((int(rng.integers(0, 256)), rng.bytes(int(rng.integers(0, 300)))))
    rng.shuffle(out)
    return out


def frames(codec, recs):
    crc, out = 0, []
    for rtype, payload in recs:
        frame, crc = codec.encode(rtype, payload, crc)
        out.append(frame)
    return out


def codecs():
    out = [("python", tcodec._PyCodec())]
    native = tcodec._build_native()
    assert native is not None, "g++ builds native/walcodec.cpp here"
    return out + [("native", native)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["python", "native"])
def test_codec_encodes_and_decodes_as_the_reference(which, seed):
    codec = dict(codecs())[which]
    recs = records(seed)
    got, want = frames(codec, recs), frames(jcodec._PyCodec(), recs)
    assert got == want
    buf = b"".join(got)
    crc = off = 0
    for rtype, payload in recs:
        a = codec.decode(memoryview(buf), off, crc)
        b = jcodec._PyCodec().decode(memoryview(buf), off, crc)
        assert a is not None and bytes(a[2]) == payload and a[1] == rtype
        assert (a[0], a[1], bytes(a[2]), a[3]) == (b[0], b[1], bytes(b[2]), b[3])
        off, crc = off + a[0], a[3]
    assert off == len(buf)


@pytest.mark.parametrize("which", ["python", "native"])
def test_codec_finds_torn_tails_as_the_reference(which):
    codec = dict(codecs())[which]
    recs = records(2)[:8]
    buf = b"".join(frames(codec, recs))
    rng = np.random.default_rng(3)
    cuts = sorted(set(int(x) for x in rng.integers(0, len(buf), 40))) + [len(buf)]
    for cut in cuts:
        torn = buf[:cut]
        for off in (0, 9, len(frames(codec, recs[:1])[0])):
            if off > len(torn):
                continue
            assert tcodec.frame_is_incomplete(torn, off) == jcodec.frame_is_incomplete(torn, off)
            assert tcodec.tail_chains_cleanly(torn, off) == jcodec.tail_chains_cleanly(torn, off)
            assert tcodec.first_frame_bytes_needed(torn[off:off + 9]) == \
                jcodec.first_frame_bytes_needed(torn[off:off + 9])
            assert codec.decode(memoryview(torn), off, 0) == jcodec._PyCodec().decode(
                memoryview(torn), off, 0)
    # a flipped payload byte is a complete frame that fails its crc
    bad = bytearray(buf)
    bad[12] ^= 0xFF
    assert codec.decode(memoryview(bytes(bad)), 0, 0) is None
    assert not tcodec.frame_is_incomplete(bytes(bad), 0)


def test_native_codec_is_built_outside_the_source_tree(tmp_path, monkeypatch):
    """g++ writes the library into the port's build directory (not tracked),
    through a temporary name, and nothing under native/."""
    import pathlib
    import subprocess

    assert tcodec.BUILD_DIR == pathlib.Path(ROOT) / "etcd_tpu_torch" / "kernels" / "_build"
    assert tcodec.SOURCE == pathlib.Path(ROOT) / "native" / "walcodec.cpp"
    calls, real = [], subprocess.run

    def run(cmd, *a, **k):
        calls.append(list(cmd))
        return real(cmd, *a, **k)

    monkeypatch.setattr(tcodec.subprocess, "run", run)
    monkeypatch.setattr(tcodec, "BUILD_DIR", tmp_path / "_build")
    lib = tcodec.build()
    assert lib.parent == tmp_path / "_build" and lib.name.startswith("walcodec_")
    outs = [c[c.index("-o") + 1] for c in calls if "-o" in c]
    assert len(outs) == 1 and outs[0].startswith(str(tmp_path)) and outs[0].endswith(".tmp")
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    assert tcodec.build() == lib and len(calls) == 3      # reused: g++ --version only
    assert tcodec.is_native()


# -- Backend ------------------------------------------------------------------

def script_basic(be, mod):
    be.put("key", b"a", b"1")
    be.put("key", b"b", b"2")
    be.delete("key", b"a")
    be.delete("key", b"zz")             # absent: no record
    be.put("meta", b"m", b"x" * 300)
    be.commit()


def script_uncommitted(be, mod):
    be.put("key", b"a", b"1")
    be.commit()
    be.put("key", b"b", b"2")           # stays in the batch buffer
    be._f.close()                       # a crash: no commit


def script_torn(be, mod):
    be.put("key", b"a", b"1")
    be.put("key", b"b", b"2")
    be.close()
    with open(be.path, "ab") as f:      # a torn partial frame
        f.write(b"\x40\x00\x00\x00\x0bgarbage")


def script_defrag(be, mod):
    for i in range(40):
        be.put("key", b"k%02d" % (i % 5), b"v%d" % i)
    be.delete("key", b"k03")
    be.defrag()
    be.put("key", b"after", b"1")
    be.commit()


SCRIPTS = {"basic": script_basic, "uncommitted": script_uncommitted,
           "torn": script_torn, "defrag": script_defrag}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_backend_scripts_write_the_reference_bytes(tmp_path, name):
    files, reads = {}, {}
    for tag, mod in (("jax", jbackend), ("port", tbackend)):
        path = str(tmp_path / f"{tag}.db")
        be = mod.Backend(path, batch_limit=4)
        SCRIPTS[name](be, mod)
        if not be._f.closed:
            be.close()
        with open(path, "rb") as f:
            files[tag] = f.read()
        re = mod.Backend(path)          # reopen: replay, truncate a torn tail
        reads[tag] = ({b: re.range(b, b"", b"\x00") for b in re.buckets()},
                      re.size(), re.size_in_use())
        re.close()
        with open(path, "rb") as f:
            files[tag + " reopened"] = f.read()
    assert files["port"] == files["jax"]
    assert files["port reopened"] == files["jax reopened"]
    assert reads["port"] == reads["jax"]
    if name == "uncommitted":
        assert reads["port"][0] == {"key": [(b"a", b"1")]}
    if name == "torn":
        assert len(files["port reopened"]) < len(files["port"])
    if name == "defrag":
        assert dict(reads["port"][0]["key"])[b"after"] == b"1"


# -- schema -------------------------------------------------------------------

PKGS = {"jax": (jschema, jbackend, jmvcc, jlease, jauth),
        "port": (tschema, tbackend, tmvcc, tlease, tauth)}


def write_db(path, pkg):
    """A member's db as _persist writes it: revisions with a delete and a
    lease, a compaction, the applied-meta record with lease, auth, alarms,
    versions and a v2 tree."""
    schema, backend, mvcc, lease, auth = PKGS[pkg]
    be = backend.Backend(path)
    st = mvcc.MVCCStore()
    les = lease.Lessor(1)
    les.grant(9, 30)
    au = auth.AuthStore()
    au.user_add("root", "pw", salt=b"s" * 16)     # the proposer's salt
    au.role_add("root")
    au.user_grant_role("root", "root")
    last = 0
    for i in range(12):
        txn = st.write_txn()
        if i % 4 == 3:
            txn.delete_range(b"k%d" % (i - 1))
        else:
            txn.put(b"k%d" % (i % 6), b"v%d" % i, 9 if i == 5 else 0)
        txn.end()
        if i == 8:
            st.compact(st.current_rev - 3)
            schema.persist_compaction(be, st)
        last = schema.persist_mvcc_delta(be, st, last)
    schema.save_applied_meta(be, index=17, term=3, store=st, lease_snap=les.to_snapshot(),
                             auth_snap=au.to_snapshot(), alarms={"NOSPACE"},
                             cluster_version="3.6.0", downgrade={"target-version": "", "enabled": False},
                             v2='{"version": 2}')
    schema.set_storage_version(be, schema.CURRENT_STORAGE_VERSION)
    be.close()
    return st


def load_db(path, pkg):
    schema, backend, mvcc, lease, auth = PKGS[pkg]
    be = backend.Backend(path)
    meta = schema.load_applied_meta(be)
    st = schema.load_mvcc(be, max_rev=meta["current_rev"], compact_rev=meta["compact_rev"])
    out = {"meta": meta, "version": schema.get_storage_version(be),
           "revs": {k: (v[0].key, v[0].value, v[0].create_revision, v[0].mod_revision,
                        v[0].version, v[0].lease, v[1]) for k, v in st.revs.items()},
           "current_rev": st.current_rev, "compact_rev": st.compact_rev,
           "hash_kv": st.hash_kv(), "range": [(kv.key, kv.value, kv.version)
                                              for kv in st.range(b"k", b"l")[0]]}
    les = lease.Lessor(1)
    les.restore(meta["lease"])
    au = auth.AuthStore()
    au.restore(meta["auth"])
    out["leases"] = sorted(les.leases)
    out["auth"] = au.to_snapshot()
    be.close()
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_db_written_by_either_package_loads_in_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "member0.db")
    write_db(path, writer)
    other = str(tmp_path / "other.db")
    write_db(other, reader)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()     # the same records, byte for byte
    assert load_db(path, reader) == load_db(path, writer) == load_db(other, reader)
    got = load_db(path, reader)
    assert got["version"] == "3.6" and got["meta"]["consistent_index"] == 17
    assert got["compact_rev"] > 0 and got["leases"] == [9]


def pickled_globals(path, backend) -> list:
    """Every class or function a record of the db file names in its pickles."""
    be = backend.Backend(path)
    named = []
    for bucket in be.buckets():
        for _, blob in be.range(bucket, b"", b"\x00"):
            if not blob[:1] == b"\x80":
                continue                # not a pickle (the storage version)
            for op, arg, _ in pickletools.genops(blob):
                if op.name in ("GLOBAL", "STACK_GLOBAL", "INST", "OBJ", "REDUCE",
                               "NEWOBJ", "NEWOBJ_EX"):
                    named.append((bucket, op.name, arg))
    be.close()
    return named


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_no_record_pickles_a_class(tmp_path, pkg):
    path = str(tmp_path / "member0.db")
    write_db(path, pkg)
    assert pickled_globals(path, PKGS[pkg][1]) == []
