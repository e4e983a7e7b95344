"""The port's WAL and fleet checkpoints (etcd_tpu_torch/storage/{wal,
checkpoint}.py) against the JAX package's, byte for byte.

Each WAL script (etcd_tpu_torch/harness/rawnode_session.py: the scripts of
tests/test_storage.py and tests/test_crash_durability.py — save and replay,
truncate-and-append, torn-tail repair, cuts at a small segment size, the
snapshot marker and release_to, the bit-rot refusals, bootstrap_from_wal)
runs on both packages, live (plain Python): the records, the errors and
the bytes of every file must be equal, and each package's WAL reads the
other's directory to the same replay. A RawNode group persisted through the
port's WAL, torn, replayed and rebooted is held to RAWNODE_PIN.json
("wal_group"; the slow twin runs the JAX package live). save_fleet files
cross both ways to equal leaves and meta, and FleetCheckpointer rotates.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from etcd_tpu_torch.harness import rawnode_session as S
from etcd_tpu_torch.convert import to_numpy
from etcd_tpu_torch.models.engine import init_fleet
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.storage import checkpoint as tck
from etcd_tpu_torch.types import Spec

from make_rawnode_pins import jax_package
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

PIN = json.loads(S.PIN.read_text())
JAX, PORT = jax_package(), S.port_package("cpu")


@pytest.mark.parametrize("name", sorted(S.WAL_SCRIPTS))
def test_wal_script_equals_jax_byte_for_byte(name, tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    want = S.run_wal(JAX, name, jd)
    got = S.run_wal(PORT, name, td)
    assert got == want
    assert got[-1][1], "the script left no file"
    # each package reads the other's directory to the same replay
    for reader, d in ((JAX, td), (PORT, jd)):
        copy = str(tmp_path / f"read-{reader.name}")
        shutil.copytree(d, copy)
        with S.segment_bytes(reader, S.WAL_SCRIPTS[name][1] or reader.wal.SEGMENT_BYTES):
            assert S.read_view(reader, copy) == want[-2][1]


def test_wal_group_equals_pin(tmp_path):
    got = json.loads(json.dumps(S.run_wal_group(PORT, str(tmp_path))))
    want = PIN["wal_group"]
    assert [k for k in want if got.get(k) != want[k]] == []
    assert got["reboot"]["2"]["applied"] == got["reboot"]["0"]["applied"] > 0


@pytest.mark.slow
def test_wal_group_equals_jax_live(tmp_path):
    want = json.loads(json.dumps(S.run_wal_group(JAX, str(tmp_path / "jax"))))
    assert json.loads(json.dumps(S.run_wal_group(PORT, str(tmp_path / "port")))) == want


def seeded_fleet(seed=0, C=3) -> NodeState:
    """A fleet of init_fleet's leaf shapes and dtypes with seeded values."""
    spec = Spec(M=3, L=8, E=2, K=2, W=4, R=2, A=2)
    st = init_fleet(spec, C, device="cpu")
    g = torch.Generator().manual_seed(seed)
    return st.map(lambda _, x: torch.randint(0, 2, x.shape, generator=g).bool()
                  if x.dtype == torch.bool else
                  torch.randint(-2**31, 2**31, x.shape, generator=g, dtype=torch.int64)
                  .to(torch.int32))


def npz_layout(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: (z[k].dtype.str, z[k].shape) for k in z.files}


def test_save_fleet_crosses_both_ways(tmp_path):
    from etcd_tpu.storage import checkpoint as jck

    st = seeded_fleet()
    port_file = str(tmp_path / "port" / "fleet.npz")
    tck.save_fleet(port_file, st, round_no=7, extra={"seed": 0})
    jst, jmeta = jck.load_fleet(port_file)
    want = to_numpy(st)
    assert jmeta == {"round": 7, "extra": {"seed": 0}}
    for k, v in want.items():
        a = np.asarray(getattr(jst, k))
        assert a.dtype == v.dtype and np.array_equal(a, v), k
    jax_file = str(tmp_path / "jax" / "fleet.npz")
    jck.save_fleet(jax_file, jst, round_no=7, extra={"seed": 0})
    assert npz_layout(jax_file) == npz_layout(port_file)
    back, meta = tck.load_fleet(jax_file, device="cpu")
    assert meta == jmeta
    for k, v in to_numpy(back).items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k


def test_fleet_checkpointer_rotation(tmp_path):
    from etcd_tpu.storage import checkpoint as jck

    ck = tck.FleetCheckpointer(str(tmp_path / "ck"), every=2, keep=2)
    states = [seeded_fleet(seed) for seed in range(10)]
    saved = sum(ck.maybe_save(s) for s in states)
    assert saved == 5
    assert sorted(os.listdir(ck.dir)) == ["fleet-000000000008.npz", "fleet-000000000010.npz"]
    st, meta = tck.FleetCheckpointer(ck.dir).restore(device="cpu")
    assert meta["round"] == 10
    assert all(np.array_equal(a, b) for a, b in zip(to_numpy(st).values(),
                                                    to_numpy(states[-1]).values()))
    jst, jmeta = jck.FleetCheckpointer(ck.dir).restore()
    assert jmeta == meta and np.array_equal(np.asarray(jst.log_data),
                                            to_numpy(states[-1])["log_data"])
    assert tck.FleetCheckpointer(str(tmp_path / "empty")).restore(device="cpu") is None


def test_load_fleet_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default does not raise here")
    path = str(tmp_path / "f.npz")
    tck.save_fleet(path, seeded_fleet())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_fleet(path)
