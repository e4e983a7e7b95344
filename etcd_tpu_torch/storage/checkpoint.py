"""Fleet checkpoint/restore — the WAL+snapshot pair at device scale
(etcd_tpu/storage/checkpoint.py; the same file format).

The reference persists per-node HardState+entries in the WAL on every Ready
(server/etcdserver/raft.go:236) and cuts full snapshots every SnapshotCount
applied entries (server.go:1088-1104). At fleet scale the equivalent is:

  * full-state device->host snapshots every N rounds (one npz of the whole
    [M, ..., C] NodeState — HardState, log ring, trackers, RNG keys), and
  * per-round HardState/entry *deltas* appended to a WAL for the clusters
    the host is actively serving (EtcdCluster integration tier).

The npz holds one array per NodeState field under its name, in the JAX
package's dtypes (the PRNG key as uint32, see convert.py), and a
``__meta__`` JSON string, so either package loads the other's file.
Restore rebuilds the exact NodeState; because the engine is deterministic
given (state, inputs), replaying the same proposal schedule reproduces the
same fleet — the deterministic-replay contract of SURVEY.md §5
checkpoint/resume.
"""
from __future__ import annotations

import json
import os

import numpy as np

from etcd_tpu_torch.convert import node_state_from_numpy, to_numpy
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.utils.device import resolve_device


def save_fleet(path: str, state: NodeState, round_no: int = 0,
               extra: dict | None = None) -> None:
    """Atomic full-fleet snapshot (write-temp + rename, like the reference's
    snap file discipline in api/snap/snapshotter.go). ``state`` is a dense
    NodeState on any device (a packed fleet is unpacked first)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = to_numpy(state)
    meta = {"round": round_no, "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __meta__=json.dumps(meta), **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_fleet(path: str, device=None) -> tuple[NodeState, dict]:
    """The NodeState and meta of a save_fleet file, on ``device`` (None:
    the CUDA card; raises where there is none)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = {k: z[k] for k in z.files if k != "__meta__"}
    return node_state_from_numpy(leaves, dev), meta


class FleetCheckpointer:
    """Every-N-rounds snapshot rotation with retention (the triggerSnapshot
    cadence, server.go:72 DefaultSnapshotCount). ``restore`` loads onto
    ``device`` (None: the CUDA card)."""

    def __init__(self, dirpath: str, every: int = 1000, keep: int = 3):
        self.dir = dirpath
        self.every = every
        self.keep = keep
        self.round = 0
        os.makedirs(dirpath, exist_ok=True)

    def maybe_save(self, state: NodeState, rounds_advanced: int = 1) -> bool:
        self.round += rounds_advanced
        if self.round % self.every:
            return False
        self.save(state)
        return True

    def save(self, state: NodeState) -> str:
        path = os.path.join(self.dir, f"fleet-{self.round:012d}.npz")
        save_fleet(path, state, self.round)
        self._gc()
        return path

    def latest(self) -> str | None:
        snaps = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("fleet-") and f.endswith(".npz")
        )
        return os.path.join(self.dir, snaps[-1]) if snaps else None

    def restore(self, device=None) -> tuple[NodeState, dict] | None:
        p = self.latest()
        if p is None:
            return None
        state, meta = load_fleet(p, device)
        self.round = meta["round"]
        return state, meta

    def _gc(self) -> None:
        snaps = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("fleet-") and f.endswith(".npz")
        )
        for f in snaps[: -self.keep]:
            os.remove(os.path.join(self.dir, f))
