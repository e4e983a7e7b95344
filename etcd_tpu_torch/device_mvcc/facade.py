"""Host facade over a fleet of device-resident MVCC stores
(etcd_tpu/device_mvcc/facade.py).

``DevicePlane`` owns one ``KVState`` fleet (C lanes, clusters-minor) and
gives host code an imperative per-lane surface: encode the op, run one
masked apply on the device, read back the lanes it needs. This is the
half of the apply plane that a server sits on; the batched path goes
through ``models/engine.py build_kv_round`` instead and never leaves the
device.

This module returns plain Python records; the KeyValue and Event objects
are made in the server layer (server/mvcc.py DeviceBackedStore,
server/watch.py events_from_delta), so device_mvcc never imports server
code.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.device_mvcc.apply import apply_word, kv_digest
from etcd_tpu_torch.device_mvcc.state import KVSpec, init_kv
from etcd_tpu_torch.utils.device import resolve_device

RECORD_FIELDS = ("mod", "create", "version", "vword", "lease")


class DevicePlane:
    """C independent device MVCC lanes (one per hosted member), on
    ``device`` (None: CUDA)."""

    def __init__(self, kvspec: KVSpec | None = None, C: int = 1, device=None):
        self.kvspec = kvspec or KVSpec()
        self.C = C
        self.device = resolve_device(device)
        self.st = init_kv(self.kvspec, C, self.device)

    # raw word application
    def apply_word_lane(self, lane: int, word: int) -> None:
        active = torch.zeros((self.C,), dtype=torch.bool, device=self.device)
        active[lane] = True
        self.st = apply_word(self.kvspec, self.st, word, active)

    # lane readbacks
    def current_rev(self, lane: int) -> int:
        return int(self.st.current_rev[lane])

    def compact_rev(self, lane: int) -> int:
        return int(self.st.compact_rev[lane])

    def err_counts(self, lane: int) -> tuple[int, int]:
        return int(self.st.err_compacted[lane]), int(self.st.err_future[lane])

    def digest(self, lane: int) -> int:
        return int(kv_digest(self.kvspec, self.st)[lane])

    def records(self, lane: int) -> dict[int, dict]:
        """Latest records of one lane: {key_id: {mod, create, version,
        vword, lease, tomb}} for present keys (tombstones included)."""
        sub = {k: v[:, lane].tolist() for k, v in self.st.items() if v.dim() == 2}
        out = {}
        for kid, here in enumerate(sub["present"]):
            if here:
                out[kid] = {f: sub[f][kid] for f in RECORD_FIELDS}
                out[kid]["tomb"] = sub["tomb"][kid]
        return out

    # lane restore (the peer-snapshot install path)
    def load_lane(self, lane: int, records: dict[int, dict],
                  current_rev: int, compact_rev: int) -> None:
        """Overwrite one lane from latest-record tuples (applySnapshot for
        the device plane: the lane jumps to the snapshot)."""
        K = self.kvspec.keys
        cols = {"present": [False] * K, "tomb": [False] * K,
                **{f: [0] * K for f in RECORD_FIELDS}}
        for kid, r in records.items():
            cols["present"][kid] = True
            cols["tomb"][kid] = bool(r["tomb"])
            for f in RECORD_FIELDS:
                cols[f][kid] = r[f]
        upd = {}
        for f, col in cols.items():
            leaf = getattr(self.st, f).clone()
            leaf[:, lane] = torch.tensor(col, dtype=leaf.dtype, device=self.device)
            upd[f] = leaf
        for f, v in (("current_rev", current_rev), ("compact_rev", compact_rev),
                     ("txn_main", 0)):
            leaf = getattr(self.st, f).clone()
            leaf[lane] = v
            upd[f] = leaf
        self.st = self.st.replace(**upd)
