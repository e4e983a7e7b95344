"""Device-resident MVCC revision store as a tensor dataclass
(etcd_tpu/device_mvcc/state.py).

The batched form of ``MVCCStore`` (etcd_tpu_torch/server/mvcc.py) over the
canonical fixed key space (device_mvcc/scheme.py): one group's store is a
bundle of ``[keys]`` per-key lanes plus per-group revision cursors; a fleet
is the same struct with the clusters axis minor (``[keys, C]`` and ``[C]``
leaves), the engine's layout.

Each key slot holds the key's newest revision record, which is what
``mvccpb.KeyValue`` carries (mod/create/version/value/lease), plus the
tombstone mask that stands in for an uncompacted tombstone generation.
History below the latest record is not kept; reads below a key's
mod_revision answer ``ErrCompacted`` (see apply.read_at).
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.device_mvcc import scheme
from etcd_tpu_torch.types import TensorStruct
from etcd_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Static shape parameters of the device revision store."""

    keys: int = 64  # fixed key-space size (canonical slots 0..keys-1)

    def __post_init__(self):
        if not 1 <= self.keys <= scheme.MAX_KEYS:
            raise ValueError(
                f"KVSpec.keys ({self.keys}) outside [1, {scheme.MAX_KEYS}] "
                "(the op-word key field is 9 bits)"
            )


@dataclasses.dataclass
class KVState(TensorStruct):
    # per-key latest records (mvccpb.KeyValue), [keys, C]
    present: torch.Tensor   # bool: key exists in the index (tombstoned too)
    tomb: torch.Tensor      # bool: latest record is an uncompacted tombstone
    mod: torch.Tensor       # i32 mod_revision (main)
    create: torch.Tensor    # i32 create_revision (0 for tombstones)
    version: torch.Tensor   # i32 (0 for tombstones)
    vword: torch.Tensor     # i32 value word
    lease: torch.Tensor     # i32 lease id (0 = none)
    # per-group cursors, [C]
    current_rev: torch.Tensor   # i32, boots at 1 like the reference
    compact_rev: torch.Tensor   # i32
    txn_main: torch.Tensor      # i32 revision main of the open txn (CONT words)
    # per-group status lanes (the host's exceptions as counters)
    err_compacted: torch.Tensor  # i32 ErrCompacted count
    err_future: torch.Tensor     # i32 ErrFutureRev count
    # the engine's apply-frontier bookkeeping, [C]
    applied_idx: torch.Tensor   # i32 log index applied into this store
    skipped: torch.Tensor       # i32 words lost to ring-overwrite overrun
    desynced: torch.Tensor      # bool, sticky: the bound member installed a
    # peer snapshot, so its ring no longer index-matches and the lane
    # freezes (engine.build_kv_round)


def init_kv(kvspec: KVSpec, C: int, device=None) -> KVState:
    """Fresh fleet store: empty key space at revision 1."""
    dev = resolve_device(device)
    K = kvspec.keys

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return KVState(
        present=z((K, C), torch.bool), tomb=z((K, C), torch.bool),
        mod=z((K, C)), create=z((K, C)), version=z((K, C)), vword=z((K, C)),
        lease=z((K, C)),
        current_rev=torch.ones((C,), dtype=torch.int32, device=dev),
        compact_rev=z((C,)), txn_main=z((C,)), err_compacted=z((C,)),
        err_future=z((C,)), applied_idx=z((C,)), skipped=z((C,)),
        desynced=z((C,), torch.bool),
    )
