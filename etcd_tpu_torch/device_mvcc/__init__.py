"""Device-resident MVCC apply plane (etcd_tpu/device_mvcc).

The host MVCC apply path (server/mvcc.py) as batched tensors riding the
same clusters-minor fleet as the consensus engine: a fixed-key-space
revision store with a masked txn apply, compaction with
ErrCompacted/ErrFutureRev status lanes, a shared canonical digest, and the
device-side watch-delta scan, so a committed entry becomes a served write
on the device.

Modules:
  scheme  the canonical key/value/word codec and the shared digest fold
          (pure Python; both planes import it)
  state   KVSpec, KVState (clusters-minor, the engine layout), init_kv
  apply   apply_word, apply_words, check_rev, read_at, kv_digest,
          WatchDelta, extract_deltas
  facade  DevicePlane, the per-lane host surface that
          server/mvcc.py DeviceBackedStore sits on
  fuzz    the differential schedule generator and host replay

models/engine.py build_kv_round consumes committed entry words from the
apply frontier; host or device apply is a runtime operand of one program.
"""
from etcd_tpu_torch.device_mvcc.state import KVSpec, KVState, init_kv  # noqa: F401
from etcd_tpu_torch.device_mvcc.apply import (  # noqa: F401
    WatchDelta,
    apply_word,
    apply_words,
    extract_deltas,
    kv_digest,
    read_at,
)
from etcd_tpu_torch.device_mvcc.facade import DevicePlane  # noqa: F401
