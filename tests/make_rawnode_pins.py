"""Make the RawNode slice's pin from the JAX package (the reference) on the
CPU: ``RAWNODE_PIN.json`` at the root of the repo.

    JAX_PLATFORMS=cpu python tests/make_rawnode_pins.py [--only KEY[,KEY]]

The pin holds the records of ``etcd_tpu_torch/harness/rawnode_session.py``'s
scripts, each run on the JAX package (``jax_package``) at the spec its JAX
test uses:

- ``rawnode``: the Ready sequences of ``tests/test_rawnode.py``,
  ``tests/test_flow_control.py`` and the ``RecordingStorage`` drive of
  ``tests/test_wait_mock.py:63`` (every Ready's soft and hard state,
  entries, snapshot, committed entries, messages, MustSync and read states,
  the values the tests assert on, the errors, and each lane's leaves at the
  end);
- ``raftexample``: ``tests/test_raftexample.py``'s operations on one
  ``Cluster(3)`` in order (elect, put, overwrite, drop and heal, restart
  from storage, leader status), each node's kv, HardState, applied,
  applied_hash and Status after each, then ``main()``'s printed text;
- ``interaction``: the output of every command of each script in
  ``tests/interaction_scripts/``, through ``InteractionEnv``;
- ``wal``: each WAL script's record (replays, errors and the sha256 of
  every file it leaves), and ``wal_group``: a RawNode group persisted
  through the WAL, torn, replayed and rebooted (``run_wal_group``).

``--only`` remakes those keys and keeps the others from the file. The file
names this script and the package versions.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from etcd_tpu_torch.harness import rawnode_session as S  # noqa: E402

KEYS = ("rawnode", "raftexample", "interaction", "wal", "wal_group")


def provenance() -> dict:
    import jax
    import numpy

    return {"made_by": "tests/make_rawnode_pins.py (the JAX package on the CPU)",
            "jax": jax.__version__, "numpy": numpy.__version__}


def jax_package():
    """The JAX package's names for the scripts (rawnode_session.namespace)."""
    import numpy as np

    from etcd_tpu import types as T
    from etcd_tpu.harness import datadriven, interaction, mock
    from etcd_tpu.models import confchange, rawnode
    from etcd_tpu.storage import checkpoint, raftstorage, wal, walcodec
    from etcd_tpu.utils import config, wait
    from examples import raftexample

    mods = dict(T=T, cc=confchange, rs=raftstorage, wal=wal, walcodec=walcodec,
                ck=checkpoint, rawnode=rawnode, mock=mock, wait=wait, dd=datadriven,
                interaction=interaction, raftexample=raftexample, config=config)
    return S.namespace("jax", mods, {}, lambda rn: {
        k: np.asarray(getattr(rn.n, k)) for k in rn.n.__dataclass_fields__})


def make(key: str, p) -> object:
    if key == "rawnode":
        return {name: S.run_rawnode(p, name) for name in S.RAWNODE_SCRIPTS}
    if key == "raftexample":
        return S.run_raftexample(p)
    if key == "interaction":
        return {name: S.run_interaction(p, name) for name in S.interaction_names()}
    if key == "wal":
        out = {}
        for name in S.WAL_SCRIPTS:
            with tempfile.TemporaryDirectory() as d:
                out[name] = S.run_wal(p, name, d)
        return out
    with tempfile.TemporaryDirectory() as d:
        return S.run_wal_group(p, d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from etcd_tpu.utils.cache import configure_compile_cache

    configure_compile_cache(str(ROOT))
    only = set(filter(None, args.only.split(",")))
    pin = json.loads(S.PIN.read_text()) if only and S.PIN.exists() else {}
    pin.update(provenance())
    p = jax_package()
    t0 = time.perf_counter()
    for key in KEYS:
        if only and key not in only:
            continue
        t = time.perf_counter()
        pin[key] = json.loads(json.dumps(make(key, p)))
        print(f"{key} in {time.perf_counter() - t:.1f}s", flush=True)
    S.PIN.write_text(json.dumps(pin, separators=(",", ":")) + "\n")
    print(f"all in {time.perf_counter() - t0:.1f}s; {S.PIN.stat().st_size} bytes",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
