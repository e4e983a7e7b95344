"""Make the pin of tests/test_torch_cluster.py's scenarios from the JAX
package (the reference) on the CPU: ``CLUSTER_SCENARIO_PIN.json`` at the root
of the repo.

    JAX_PLATFORMS=cpu python tests/make_cluster_pins.py

Each scenario script of tests/test_torch_cluster.py (``SCRIPTS``, with its
voters) runs on the JAX ``Cluster`` (5 members, 2 groups padded to 16 lanes,
the module's spec and config). The pin holds, for every round the script
steps, a digest of each state and inbox leaf (``leaf_digest``), and the
state and inbox leaves of the last round in full. The file names this script
and the package versions.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from etcd_tpu.utils.cache import configure_compile_cache

    configure_compile_cache(str(ROOT))
    import numpy

    import test_torch_cluster as tc
    from etcd_tpu.harness.cluster import Cluster as JCluster
    from etcd_tpu.models import confchange as jcc

    pin = {"made_by": "tests/make_cluster_pins.py (the JAX package on the CPU)",
           "jax": jax.__version__, "numpy": numpy.__version__, "scenarios": {}}
    t0 = time.perf_counter()
    for name in sorted(tc.SCRIPTS):
        t = time.perf_counter()
        log = []
        cl = tc.recorded(JCluster(spec=tc.jspec(tc.SPEC), cfg=tc.jcfg(tc.CFG), n_members=5,
                                  C=2, voters=tc.VOTERS.get(name)), log, tc.jax_np)
        tc.SCRIPTS[name](cl, jcc)
        pin["scenarios"][name] = tc.pin_record(log)
        print(f"{name}: {len(log)} rounds in {time.perf_counter() - t:.1f}s", flush=True)
    tc.PIN_PATH.write_text(json.dumps(pin, separators=(",", ":")) + "\n")
    print(f"all in {time.perf_counter() - t0:.1f}s; {tc.PIN_PATH.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
