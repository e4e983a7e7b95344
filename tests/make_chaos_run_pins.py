"""Make the JAX side of the port's tier-1 run_chaos comparisons from the
JAX package (the reference) on the CPU: ``CHAOS_RUN_PIN.npz`` at the root of
the repo.

    JAX_PLATFORMS=cpu python tests/make_chaos_run_pins.py [--only NAME[,NAME]]

For each run in the ``PINNED_RUNS`` of tests/test_torch_chaos.py,
test_torch_crash.py, test_torch_member.py and test_torch_blackbox.py, the
JAX package's ``run_chaos`` (tests/test_torch_chaos.py ``run_jax``): its
report, pickled, and the last epoch program's outputs (state, inbox, held
buffer, CrashState, key and the planes), leaf by leaf, with a fingerprint of
the arguments the run was made from; and under ``round`` the JAX rounds of
tests/test_torch_round.py (``jax_trajectory``: each round's inputs, state
and wire). The tier-1 tests read these in place of tracing the JAX
programs; their slow twins run the JAX package live. ``--only`` remakes
those names and keeps the others from the file.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

MODULES = ("test_torch_chaos", "test_torch_crash", "test_torch_member",
           "test_torch_blackbox")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    only = set(filter(None, ap.parse_args(argv).only.split(",")))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from etcd_tpu.utils.cache import configure_compile_cache

    configure_compile_cache(str(ROOT))
    import importlib

    import numpy as np

    import test_torch_chaos as tc

    arrays = {}
    if only:
        with np.load(tc.CHAOS_RUN_PIN, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files
                      if k.split("/")[0] not in only}
    arrays["__made_by__"] = np.array(
        f"tests/make_chaos_run_pins.py (the JAX package on the CPU; jax {jax.__version__}, "
        f"numpy {np.__version__})")
    t0 = time.perf_counter()
    if not only or "round" in only:
        import test_torch_round as tr

        rows = tr.jax_trajectory()
        arrays.update(tr.pin_trajectory(rows))
        print(f"round: {len(rows)} rows in {time.perf_counter() - t0:.1f}s", flush=True)
    for mod in MODULES:
        for name, args in importlib.import_module(mod).PINNED_RUNS.items():
            if only and name not in only:
                continue
            t = time.perf_counter()
            spec, cfg, C, jax_kw, kw = args()
            jrep, jout = tc.run_jax(spec, cfg, C, jax_kw, **kw)
            arrays.update(tc.pin_entry(name, jrep, jout,
                                       tc.run_fingerprint(spec, cfg, C, kw)))
            print(f"{name}: {jrep['rounds']} rounds in {time.perf_counter() - t:.1f}s",
                  flush=True)
    with open(tc.CHAOS_RUN_PIN, "wb") as f:
        np.savez_compressed(f, **arrays)
    print(f"all in {time.perf_counter() - t0:.1f}s; {tc.CHAOS_RUN_PIN.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
