"""Memory hygiene for the port's tests, which share their worker processes
with the JAX package's tests.

A worker that has run JAX tests keeps every program they compiled, and glibc
keeps the heap that those programs free: such a worker holds 10 to 16 GB,
and six of them fill a 64 GB machine, where every process then slows to a
crawl or is killed. Most of that heap is free: after a test that compiles a
round program, a worker of 2.6 to 3.3 GB holds 0.3 to 0.4 GB once
``malloc_trim(0)`` hands the free heap back (0.2 s a call).

So importing this module, which every ``tests/test_torch_*.py`` module
does (every worker imports them when it collects the suite), starts one
daemon thread in the process that calls ``malloc_trim(0)`` every
``TRIM_EVERY_S`` seconds while the process holds more than ``TRIM_ABOVE``
bytes. It frees no live object, so no test sees it. And each torch module
uses ``release_jax_memory``, an autouse fixture that, when the module
starts and when it ends, also drops JAX's compiled programs if the worker
has grown past ``RELEASE_ABOVE`` bytes. A leaner worker keeps its
programs, which the next module may reuse.
"""
import ctypes
import gc
import os
import threading
import time

import jax
import pytest

RELEASE_ABOVE = 4 << 30
TRIM_ABOVE = 2 << 30
TRIM_EVERY_S = 5.0

try:
    _malloc_trim = ctypes.CDLL("libc.so.6").malloc_trim
except (OSError, AttributeError):  # not glibc: nothing to hand back
    _malloc_trim = None


def resident_bytes() -> int:
    """The process's resident set, or 0 where /proc does not say."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def release_if_large(limit: int = RELEASE_ABOVE) -> bool:
    """Drop JAX's caches and trim the heap if the process holds more than
    ``limit`` bytes; says whether it did."""
    if resident_bytes() <= limit:
        return False
    jax.clear_caches()
    gc.collect()
    if _malloc_trim is not None:
        _malloc_trim(0)
    return True


def _trim_while_large() -> None:
    while True:
        time.sleep(TRIM_EVERY_S)
        if resident_bytes() > TRIM_ABOVE:
            _malloc_trim(0)


if _malloc_trim is not None:
    threading.Thread(target=_trim_while_large, name="malloc-trim", daemon=True).start()


@pytest.fixture(scope="module", autouse=True)
def release_jax_memory():
    release_if_large()
    yield
    release_if_large()
