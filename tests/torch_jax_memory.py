"""Memory hygiene for the port's tests, which share their worker processes
with the JAX package's tests.

A worker that has run JAX tests keeps every program they compiled, and glibc
keeps the heap that those programs free: such a worker holds 10 to 16 GB,
and six of them fill a 64 GB machine, where every process then slows to a
crawl. Each ``tests/test_torch_*.py`` module imports ``release_jax_memory``,
an autouse fixture that, when the module starts and when it ends, drops
JAX's compiled programs and hands the freed heap back to the system if the
worker has grown past ``RELEASE_ABOVE`` bytes. A leaner worker keeps its
programs, which the next module may reuse.
"""
import ctypes
import gc
import os

import jax
import pytest

RELEASE_ABOVE = 4 << 30

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


@pytest.fixture(scope="module", autouse=True)
def release_jax_memory():
    release_if_large()
    yield
    release_if_large()
