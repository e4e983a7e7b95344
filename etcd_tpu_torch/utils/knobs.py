"""Environment knobs with the exit-2 contract of etcd_tpu/utils/knobs.py: a
malformed or out-of-range value, or one the program cannot honour, prints
a pointed message and exits 2 before any device work."""
from __future__ import annotations

import os
import sys


def knob_error(prog: str, msg: str):
    print(f"{prog}: {msg}", file=sys.stderr)
    raise SystemExit(2)


def env_int(prog: str, name: str, default: str, lo: int | None = None,
            environ=None) -> int:
    raw = (os.environ if environ is None else environ).get(name, default)
    try:
        v = int(raw)
    except ValueError:
        knob_error(prog, f"{name}={raw!r} is not an integer")
    if lo is not None and v < lo:
        knob_error(prog, f"{name}={raw} is below {lo}")
    return v


def env_bool(prog: str, name: str, default: str, environ=None) -> bool:
    """0/1 flag (a typo'd value must not silently select the 0 branch)."""
    raw = (os.environ if environ is None else environ).get(name, default)
    if raw not in ("0", "1"):
        knob_error(prog, f"{name}={raw!r} is not 0 or 1")
    return raw == "1"
