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
            environ=None, hi: int | None = None) -> int:
    raw = (os.environ if environ is None else environ).get(name, default)
    try:
        v = int(raw)
    except ValueError:
        knob_error(prog, f"{name}={raw!r} is not an integer")
    if hi is not None and (v > hi or (lo is not None and v < lo)):
        knob_error(prog, f"{name}={raw} outside [{lo}, {hi}]")
    if lo is not None and v < lo:
        knob_error(prog, f"{name}={raw} is below {lo}")
    return v


def env_bool(prog: str, name: str, default: str, environ=None) -> bool:
    """0/1 flag (a typo'd value must not silently select the 0 branch)."""
    raw = (os.environ if environ is None else environ).get(name, default)
    if raw not in ("0", "1"):
        knob_error(prog, f"{name}={raw!r} is not 0 or 1")
    return raw == "1"


def env_float(prog: str, name: str, default: str, lo: float | None = None,
              hi: float | None = None, environ=None) -> float:
    raw = (os.environ if environ is None else environ).get(name, default)
    try:
        v = float(raw)
    except ValueError:
        knob_error(prog, f"{name}={raw!r} is not a number")
    if v != v:  # NaN compares False against any range bound
        knob_error(prog, f"{name}={raw!r} is not a number")
    if (lo is not None and v < lo) or (hi is not None and v > hi):
        span = f"[{lo}, {hi}]" if hi is not None else f">= {lo}"
        knob_error(prog, f"{name}={raw} outside {span}")
    return v


def env_str(prog: str, name: str, default: str, choices: tuple, environ=None) -> str:
    """A knob with a fixed set of values (a typo must not select another)."""
    raw = (os.environ if environ is None else environ).get(name, default)
    if raw not in choices:
        knob_error(prog, f"{name}={raw!r} is not one of {'/'.join(choices)}")
    return raw
