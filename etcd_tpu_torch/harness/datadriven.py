"""Minimal parser for cockroachdb/datadriven golden files
(etcd_tpu/harness/datadriven.py).

The reference drives its quorum/confchange/raft suites from ``testdata/*.txt``
files in this format (see raft/quorum/datadriven_test.go:36-110 for the
argument conventions):

    # comment
    command key=(v1, v2) other=x
    ----
    expected output lines...
    <blank line ends the case>

We parse the *directives* and replay them against the engine, comparing
semantic results (committed indexes, vote outcomes, final configs) rather
than byte-identical log text — the golden prose is Go-logger output, but the
decisions it records are implementation-independent.
"""
from __future__ import annotations

import dataclasses
import os
import re

# where the reference raft checkout is looked for: the JAX package's
# REFERENCE_ROOT (etcd_tpu/harness/datadriven.py), the same value
REFERENCE_ROOT = os.path.join(os.sep, "root", "reference", "raft")


@dataclasses.dataclass
class Case:
    cmd: str
    args: dict[str, list[str]]
    expected: list[str]
    line: int
    input: list[str] = dataclasses.field(default_factory=list)


_ARG_RE = re.compile(r"(\w+)=\(([^)]*)\)|(\w+)=(\S+)")


def parse_directive(line: str) -> tuple[str, dict[str, list[str]]]:
    cmd, _, rest = line.partition(" ")
    args: dict[str, list[str]] = {}
    # collect bare positional tokens ("campaign 1", "stabilize 1 4") from
    # the directive with parenthesized kwarg values masked out first, so
    # 'drop=(2, 3)' doesn't leak '3)' into the positional list
    bare = re.sub(r"\w+=\([^)]*\)", "", rest)
    for tok in bare.split():
        if "=" not in tok:
            args.setdefault("_pos", []).append(tok)
    for m in _ARG_RE.finditer(rest):
        if m.group(1) is not None:
            key, raw = m.group(1), m.group(2)
            vals = [v.strip() for v in raw.split(",")] if raw.strip() else []
        else:
            key, vals = m.group(3), [m.group(4)]
        args.setdefault(key, []).extend(vals)
    return cmd, args


def parse_file(path: str) -> list[Case]:
    cases: list[Case] = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        start = i
        cmd, args = parse_directive(line)
        i += 1
        # optional input lines between the directive and the ---- separator
        # (e.g. confchange's "simple\nv1 l2\n----")
        inp = []
        while i < len(lines) and lines[i].strip() != "----":
            inp.append(lines[i].strip())
            i += 1
        assert i < len(lines), f"{path}:{start + 1}: missing ---- separator"
        i += 1
        out = []
        while i < len(lines) and lines[i].strip() != "":
            out.append(lines[i])
            i += 1
        cases.append(Case(cmd, args, out, start + 1, inp))
    return cases


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)


def testdata(*parts: str) -> str:
    return os.path.join(REFERENCE_ROOT, *parts)
