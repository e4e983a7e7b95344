"""The port's host-side storage and harness helpers against the JAX
package's, live (both are plain Python): MemoryStorage on the tables of
tests/test_raftstorage.py (the same answers and the same errors),
PayloadTable, Wait and WaitTime, the RecordingStorage and RecordingWait
doubles, and the datadriven parser on seeded texts."""
import random

import pytest

from etcd_tpu.harness import datadriven as jdd
from etcd_tpu.harness import mock as jmock
from etcd_tpu.storage import raftstorage as jrs
from etcd_tpu.utils import wait as jwait
from etcd_tpu_torch.harness import datadriven as tdd
from etcd_tpu_torch.harness import mock as tmock
from etcd_tpu_torch.storage import raftstorage as trs
from etcd_tpu_torch.utils import wait as twait

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)


def view(x):
    """A comparable form of a storage answer, whichever package gave it."""
    if isinstance(x, (list, tuple)):
        return [view(v) for v in x]
    if isinstance(x, (jrs.Entry, trs.Entry)):
        return ("Entry", x.index, x.term, x.type, x.data)
    if isinstance(x, (jrs.HardState, trs.HardState)):
        return ("HardState", x.term, x.vote, x.commit)
    if isinstance(x, (jrs.ConfState, trs.ConfState)):
        return ("ConfState", x.voters, x.voters_outgoing, x.learners,
                x.learners_next, x.auto_leave)
    if isinstance(x, (jrs.Snapshot, trs.Snapshot)):
        m = x.meta
        return ("Snapshot", m.index, m.term, view(m.conf_state), m.app_hash, x.data)
    return x


def run_ops(rs, ops, fixture=True):
    """Apply ``ops`` ((method, *args), entries as (index, term) tuples) to a
    package's MemoryStorage built like tests/test_raftstorage.py's make():
    each answer or error name, then the storage's state."""
    s = rs.MemoryStorage()
    if fixture:
        s.apply_snapshot(rs.Snapshot(meta=rs.SnapshotMeta(index=3, term=3)))
        s.ents = [rs.Entry(4, 4), rs.Entry(5, 5), rs.Entry(6, 6)]

    def arg(a):
        if isinstance(a, list):
            return [rs.Entry(*e) for e in a]
        if isinstance(a, dict):      # a snapshot or a conf state
            if "voters" in a:
                return rs.ConfState(voters=tuple(a["voters"]))
            return rs.Snapshot(meta=rs.SnapshotMeta(
                index=a["index"], term=a["term"],
                conf_state=rs.ConfState(voters=tuple(a.get("cs", ())))))
        return a

    out = []
    for name, *args in ops:
        try:
            out.append(view(getattr(s, name)(*[arg(a) for a in args])))
        except Exception as e:  # noqa: BLE001 - the name is the answer
            out.append(type(e).__name__)
    out.append(("state", s.first_index(), s.last_index(), view(s.ents),
                view(s.snap), view(s.hard_state)))
    return out


CASES = {
    # TestStorageTerm
    **{f"term {i}": [("term", i)] for i in range(2, 8)},
    # TestStorageEntries
    **{f"entries {lo} {hi} {m}": [("entries", lo, hi, m)] for lo, hi, m in (
        (2, 6, None), (3, 4, None), (4, 5, None), (4, 6, None), (4, 7, None),
        (4, 8, None), (4, 7, 1), (4, 7, 2), (4, 7, 0), (5, 5, None))},
    # TestStorageLastIndex / FirstIndex
    "first last": [("first_index",), ("last_index",), ("append", [(7, 5)]),
                   ("last_index",), ("compact", 4), ("first_index",),
                   ("last_index",)],
    # TestStorageCompact
    **{f"compact {i}": [("compact", i), ("first_index",), ("term", i)]
       for i in range(2, 8)},
    # TestStorageAppend
    **{f"append {k}": [("append", ents)] for k, ents in enumerate((
        [(1, 1), (2, 2)],
        [(3, 3), (4, 4), (5, 5)],
        [(3, 3), (4, 6), (5, 6)],
        [(3, 3), (4, 4), (5, 5), (6, 5)],
        [(4, 5)],
        [(5, 8)],
        [(8, 5)],
        [],
    ))},
    # TestStorageApplySnapshot / CreateSnapshot
    "apply snapshot": [("apply_snapshot", {"index": 4, "term": 4, "cs": (0, 1, 2)}),
                       ("first_index",), ("last_index",),
                       ("apply_snapshot", {"index": 3, "term": 3})],
    "create snapshot": [("create_snapshot", 4, {"voters": (0, 1, 2)}, (7,)),
                        ("last_index",), ("create_snapshot", 3, {"voters": (0,)}),
                        ("create_snapshot", 9, {"voters": (0,)}),
                        ("create_snapshot", 5, None, (), -12345)],
    "hard state": [("set_hard_state", jrs.HardState(2, 1, 5)), ("initial_state",)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_memory_storage_equals_jax(case):
    ops = CASES[case]
    if case == "hard state":
        t_ops = [("set_hard_state", trs.HardState(2, 1, 5)), ("initial_state",)]
        assert run_ops(jrs, ops) == run_ops(trs, t_ops)
        return
    assert run_ops(jrs, ops) == run_ops(trs, ops)


def test_empty_storage_and_payload_table_equal_jax():
    ops = [("first_index",), ("last_index",), ("term", 0), ("term", 1),
           ("entries", 1, 1), ("snapshot",), ("initial_state",)]
    assert run_ops(jrs, ops, fixture=False) == run_ops(trs, ops, fixture=False)
    got = []
    for rs in (jrs, trs):
        t = rs.PayloadTable()
        words = [t.intern(x) for x in ("a", b"b", "a", "", "ccc", b"a")]
        got.append((words, [t.lookup(w) for w in (*words, 99)]))
    assert got[0] == got[1]


def wait_script(w):
    out = []
    wt = w.Wait()
    a, b = wt.register(1), wt.register(2)
    out.append((wt.is_registered(1), wt.is_registered(2)))
    try:
        wt.register(1)
    except ValueError as e:
        out.append(str(e))
    wt.trigger(1, "one")
    wt.trigger(99, "none")
    out.append((a.done, a.value, b.done, wt.is_registered(1)))
    wt.trigger(2, "two")
    out.append(b.wait(timeout=1))
    tl = w.WaitTime()
    ws = [tl.wait(d) for d in (1, 2, 4)]
    tl.trigger(2)
    out.append([x.done for x in ws] + [tl.wait(2).done, tl.wait(5).done])
    tl.trigger(10)
    out.append([x.done for x in ws])
    try:
        w.Waiter().wait(timeout=0.01)
    except TimeoutError as e:
        out.append(str(e))
    return out


def test_wait_and_wait_time_equal_jax():
    assert wait_script(jwait) == wait_script(twait)


def recording_script(mock, rs):
    out = []
    s = mock.RecordingStorage(rs.MemoryStorage())
    s.append([rs.Entry(index=1, term=1), rs.Entry(index=2, term=1)])
    out.append([s.last_index(), s.first_index(), s.term(1)])
    s.fail["entries"] = rs.ErrCompacted(1)
    try:
        s.entries(1, 2)
    except rs.ErrCompacted:
        out.append("ErrCompacted")
    out.append(view(s.entries(1, 3, max_entries=1)))
    s.set_hard_state(rs.HardState(1, 0, 1))
    s.compact(1)
    out.append(view(s.initial_state()))
    out.append([(a[0], *(view(x) for x in a[1:])) for a in s.actions])
    out.append(s.names())
    w = mock.RecordingWait()
    got = w.register(3)
    w.trigger(3, "v")
    w.trigger(4, "x")
    out.append((w.actions, got.value))
    return out


def test_recording_doubles_equal_jax():
    assert recording_script(jmock, jrs) == recording_script(tmock, trs)


def seeded_script(seed: int) -> str:
    """A datadriven text of random directives: positional tokens, key=value
    and key=(a, b) arguments, input lines, comments and output blocks."""
    rng = random.Random(seed)
    words = ["campaign", "propose", "stabilize", "add-nodes", "deliver-msgs",
             "propose-conf-change", "status", "log-level"]
    lines = []
    for _ in range(rng.randrange(3, 9)):
        if rng.random() < 0.3:
            lines.append(f"# comment {rng.randrange(100)}")
        toks = [rng.choice(words)]
        for _ in range(rng.randrange(0, 4)):
            k = rng.random()
            if k < 0.4:
                toks.append(str(rng.randrange(1, 9)))
            elif k < 0.7:
                toks.append(f"{rng.choice(['index', 'v1', 'transition'])}={rng.randrange(9)}")
            else:
                vals = ", ".join(str(rng.randrange(1, 9)) for _ in range(rng.randrange(0, 4)))
                toks.append(f"{rng.choice(['voters', 'learners', 'drop'])}=({vals})")
        lines.append(" ".join(toks))
        lines += [f"v{rng.randrange(1, 9)} r{rng.randrange(1, 9)}"
                  for _ in range(rng.randrange(0, 2))]
        lines.append("----")
        lines += [f"out {rng.randrange(1000)}" for _ in range(rng.randrange(0, 3))]
        lines.append("")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_datadriven_parser_equals_jax(seed, tmp_path):
    path = tmp_path / "case.txt"
    path.write_text(seeded_script(seed))
    j = [vars(c) for c in jdd.parse_file(str(path))]
    t = [vars(c) for c in tdd.parse_file(str(path))]
    assert j == t and j
    for c in j:
        line = path.read_text().splitlines()[c["line"] - 1]
        assert jdd.parse_directive(line) == tdd.parse_directive(line)
    assert (jdd.REFERENCE_ROOT, jdd.reference_available(), jdd.testdata("a", "b")) == \
        (tdd.REFERENCE_ROOT, tdd.reference_available(), tdd.testdata("a", "b"))
