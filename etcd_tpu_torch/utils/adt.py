"""pkg/adt parity: byte-affine intervals + an interval tree.

The reference implements a red-black interval tree
(pkg/adt/interval_tree.go) keyed by ``[begin, end)`` byte intervals with
an affine "infinite" endpoint for ``>= key`` ranges, consumed by the
auth range-permission cache (server/auth/range_perm_cache.go) and lease
checkpointing. The balancing strategy is an implementation detail; this
analog keeps the begin-sorted list + bisect (the stores here hold tens
of permissions, not millions of watch ranges) while matching the API
surface and semantics: Insert/Delete/Find/Intersects/Visit, plus the
coverage queries the auth cache is built on — ``contains`` is true when
the UNION of stored intervals covers the queried one, exactly
checkKeyInterval's walk over unified ranges.

The port's copy of etcd_tpu/utils/adt.py, which it imports nothing of.
"""
from __future__ import annotations

import bisect
import dataclasses


class _AffineInf:
    """The +inf endpoint (adt.BytesAffineComparable end sentinel)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "INF"


INF = _AffineInf()


def _le(a, b) -> bool:
    if a is INF:
        return b is INF
    if b is INF:
        return True
    return a <= b


def _lt(a, b) -> bool:
    return _le(a, b) and not (a is b or a == b)


@dataclasses.dataclass(frozen=True)
class Interval:
    """[begin, end); end may be INF (NewBytesAffineInterval with an
    all-0xff-free open end, adt/interval_tree.go:37-57)."""

    begin: bytes
    end: object  # bytes | INF

    def __post_init__(self):
        if self.end is not INF and not _lt(self.begin, self.end):
            raise ValueError(f"empty interval [{self.begin!r}, {self.end!r})")


def point(key: bytes) -> Interval:
    """NewBytesAffinePoint: [key, key+0x00)."""
    return Interval(key, key + b"\x00")


class IntervalTree:
    """Begin-sorted interval store with the adt.IntervalTree queries."""

    def __init__(self):
        self._begins: list[bytes] = []
        self._items: list[tuple[Interval, object]] = []

    def __len__(self) -> int:
        return len(self._items)

    def insert(self, ivl: Interval, val=None) -> None:
        i = bisect.bisect_left(self._begins, ivl.begin)
        self._begins.insert(i, ivl.begin)
        self._items.insert(i, (ivl, val))

    def delete(self, ivl: Interval) -> bool:
        for i, (stored, _) in enumerate(self._items):
            if stored == ivl:
                del self._begins[i]
                del self._items[i]
                return True
        return False

    def find(self, ivl: Interval):
        """Exact-interval lookup -> value (None if absent)."""
        for stored, val in self._items:
            if stored == ivl:
                return val
        return None

    def visit(self, ivl: Interval, fn) -> None:
        """Call fn(stored, val) for every stored interval intersecting
        ivl; stop early when fn returns False (adt nodeVisitor)."""
        for stored, val in self._items:
            if _lt(ivl.begin, stored.end) and _lt(stored.begin, ivl.end):
                if fn(stored, val) is False:
                    return

    def intersects(self, ivl: Interval) -> bool:
        found = False

        def f(stored, val):
            nonlocal found
            found = True
            return False

        self.visit(ivl, f)
        return found

    def contains(self, ivl: Interval) -> bool:
        """True iff the UNION of stored intervals covers ivl — the walk
        range_perm_cache.go:104-120 (checkKeyInterval) does over unified
        ranges: advance a cursor through overlapping intervals until the
        queried end is reached or a gap appears."""
        cursor = ivl.begin
        while True:
            best = None
            for stored, _ in self._items:
                if _le(stored.begin, cursor) and _lt(cursor, stored.end):
                    if best is None or _lt(best, stored.end):
                        best = stored.end
            if best is None:
                return False
            if _le(ivl.end, best):
                return True
            cursor = best

    def union(self) -> list[Interval]:
        """Merged (unified) intervals, begin-sorted."""
        out: list[Interval] = []
        for stored, _ in self._items:
            if out and _le(stored.begin, out[-1].end):
                if _lt(out[-1].end, stored.end):
                    out[-1] = Interval(out[-1].begin, stored.end)
            else:
                out.append(Interval(stored.begin, stored.end))
        return out
