"""Request-scoped tracing — the pkg/traceutil analog (a copy of
etcd_tpu/utils/trace.py).

The reference threads a ``traceutil.Trace`` through the apply path
(`pkg/traceutil/trace.go:56-75` Trace/step, used from Put/Txn/Range at
`server/etcdserver/v3_server.go:602-610` and `mvcc/kvstore_txn.go`): each
request records named steps with timestamps and extra fields, and the
whole timeline is logged when total duration crosses a threshold. Device
rounds never trace per node (that would serialize the fleet); tracing
covers the HOST request pipeline: propose -> wait-applied -> apply ->
respond.
"""
from __future__ import annotations

import time


class Field:
    """traceutil.Field (trace.go:33-40)."""

    __slots__ = ("key", "value")

    def __init__(self, key: str, value):
        self.key = key
        self.value = value

    def format(self) -> str:
        return f"{self.key}:{self.value}; "


def _write_fields(fields) -> str:
    if not fields:
        return ""
    return "{" + "".join(f.format() for f in fields) + "}"


class Trace:
    """traceutil.Trace (trace.go:56-75): an operation with timestamped
    steps, dumped through the process logger if it ran long."""

    def __init__(self, operation: str, *fields: Field):
        self.operation = operation
        self.fields = list(fields)
        self.start_time = time.perf_counter()
        self.steps: list[tuple[float, str, tuple[Field, ...]]] = []
        self.is_empty = False

    @classmethod
    def todo(cls) -> "Trace":
        """traceutil.TODO: a non-nil, inert trace (trace.go:77-80)."""
        t = cls("")
        t.is_empty = True
        return t

    def step(self, msg: str, *fields: Field) -> None:
        if not self.is_empty:
            self.steps.append((time.perf_counter(), msg, fields))

    def add_field(self, *fields: Field) -> None:
        """Set-or-replace by key (trace.go AddField semantics)."""
        for f in fields:
            for i, old in enumerate(self.fields):
                if old.key == f.key:
                    self.fields[i] = f
                    break
            else:
                self.fields.append(f)

    def duration(self) -> float:
        return time.perf_counter() - self.start_time

    def format(self) -> str:
        """The dump layout of trace.go logInfo: header + per-step lines
        with deltas."""
        total_ms = self.duration() * 1e3
        lines = [
            f'trace[{id(self) & 0xFFFFFFFF}] {self.operation} '
            f'{_write_fields(self.fields)} (duration: {total_ms:.3f}ms)'
        ]
        prev = self.start_time
        for t, msg, fields in self.steps:
            lines.append(
                f'  step {msg} {_write_fields(fields)}'
                f' (+{(t - prev) * 1e3:.3f}ms)'
            )
            prev = t
        return "\n".join(lines)

    def to_span(self) -> dict:
        """A plain-dict span for exporters (blackbox.to_chrome_trace):
        relative step offsets in seconds, field values coerced to JSON
        primitives so the span survives json.dumps unmodified."""
        def prim(v):
            return v if isinstance(v, (bool, int, float, str,
                                       type(None))) else repr(v)

        return {
            "op": self.operation,
            "start": self.start_time,
            "dur": self.duration(),
            "fields": {f.key: prim(f.value) for f in self.fields},
            "steps": [
                {"ts": t - self.start_time, "msg": msg,
                 "fields": {f.key: prim(f.value) for f in fields}}
                for t, msg, fields in self.steps
            ],
        }

    def log_if_long(self, threshold_s: float = 0.1) -> bool:
        """Log the timeline if total duration exceeded the threshold (the
        warningApplyDuration dump rule, v3_server.go:602-610). Returns
        whether it logged."""
        if self.is_empty or self.duration() < threshold_s:
            return False
        from etcd_tpu_torch.utils.logging import get_logger

        get_logger().warning("%s", self.format())
        return True
