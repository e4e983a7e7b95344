"""Pluggable logger — the raft.Logger analog (a copy of
etcd_tpu/utils/logging.py).

The reference exposes a small logging interface with default / discard
implementations and a process-wide ``SetLogger`` hook
(raft/logger.go:24-142), bridged to zap by the server
(server/etcdserver/zap_raft.go:102). The engine's hot path is pure
tensor math and never logs (by design — a log call per node per round
would serialize the fleet), so this logger serves the HOST layers: the
server runtime, storage recovery, harnesses and CLIs.

``Logger`` mirrors the reference surface (debug/info/warning/error/
fatal/panic, printf-style); ``set_logger`` swaps the process-wide
instance; ``DiscardLogger`` silences everything (raft/logger.go:90).
The default adapts to the stdlib ``logging`` module so embedders can
route through their own handlers.
"""
from __future__ import annotations

import logging as _pylog
import sys


class Logger:
    """raft.Logger (raft/logger.go:24-40)."""

    def debug(self, fmt: str, *args) -> None:
        raise NotImplementedError

    def info(self, fmt: str, *args) -> None:
        raise NotImplementedError

    def warning(self, fmt: str, *args) -> None:
        raise NotImplementedError

    def error(self, fmt: str, *args) -> None:
        raise NotImplementedError

    def fatal(self, fmt: str, *args) -> None:
        self.error(fmt, *args)
        sys.exit(1)

    def panic(self, fmt: str, *args) -> None:
        raise RuntimeError(fmt % args if args else fmt)


class DefaultLogger(Logger):
    """Bridges to the stdlib logging module (the zap bridge analog)."""

    def __init__(self, name: str = "etcd_tpu_torch"):
        self._log = _pylog.getLogger(name)

    def debug(self, fmt, *args):
        self._log.debug(fmt, *args)

    def info(self, fmt, *args):
        self._log.info(fmt, *args)

    def warning(self, fmt, *args):
        self._log.warning(fmt, *args)

    def error(self, fmt, *args):
        self._log.error(fmt, *args)


class DiscardLogger(Logger):
    """Drops everything (raft/logger.go:90-100)."""

    def debug(self, fmt, *args):
        pass

    def info(self, fmt, *args):
        pass

    def warning(self, fmt, *args):
        pass

    def error(self, fmt, *args):
        pass


_logger: Logger = DefaultLogger()


def set_logger(logger: Logger) -> None:
    """raft.SetLogger (raft/logger.go:60-66)."""
    global _logger
    _logger = logger


def get_logger() -> Logger:
    return _logger
