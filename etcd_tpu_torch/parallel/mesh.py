"""The fixed-schedule round driver (etcd_tpu/parallel/mesh.py
build_scan_rounds) for one device.

The JAX driver scans ``rounds`` lockstep rounds on the device in one
program, with no host round trip between them. Its counterpart here, on a
CUDA device, is one CUDA graph that holds the ``rounds`` rounds: the first
call captures it over a static carry (copies of the caller's state, inbox
and per-round inputs) and each call replays it, so a run of rounds costs
one launch from the host instead of one per kernel. The graph's last
kernels copy the final state and inbox back into the carry, so the graph
can be replayed again on its own result. On the CPU the same rounds run as
a plain loop. The multi-device mesh is not ported yet.
"""
from __future__ import annotations

import collections

import torch

from etcd_tpu_torch.kernels import LAUNCHES
from etcd_tpu_torch.kernels import compact_wire
from etcd_tpu_torch.models.engine import build_round
from etcd_tpu_torch.types import Spec
from etcd_tpu_torch.utils.config import RaftConfig


class ScanRounds:
    """fn(state, inbox, prop_len, prop_data, prop_type, ri_ctx, do_hup,
    do_tick, keep_mask) -> (state, inbox) after ``rounds`` rounds.

    On a CUDA device the result IS the graph's static carry: the next call
    overwrites it, so a caller that keeps a result across calls clones it.
    ``captured`` counts the kernel launches each wrapper recorded into the
    graph (``kernels.LAUNCHES`` counts them once, at capture, where they
    are recorded and not run); ``replays`` counts the graph's replays, each
    of which runs every recorded launch once."""

    def __init__(self, cfg: RaftConfig, spec: Spec, rounds: int):
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        self.cfg, self.rounds = cfg, rounds
        self.round_fn = build_round(cfg, spec)
        self.graph = None
        self.state = self.inbox = self.args = None
        self.captured: collections.Counter = collections.Counter()
        self.replays = 0

    def __call__(self, state, inbox, *args):
        dev = state.rng_key.device
        if dev.type == "cpu":
            for _ in range(self.rounds):
                state, inbox = self.round_fn(state, inbox, *args)
            return state, inbox
        if dev.type != "cuda":
            raise ValueError(f"build_scan_rounds: no driver for device {dev}")
        if self.graph is None:
            self._capture(state, inbox, args)
        else:
            _load(self.state, state)
            _load(self.inbox, inbox)
            for dst, src in zip(self.args, args):
                if src is not dst:
                    dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        return self.state, self.inbox

    def release(self) -> None:
        """Drop the graph, its memory pool and the carry (the last result
        stays valid for whoever holds it); the counts stay. The next call
        captures anew."""
        self.graph = None
        self.state = self.inbox = self.args = None
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def _capture(self, state, inbox, args):
        self.state = state.map(lambda _, x: x.clone())
        self.inbox = inbox.map(lambda _, x: x.clone())
        self.args = tuple(a.clone() for a in args)
        if self.cfg.compact_wire:
            compact_wire._library()       # build and load before capture
        # one eager round on a side stream first, as CUDA graphs want:
        # lazily loaded kernels and allocator pools come up outside capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.round_fn(self.state, self.inbox, *self.args)
        torch.cuda.current_stream().wait_stream(side)
        _load(self.state, state)      # fleet_chunks > 1 rounds write in place
        _load(self.inbox, inbox)
        before = collections.Counter(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            st, ib = self.state, self.inbox
            for _ in range(self.rounds):
                st, ib = self.round_fn(st, ib, *self.args)
            _load(self.state, st)
            _load(self.inbox, ib)
        self.captured = collections.Counter(LAUNCHES)
        self.captured.subtract(before)


def _load(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` (skipping
    leaves that already are those tensors)."""
    for name, x in src.items():
        d = getattr(dst, name)
        if x is not d:
            d.copy_(x)


def build_scan_rounds(cfg: RaftConfig, spec: Spec, mesh=None,
                      rounds: int = 1) -> ScanRounds:
    """``rounds`` rounds per call on one device (the JAX driver with
    ``mesh=None``): a CUDA graph on a CUDA device, a loop on the CPU."""
    if mesh is not None:
        raise NotImplementedError("etcd_tpu_torch does not implement the "
                                  "multi-device mesh yet")
    return ScanRounds(cfg, spec, rounds)
