"""The fixed-schedule round driver (etcd_tpu/parallel/mesh.py
build_scan_rounds) for one device, and the CUDA-graph step it runs on.

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
import gc

import torch

from etcd_tpu_torch.kernels import LAUNCHES
from etcd_tpu_torch.models.engine import build_round
from etcd_tpu_torch.types import Spec
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.tree import tree_clone, tree_load


class CapturedStep:
    """``step(carry) -> carry`` on a CUDA device as one CUDA graph over a
    static carry (a tensor dataclass, or a tuple of them and of tensors).

    The first call runs ``warmup`` (default: ``step``) once eagerly on a side
    stream, as CUDA graphs want (kernels load and allocator pools come up
    outside capture), then captures ``step``; every call copies the given
    carry into the static one (skipping tensors that already are it),
    replays, and returns the static carry, which the next call overwrites.
    ``pool`` lets steps that never run at once share one memory pool.
    ``captured`` counts the kernel launches the wrappers recorded
    (``kernels.LAUNCHES`` counts them once, at capture, where they do not
    run); each of the ``replays`` runs every one of them once."""

    def __init__(self, step, warmup=None, pool=None):
        self.step, self.warmup, self.pool = step, warmup or step, pool
        self.graph = self.carry = None
        self.captured: collections.Counter = collections.Counter()
        self.replays = 0

    def __call__(self, carry):
        if self.graph is None:
            self._capture(carry)
        else:
            tree_load(self.carry, carry)
        self.graph.replay()
        self.replays += 1
        return self.carry

    def release(self) -> None:
        """Drop the graph, its memory pool and the carry (the last result
        stays valid for whoever holds it); the counts stay. The next call
        captures anew."""
        self.graph = self.carry = None
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def _capture(self, carry) -> None:
        self.carry = tree_clone(carry)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.warmup(self.carry)
        torch.cuda.current_stream().wait_stream(side)
        tree_load(self.carry, carry)     # the warm-up may write into the carry
        before = collections.Counter(LAUNCHES)
        # a collection inside the capture may free another graph, whose
        # destruction is a CUDA call that invalidates the capture: collect
        # now and hold the collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=self.pool):
                tree_load(self.carry, self.step(self.carry))
        finally:
            if collecting:
                gc.enable()
        self.captured = collections.Counter(LAUNCHES)
        self.captured.subtract(before)


class ScanRounds:
    """fn(state, inbox, prop_len, prop_data, prop_type, ri_ctx, do_hup,
    do_tick, keep_mask) -> (state, inbox) after ``rounds`` rounds.

    On a CUDA device the result IS the graph's static carry: the next call
    overwrites it, so a caller that keeps a result across calls clones it.
    ``captured`` and ``replays`` are the graph's (see CapturedStep); its
    eager warm-up is one round."""

    def __init__(self, cfg: RaftConfig, spec: Spec, rounds: int):
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        self.cfg, self.rounds = cfg, rounds
        self.round_fn = build_round(cfg, spec)
        self.graph = CapturedStep(self._run, warmup=self._one)

    def _one(self, carry):
        return self.round_fn(*carry)

    def _run(self, carry):
        state, inbox, *args = carry
        for _ in range(self.rounds):
            state, inbox = self.round_fn(state, inbox, *args)
        return (state, inbox, *args)

    def __call__(self, state, inbox, *args):
        dev = state.rng_key.device
        if dev.type == "cpu":
            return tuple(self._run((state, inbox, *args))[:2])
        if dev.type != "cuda":
            raise ValueError(f"build_scan_rounds: no driver for device {dev}")
        return tuple(self.graph((state, inbox, *args))[:2])

    @property
    def captured(self) -> collections.Counter:
        return self.graph.captured

    @property
    def replays(self) -> int:
        return self.graph.replays

    def release(self) -> None:
        self.graph.release()


def build_scan_rounds(cfg: RaftConfig, spec: Spec, mesh=None,
                      rounds: int = 1) -> ScanRounds:
    """``rounds`` rounds per call on one device (the JAX driver with
    ``mesh=None``): a CUDA graph on a CUDA device, a loop on the CPU."""
    if mesh is not None:
        raise NotImplementedError("etcd_tpu_torch does not implement the "
                                  "multi-device mesh yet")
    return ScanRounds(cfg, spec, rounds)
