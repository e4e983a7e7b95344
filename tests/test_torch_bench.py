"""The port's metered round, scan driver and bench entry point.

* The metered round of bench.py's steady program (packed, deferred,
  sparse), 8 rounds with a drop case, equals the JAX metered round: the
  fleet, the wire and every FleetMetrics counter, and ``metrics_report``
  and ``fleet_summary`` give the JAX dicts.
* ``build_scan_rounds(rounds=4)`` on the CPU equals JAX's scan driver with
  ``mesh=None``, over two calls.
* The steady round is CUDA-graph capturable: it makes no host sync and
  builds no tensor from host data (checked on the CPU at the dispatcher).
* ``python -m etcd_tpu_torch.bench``'s main, run on the CPU at a tiny C,
  prints one JSON line with bench.py's keys at its defaults (the telemetry
  and black-box planes on), and refuses what it cannot run with exit 2.
All leaves and counters are integers: exact equality, no tolerance.
"""
import ast
import collections
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from etcd_tpu.models import engine as jeng
from etcd_tpu.models import metrics as jmetrics
from etcd_tpu.models import state as jstate
from etcd_tpu.parallel.mesh import build_scan_rounds as jscan
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch import bench, drive
from etcd_tpu_torch.convert import from_numpy, to_numpy
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import metrics as tmetrics
from etcd_tpu_torch.models.state import pack_fleet
from etcd_tpu_torch.parallel.mesh import build_scan_rounds

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
C = 8
SEED = 0

torch.set_num_threads(1)


def jax_config(cfg):
    return JRaftConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def jax_tree(cls, leaves: dict):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


@pytest.fixture(scope="module")
def start():
    """A fleet the port settled, packed in both packages, and the steady
    program's config and inputs."""
    spec = drive.bench_spec()
    cfg, steady = bench.configs(bench.read_knobs({"BENCH_C": str(C)}), spec)
    st = teng.init_fleet(spec, C, seed=SEED, device="cpu")
    ib = teng.empty_inbox(spec, C, True, cfg.inbox_bound, device="cpu")
    st, ib, _ = drive.settle_leaders(cfg, spec, st, ib, device="cpu")
    jspec = JSpec(**dataclasses.asdict(spec))
    # the JAX package caches its empty message at first use: make that use
    # eager, or a jit trace would leave its tracers in the cache
    jeng.empty_inbox(jspec, 1)
    jst = jstate.pack_fleet(jspec, jax_tree(jstate.NodeState, to_numpy(st)))
    return dict(spec=spec, jspec=jspec, cfg=cfg, steady=steady, dense=st,
                state=pack_fleet(spec, st), inbox=ib, jstate=jst,
                jinbox=jax_tree(JMsg, to_numpy(ib)),
                args=drive.steady_inputs(spec, C, "cpu"))


@pytest.fixture(scope="module")
def metered(start):
    """8 metered rounds in both packages, rounds 2 and 3 cutting member 2's
    links in every other group; per round (jax, port) of (state, wire,
    metrics) as numpy dicts."""
    s = start
    jmet = jax.jit(jmetrics.build_metered_round(jax_config(s["steady"]), s["jspec"]))
    tmet = tmetrics.build_metered_round(s["steady"], s["spec"])
    cut = s["args"][-1].clone()
    cut[2, :, ::2] = False
    cut[:, 2, ::2] = False
    js, ji, jm = s["jstate"], s["jinbox"], jmetrics.zero_metrics()
    ts, ti, tm = s["state"], s["inbox"], tmetrics.zero_metrics("cpu")
    rows = []
    for r in range(8):
        a = s["args"][:-1] + ((cut if r in (2, 3) else s["args"][-1]),)
        js, ji, jm = jmet(js, ji, *[x.numpy() for x in a], jm)
        ts, ti, tm = tmet(ts, ti, *a, tm)
        rows.append(((jax_np(js), jax_np(ji), jax_np(jm)),
                     (to_numpy(ts), to_numpy(ti), to_numpy(tm))))
    return rows, jm, tm


def test_metered_round_equals_jax_every_round(metered):
    rows, _, _ = metered
    for r, (j, t) in enumerate(rows):
        for what, a, b in zip(("state", "wire", "metrics"), j, t):
            assert diff(a, b) == [], f"round {r}: {what} leaves differ"
    last = rows[-1][1][2]
    assert last["rounds"] == 8 and last["msgs_dropped"] > 0 and last["commits"] > 0


@pytest.mark.slow
def test_dense_metered_round_equals_jax(start):
    """bench.py's own metered pass: the dense program of every message class
    and local step (bench.py's RaftConfig), 8 rounds with two of drops.
    Slow: the JAX program takes about 90 s to compile on one CPU core."""
    s = start
    jcfg = dataclasses.replace(jax_config(s["cfg"]), local_steps=JRaftConfig().local_steps,
                               message_classes=None, entry_classes=None)
    jmet = jax.jit(jmetrics.build_metered_round(jcfg, s["jspec"]))
    tmet = tmetrics.build_metered_round(s["cfg"], s["spec"])
    js, ji = jax_tree(jstate.NodeState, to_numpy(s["dense"])), s["jinbox"]
    ts, ti = s["dense"], s["inbox"]
    jm, tm = jmetrics.zero_metrics(), tmetrics.zero_metrics("cpu")
    cut = s["args"][-1].clone()
    cut[1, :, 1::2] = False
    for r in range(8):
        a = s["args"][:-1] + ((cut if r in (2, 3) else s["args"][-1]),)
        js, ji, jm = jmet(js, ji, *[x.numpy() for x in a], jm)
        ts, ti, tm = tmet(ts, ti, *a, tm)
        for what, x, y in (("state", js, ts), ("wire", ji, ti), ("metrics", jm, tm)):
            assert diff(jax_np(x), to_numpy(y)) == [], f"round {r}: {what}"
    assert jmetrics.metrics_report(jm, 1.0, C, 5) == tmetrics.metrics_report(tm, 1.0, C, 5)


def test_metered_round_under_fleet_chunks_equals_one_chunk(start):
    """The dense metered round with fleet_chunks = 2, which writes its
    results into the fleet it is given, counts what one chunk counts."""
    s = start
    one = tmetrics.build_metered_round(s["cfg"], s["spec"])
    two = tmetrics.build_metered_round(
        dataclasses.replace(s["cfg"], fleet_chunks=2), s["spec"])
    a = (s["dense"], s["inbox"], tmetrics.zero_metrics("cpu"))
    b = tuple(t.map(lambda _, x: x.clone()) for t in a)
    for r in range(4):
        a, b = one(*a[:2], *s["args"], a[2]), two(*b[:2], *s["args"], b[2])
        for x, y in zip(a, b):
            assert diff(to_numpy(x), to_numpy(y)) == [], f"round {r}"
    assert int(b[2].commits) > 0


def test_metrics_report_equals_jax(metered):
    _, jm, tm = metered
    for args in ((), (2.5, C, 5), (2.5, C)):
        assert tmetrics.metrics_report(tm, *args) == jmetrics.metrics_report(jm, *args)
    back = from_numpy(tmetrics.FleetMetrics, to_numpy(tm), "cpu")
    assert tmetrics.metrics_report(back, 1.0, C, 5) == jmetrics.metrics_report(jm, 1.0, C, 5)


def test_metrics_report_refuses_a_wrapped_counter():
    m = tmetrics.zero_metrics("cpu")
    m = m.replace(commits=torch.tensor(-5, dtype=torch.int32))
    with pytest.raises(OverflowError, match="wrapped"):
        tmetrics.metrics_report(m)


def test_fleet_summary_equals_jax(start):
    st = start["dense"]
    want = jmetrics.fleet_summary(jax_tree(jstate.NodeState, to_numpy(st)))
    assert tmetrics.fleet_summary(st) == want


def test_scan_rounds_equal_jax_scan(start):
    s = start
    jrun = jscan(jax_config(s["steady"]), s["jspec"], None, rounds=4)
    trun = build_scan_rounds(s["steady"], s["spec"], None, rounds=4)
    # the JAX driver donates its carry: hand it copies of the shared fleet
    js, ji = jax.tree.map(jnp.copy, (s["jstate"], s["jinbox"]))
    ts, ti = s["state"], s["inbox"]
    for call in range(2):
        js, ji = jrun(js, ji, *[x.numpy() for x in s["args"]])
        ts, ti = trun(ts, ti, *s["args"])
        assert diff(jax_np(js), to_numpy(ts)) == [], f"call {call}: state"
        assert diff(jax_np(ji), to_numpy(ti)) == [], f"call {call}: wire"


class _HostTraffic(TorchDispatchMode):
    """Counts the ops a CUDA graph cannot capture: a read of a tensor value
    on the host, and a tensor made from host data (a copy to the device)."""

    BAD = ("aten._local_scalar_dense", "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.BAD):
            self.seen[name] += 1
        return func(*args, **(kwargs or {}))


def test_steady_round_is_graph_capturable(start):
    s = start
    for cfg in (s["steady"], dataclasses.replace(s["steady"], fleet_chunks=2)):
        step = teng.build_round(cfg, s["spec"])
        watch = _HostTraffic()
        with watch:
            step(s["state"].map(lambda _, x: x.clone()),
                 s["inbox"].map(lambda _, x: x.clone()), *s["args"])
        assert not watch.seen, dict(watch.seen)


def _bench_keys() -> set:
    """The keys of bench.py's JSON line at its defaults (TELEM=1,
    BENCH_BLACKBOX=1), read from its source: the literal dicts in its main
    that hold "metric" or "bytes_per_group_state", the telemetry dict (the
    one that holds "telemetry_overhead_pct") and the ring's key set on it."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            ks = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if {"metric", "bytes_per_group_state", "telemetry_overhead_pct"} & ks:
                keys |= ks
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            t = node.targets[0]
            if isinstance(t.value, ast.Name) and t.value.id == "telemetry_extra":
                keys.add(t.slice.value)
    return keys


def test_bench_main_prints_bench_py_keys(monkeypatch, capsys):
    for k, v in (("BENCH_C", str(C)), ("BENCH_ROUNDS", "4"), ("BENCH_REPS", "1")):
        monkeypatch.setenv(k, v)
    assert bench.main([], device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-1])
    want = _bench_keys()
    assert "consensus_group_rounds_per_sec" == rep["metric"]
    assert {"msgs_dropped", "bytes_per_group_total", "vs_baseline"} <= want
    assert set(rep) == want
    assert rep["commits_per_group_per_round"] == 1.0
    assert rep["value"] > 0 and rep["elections_won"] == 0 and rep["msgs_dropped"] == 0
    assert rep["bytes_per_group_state"] == 1230 and rep["bytes_per_group_total"] == 1890
    assert rep["packed_state"] and rep["sparse_outbox"] and rep["fleet_chunks"] == 1


@pytest.mark.parametrize("env, argv, match", [
    ({"TELEM_BUCKETS": "17"}, [], "TELEM"),
    ({"BENCH_BLACKBOX": "yes"}, [], "BENCH_BLACKBOX"),
    ({"BENCH_WIRE16": "0"}, [], "BENCH_WIRE16"),
    ({"BENCH_SPARSE": "1", "BENCH_DEFERRED": "0"}, [], "BENCH_DEFERRED"),
    ({"BENCH_C": "0"}, [], "BENCH_C"),
    ({"BENCH_PACKED": "yes"}, [], "BENCH_PACKED"),
    ({}, ["--preflight"], "preflight"),
    ({"APPLY_MODE": "fast"}, [], "APPLY_MODE"),
    ({"APPLY_KEYS": "512"}, [], "APPLY_KEYS"),
    ({"APPLY_C": "0"}, [], "APPLY_C"),
])
def test_bench_refuses_what_it_cannot_run(monkeypatch, capsys, env, argv, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        bench.main(argv, device="cpu")
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_bench_knob_defaults_are_bench_py_accelerator_defaults():
    k = bench.read_knobs({})
    assert (k.C, k.inner, k.reps) == (1_048_576, 16, 3)
    assert k.packed and k.sparse and k.deferred and k.chunks == 1
    assert bench.read_knobs({"BENCH_PACKED": "0"}).chunks == 8
    assert not bench.read_knobs({"BENCH_DEFERRED": "0"}).sparse
