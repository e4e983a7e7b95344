"""The port's telemetry plane against the JAX package.

* ``telemetry_update`` on the rounds of one of the port's own chaos runs
  (C = 16, crash-restart faults, 2 fleet chunks, 25 rounds), each round's (telemetry
  in, state before, state after, restart and down masks) converted and fed
  to the JAX function under jax.jit: the plane's leaves equal after every
  round. From its end, a fault epoch with crashes in 2 chunks leaves equal
  state, wire, CrashState, key and counters with the planes on and off.
* The metered round of bench.py's steady program with both planes (and with
  each alone) against JAX's build_metered_round at C = 16: state, wire,
  counters, telemetry and ring leaves; the state equals the planes-off
  round's.
* The host side: hist_percentile, the report's "inf" strings, the
  flight_record wrap flag, the Prometheus render/parse round trip and its
  rejections, leaves with storage of their own, the Cluster's plane, and
  the drivers' exit 2 on bad TELEM* values.

Every leaf is an integer: exact equality, no tolerance.
"""
import collections
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.models import blackbox as jbb
from etcd_tpu.models import metrics as jmet
from etcd_tpu.models import telemetry as jtel
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import empty_msg as jempty_msg
from etcd_tpu_torch import bench, chaos_run, drive
from etcd_tpu_torch.convert import to_numpy
from etcd_tpu_torch.harness import chaos as tch
from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.models import blackbox as tbb
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import metrics as tmet
from etcd_tpu_torch.models import telemetry as ttel
from etcd_tpu_torch.utils.config import CrashConfig, MemberChaosConfig, RaftConfig
from etcd_tpu_torch.utils.tree import tree_clone

from test_torch_chaos import chaos_geometry, diff, jax_np, jcfg, jspec
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

JPre = collections.namedtuple("JPre", tbb.PRE_FIELDS)


def jtree(cls, struct):
    return cls(**{k: jnp.asarray(v) for k, v in to_numpy(struct).items()})


def jpre(pre):
    return JPre(**{k: jnp.asarray(v) for k, v in to_numpy(pre).items()})


def jmask(x):
    return None if x is None else jnp.asarray(x.numpy())


class Recorder:
    """Records each round of a port chaos run as the planes see it: the
    inbox the round consumed (caught at the ring's receive-side tally), and
    the carries in, the state before and after, the wire out and the crash
    flags (caught at the planes' step). Needs the black box on."""

    def __init__(self, monkeypatch):
        self.rounds = []
        self._inbox = None
        real_activity, real_steps = tch.msg_activity, tch._plane_steps

        def activity(spec, msg, side):
            if side == "recv":
                self._inbox = tree_clone(msg)
            return real_activity(spec, msg, side)

        def steps(spec, c, pre, state, recv, out, hit, alive, rst, gmask):
            self.rounds.append(dict(
                tele=tree_clone(c.tele), bb=tree_clone(c.bb.ring),
                write_mask=(c.bb.viol_round < 0).clone(), pre=tree_clone(pre),
                post=tree_clone(state), inbox=self._inbox, outbox=tree_clone(out),
                crashed=tree_clone(hit), restarted=tree_clone(rst),
                down=None if alive is None else ~alive))
            return real_steps(spec, c, pre, state, recv, out, hit, alive, rst, gmask)

        monkeypatch.setattr(tch, "msg_activity", activity)
        monkeypatch.setattr(tch, "_plane_steps", steps)


# the crash tier at C = 16 in 2 fleet chunks (the round writes into the state
# and inbox it is given), without delays, and a seed whose groups all have a
# leader after 25 rounds: short enough for the CPU
CHUNKED = dict(rounds=15, epoch_len=15, heal_len=10, seed=5, delay_p=0.0, crash_p=0.08,
               crash=CrashConfig(down_rounds=2))


@pytest.fixture(scope="module")
def chunked():
    spec, cfg = chaos_geometry()
    cfg = dataclasses.replace(cfg, fleet_chunks=2)
    mp = pytest.MonkeyPatch()
    rec = Recorder(mp)
    on = {}
    try:
        rep_on = tch.run_chaos(spec, cfg, C=16, telemetry=True, blackbox=True,
                               device="cpu", end=on, **CHUNKED)
    finally:
        mp.undo()
    return spec, cfg, rep_on, on, rec.rounds


def test_planes_leave_state_and_wire_alone_under_chunks_and_crashes(chunked):
    """From the run's end, one fault epoch of 6 rounds in 2 chunks with
    crashes (crash_p 0.3), with both planes and with none: equal state,
    wire, CrashState, key, counters and commit delta."""
    spec, cfg, rep_on, on, rounds = chunked
    assert rep_on["crashes_injected"] > 0 and rep_on["restarts_completed"] > 0
    assert len(rounds) == rep_on["rounds"] == rep_on["telemetry"]["rounds"]
    ops = tch.chaos_operands(spec, 0.02, 0.0, 0.1, 0.3, CrashConfig(down_rounds=2), 0.0,
                             MemberChaosConfig(), True, "cpu")[0]
    prop_len = torch.zeros((5, 16), dtype=torch.int32)
    prop_len[0] = 1
    prop_data = torch.full((5, 1, 16), 7, dtype=torch.int32)
    start = [on[n] for n in ("state", "inbox", "held", "crash", "key")]
    outs = {}
    for planes in (True, False):
        epoch = tch.build_chaos_epoch(cfg, spec, 6, with_delay=False, with_crash=True,
                                      with_telemetry=planes, with_blackbox=planes)
        carries = (tree_clone(on["tele"]), tree_clone(on["bb"])) if planes else (None, None)
        outs[planes] = epoch(*tree_clone(tuple(start)), prop_len, prop_data,
                             tch.zero_violations("cpu"), *carries, *ops)
    on_, off = outs[True], outs[False]
    for i, name in enumerate(("state", "inbox", "held", "crash", "key", "viol")):
        if on_[i] is None:
            assert off[i] is None, name
        elif isinstance(on_[i], torch.Tensor):
            assert torch.equal(on_[i], off[i]), name
        else:
            assert diff(tch_np(on_[i]), tch_np(off[i])) == [], name
    assert torch.equal(on_[8], off[8])
    crashes = on_[3].metrics.crashes_injected - on["crash"].metrics.crashes_injected
    assert int(crashes) > 0 and int(on_[6].round) == int(on["tele"].round) + 6


def tch_np(struct) -> dict:
    """Every tensor leaf of a (nested) tensor dataclass by dotted path."""
    out = {}
    for k, v in struct.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.numpy()
        else:
            out.update({f"{k}.{kk}": vv for kk, vv in tch_np(v).items()})
    return out


def test_telemetry_update_equals_jax_on_recorded_rounds(chunked):
    spec, _, _, _, rounds = chunked
    js = jspec(spec)
    jupd = jax.jit(jtel.telemetry_update, static_argnums=0)
    sampled = collections.Counter()
    for i, r in enumerate(rounds):
        got = ttel.telemetry_update(spec, r["tele"], r["pre"], r["post"],
                                    restarted=r["restarted"], down=r["down"])
        want = jupd(js, jtree(jtel.FleetTelemetry, r["tele"]), jpre(r["pre"]),
                    jtree(JNodeState, r["post"]), jmask(r["restarted"]), jmask(r["down"]))
        assert diff(jax_np(want), to_numpy(got)) == [], f"round {i}"
        for h in ("commit_hist", "elect_hist", "heal_hist"):
            sampled[h] += int(getattr(got, h)[-1] - getattr(r["tele"], h)[-1])
    # the run exercised every histogram and the restart clock
    assert all(sampled[h] > 0 for h in ("commit_hist", "elect_hist", "heal_hist")), sampled
    assert sum(int(r["restarted"].sum()) for r in rounds if r["restarted"] is not None) > 0


def test_init_telemetry_equals_jax_and_gives_each_leaf_its_own_storage(chunked):
    spec, _, _, on, _ = chunked
    state = on["state"]
    for buckets in (2, 8, 16):
        t = ttel.init_telemetry(spec, state, buckets)
        j = jtel.init_telemetry(jspec(spec), jtree(JNodeState, state), buckets)
        assert diff(jax_np(j), to_numpy(t)) == []
        ptrs = [x.untyped_storage().data_ptr() for _, x in t.items()]
        assert len(set(ptrs)) == len(ptrs)
        assert all(x.device == state.term.device for _, x in t.items())
    for bad in (1, 17):
        with pytest.raises(ValueError, match="outside"):
            ttel.init_telemetry(spec, state, bad)
    b = tbb.init_blackbox(spec, state)
    assert b.round.untyped_storage().data_ptr() != b.ring.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the metered round against JAX's
# ---------------------------------------------------------------------------

MC = 16


@pytest.fixture(scope="module")
def metered():
    """bench.py's steady program (immediate emission, dense state) at C =
    16 from a fleet the port settled, 4 metered rounds with both planes in
    both packages."""
    spec = drive.bench_spec()
    cfg = drive.steady_config(drive.settle_config(spec))
    st = teng.init_fleet(spec, MC, device="cpu")
    ib = teng.empty_inbox(spec, MC, True, cfg.inbox_bound, device="cpu")
    st, ib, _ = drive.settle_leaders(drive.settle_config(spec), spec, st, ib, device="cpu")
    args = drive.steady_inputs(spec, MC, "cpu")
    js = jspec(spec)
    # the JAX package caches its message template per spec at first use:
    # make that use eager, or the jit trace below would leave its tracers in
    # the cache for every later JAX call with this spec
    jempty_msg(js)
    jstep = jax.jit(jmet.build_metered_round(jcfg(cfg), js, with_telemetry=True,
                                             with_blackbox=True))
    jcarry = (jtree(JNodeState, st), jtree(JMsg, ib), *[jnp.asarray(a.numpy()) for a in args])
    jm = jmet.zero_metrics()
    jt = jtel.init_telemetry(js, jcarry[0])
    jb = jbb.init_blackbox(js, jcarry[0])
    tstep = tmet.build_metered_round(cfg, spec, with_telemetry=True, with_blackbox=True)
    bare = tmet.build_metered_round(cfg, spec)
    tstate, tinbox = st, ib
    tm, tt, tb = (tmet.zero_metrics("cpu"), ttel.init_telemetry(spec, st),
                  tbb.init_blackbox(spec, st))
    bstate, binbox, bm = tree_clone(st), tree_clone(ib), tmet.zero_metrics("cpu")
    out = []
    for _ in range(4):
        js_, ji_, jm, jt, jb = jstep(*jcarry, jm, jt, jb)
        jcarry = (js_, ji_, *jcarry[2:])
        tstate, tinbox, tm, tt, tb = tstep(tstate, tinbox, *args, tm, tt, tb)
        bstate, binbox, bm = bare(bstate, binbox, *args, bm)
        out.append(dict(j=(js_, ji_, jm, jt, jb), t=(tstate, tinbox, tm, tt, tree_clone(tb)),
                        bare=(tree_clone(bstate), tree_clone(binbox), bm)))
    return spec, cfg, st, ib, args, out


def test_metered_round_with_both_planes_equals_jax(metered):
    *_, out = metered
    for r, o in enumerate(out):
        for name, j, t in zip(("state", "inbox", "metrics", "telemetry", "ring"), o["j"],
                              o["t"]):
            assert diff(jax_np(j), to_numpy(t)) == [], f"round {r}: {name}"
        for name, a, b in zip(("state", "inbox", "metrics"), o["t"], o["bare"]):
            assert diff(to_numpy(a), to_numpy(b)) == [], f"round {r}: planes change {name}"
    tele = out[-1]["t"][3]
    assert int(tele.commit_hist[-1]) > 0 and int(tele.round) == 4
    assert int((out[-1]["t"][4].ring != 0).sum()) > 0


@pytest.mark.parametrize("plane", ["telemetry", "blackbox"])
def test_metered_round_with_one_plane_equals_both(metered, plane):
    spec, cfg, st, ib, args, out = metered
    one = tmet.build_metered_round(cfg, spec, **{f"with_{plane}": True})
    state, inbox, m = st, ib, tmet.zero_metrics("cpu")
    carry = ttel.init_telemetry(spec, st) if plane == "telemetry" else tbb.init_blackbox(spec, st)
    for o in out:
        planes = (carry,) if plane == "telemetry" else (None, carry)
        state, inbox, m, carry = one(state, inbox, *args, m, *planes)
        want = o["t"][3] if plane == "telemetry" else o["t"][4]
        assert diff(to_numpy(want), to_numpy(carry)) == []
        assert diff(to_numpy(state), to_numpy(o["t"][0])) == []


def test_metered_planes_under_fleet_chunks_equal_one_chunk(metered):
    """The round writes into its state and inbox in 2 chunks: the planes
    still read the state before it."""
    spec, cfg, st, ib, args, out = metered
    two = tmet.build_metered_round(dataclasses.replace(cfg, fleet_chunks=2), spec,
                                   with_telemetry=True, with_blackbox=True)
    state, inbox = tree_clone(st), tree_clone(ib)
    m, t, b = tmet.zero_metrics("cpu"), ttel.init_telemetry(spec, st), tbb.init_blackbox(spec, st)
    for o in out:
        state, inbox, m, t, b = two(state, inbox, *args, m, t, b)
        for name, want, got in zip(("state", "inbox", "metrics", "telemetry", "ring"),
                                   o["t"], (state, inbox, m, t, b)):
            assert diff(to_numpy(want), to_numpy(got)) == [], name


# ---------------------------------------------------------------------------
# the host side
# ---------------------------------------------------------------------------

HISTS = {
    "empty": [0, 0, 0, 0, 0],
    "low": [3, 5, 6, 6, 6],
    "spread": [1, 2, 4, 9, 10],
    "past the top": [0, 0, 1, 1, 8],
}


@pytest.mark.parametrize("case", sorted(HISTS))
@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_hist_percentile_equals_jax(case, q):
    h = HISTS[case]
    want = jtel.hist_percentile(np.asarray(h), q)
    assert ttel.hist_percentile(torch.tensor(h, dtype=torch.int32), q) == want
    assert ttel.hist_percentile(h, q) == want


def test_report_prints_inf_as_a_string_and_stays_strict_json(chunked):
    spec, _, _, on, _ = chunked
    tele = tree_clone(on["tele"])
    tele.commit_hist[:-1] = 0          # every sample past the top edge
    rep = ttel.telemetry_report(tele)
    assert rep["commit_latency_rounds"]["p50"] == "inf"
    assert rep == jtel.telemetry_report(jtree(jtel.FleetTelemetry, tele))
    text = json.dumps(rep, allow_nan=False)
    assert "Infinity" not in text and json.loads(text) == rep


def test_telemetry_report_and_flight_record_equal_jax(chunked):
    spec, _, rep_on, on, _ = chunked
    tele, crash = on["tele"], on["crash"]
    jt = jtree(jtel.FleetTelemetry, tele)
    for groups in (None, 5):
        assert ttel.telemetry_report(tele, groups) == jtel.telemetry_report(jt, groups)
    viol = tch.zero_violations("cpu").replace(lost_commit=torch.tensor(3, dtype=torch.int32))
    from etcd_tpu.harness import chaos as jch

    jviol = jch.zero_violations().replace(lost_commit=jnp.int32(3))
    jcm = jtree(jmet.CrashMetrics, crash.metrics)
    for args, jargs in (((), ()), ((viol,), (jviol,)), ((viol, crash.metrics), (jviol, jcm))):
        assert ttel.flight_record(tele, *args, kind="heal") == \
            jtel.flight_record(jt, *jargs, kind="heal")
    rows = rep_on["timeline"]
    assert [r["kind"] for r in rows][:2] == ["fault", "heal"]
    for a, b in zip(rows, rows[1:]):
        for k in ("round", "commit_sum", "leader_changes", "heal_rounds"):
            assert a[k] <= b[k], k
    assert not any(r["wrapped"] for r in rows)


def test_flight_record_flags_a_wrapped_counter_and_the_report_raises(chunked):
    spec, _, _, on, _ = chunked
    tele = tree_clone(on["tele"])
    tele.heal_rounds[0] = 2**31 - 1    # the int32 lane sum wraps negative
    tele.heal_rounds[1] = 5
    jt = jtree(jtel.FleetTelemetry, tele)
    row = ttel.flight_record(tele)
    assert row["wrapped"] and row == jtel.flight_record(jt)
    wrapped = tree_clone(on["tele"])
    wrapped.commit_sum.fill_(-7)
    assert ttel.flight_record(wrapped)["wrapped"]
    for t in (wrapped, tree_clone(on["tele"]).replace(
            leader_changes=torch.full((16,), -1, dtype=torch.int32))):
        with pytest.raises(OverflowError, match="wrapped"):
            ttel.telemetry_report(t)
        with pytest.raises(OverflowError, match="wrapped"):
            jtel.telemetry_report(jtree(jtel.FleetTelemetry, t))


class Contention:
    late_total = 4
    max_exceeded = 0.0123456789


def families(telemetry):
    summary = {"groups": 16, "groups_with_leader": 16, "commit_max": 40,
               "applied_max": 39, "lag_sum": 3, "commit_apply_lag_max": 2, "term_max": 5,
               "commit_apply_lag_hist": {"le_0": 10, "le_1": 14, "le_2": 16, "inf": 16}}
    slow = {"slow_apply_total": 2, "slow_read_indexes_total": 1}
    return summary, telemetry, Contention(), slow


def test_prometheus_families_and_text_equal_jax_and_round_trip(chunked):
    rep = ttel.telemetry_report(chunked[3]["tele"])
    args = families(rep)
    fams = ttel.server_metric_families(*args)
    assert fams == jtel.server_metric_families(*args)
    text = ttel.prometheus_render(fams)
    assert text == jtel.prometheus_render(fams)
    parsed = ttel.prometheus_parse(text)
    assert parsed == jtel.prometheus_parse(text)
    assert parsed["etcd_tpu_commit_latency_rounds"]["type"] == "histogram"
    again = ttel.prometheus_render([
        (name, f["type"], f["help"], [(s[len(name):], dict(lab), v)
                                      for (s, lab), v in f["samples"].items()])
        for name, f in parsed.items()])
    assert ttel.prometheus_parse(again) == parsed
    assert ttel.server_metric_families(args[0]) == jtel.server_metric_families(args[0])
    assert ttel.PROMETHEUS_CONTENT_TYPE == jtel.PROMETHEUS_CONTENT_TYPE


BAD_TEXT = {
    "no TYPE": "foo 1\n",
    "unknown type": "# TYPE foo gauge2\nfoo 1\n",
    "unparseable": "# TYPE foo gauge\nfoo\n",
    "no +Inf": "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_sum 1\nh_count 1\n",
    "not cumulative": ("# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"2\"} 1\n"
                       "h_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 2\n"),
    "count != +Inf": ("# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\n"
                      "h_count 3\n"),
    "no sum": "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_count 2\n",
    "bucket without le": ("# TYPE h histogram\nh_bucket 2\nh_bucket{le=\"+Inf\"} 2\n"
                          "h_sum 1\nh_count 2\n"),
}


@pytest.mark.parametrize("case", sorted(BAD_TEXT))
def test_prometheus_parse_rejects_what_jax_rejects(case):
    with pytest.raises(ValueError) as j:
        jtel.prometheus_parse(BAD_TEXT[case])
    with pytest.raises(ValueError) as t:
        ttel.prometheus_parse(BAD_TEXT[case])
    assert str(t.value) == str(j.value)


def test_render_writes_inf_and_floats_as_jax():
    fams = [("x", "gauge", "h", [("", {}, float("inf")), ("", {"a": "b"}, 0.5),
                                 ("", {}, True)])]
    assert ttel.prometheus_render(fams) == jtel.prometheus_render(fams)
    assert "+Inf" in ttel.prometheus_render(fams)
    assert math.isinf(ttel.prometheus_parse(
        "# TYPE x gauge\nx +Inf\n")["x"]["samples"][("x", ())])


def test_cluster_telemetry_refuses_packed_state_and_resets():
    with pytest.raises(ValueError, match="packed_state=False"):
        Cluster(3, C=2, cfg=RaftConfig(packed_state=True), telemetry=True, device="cpu")
    cl = Cluster(3, C=2, telemetry=True, device="cpu")
    cl.campaign(0)
    cl.campaign(1, c=1)
    cl.stabilize()
    rep = cl.telemetry_report()
    assert rep["leader_changes_total"] == 2 and rep["rounds"] == cl.tele.round.item()
    # the padding lanes (2 real lanes of 16) stay out of the aggregates
    assert cl.tele.leader_changes.shape == (16,)
    cl.reset_telemetry()
    assert cl.telemetry_report()["rounds"] == 0
    with pytest.raises(ValueError, match="telemetry=True"):
        Cluster(3, device="cpu").telemetry_report()


BAD_KNOBS = {
    "TELEM=2": ({"TELEM": "2"}, (bench, chaos_run)),
    "TELEM_BUCKETS=1": ({"TELEM_BUCKETS": "1"}, (bench, chaos_run)),
    "TELEM_BUCKETS=17": ({"TELEM_BUCKETS": "17"}, (bench, chaos_run)),
    "TELEM_BUCKETS=x": ({"TELEM_BUCKETS": "x"}, (bench, chaos_run)),
    # bench.py reads no TELEM_EVERY: it records no timeline
    "TELEM_EVERY=0": ({"TELEM_EVERY": "0"}, (chaos_run,)),
}


@pytest.mark.parametrize("case", sorted(BAD_KNOBS))
def test_drivers_exit_2_on_bad_telemetry_knobs(case, capsys):
    env, drivers = BAD_KNOBS[case]
    for drv in drivers:
        with pytest.raises(SystemExit) as e:
            drv.read_knobs(env)
        assert e.value.code == 2
        assert next(iter(env)) in capsys.readouterr().err


def test_driver_telemetry_defaults_are_bench_and_chaos_runs():
    k = bench.read_knobs({})
    assert (k.telem, k.telem_buckets, k.blackbox) == (True, 8, True)
    c = chaos_run.read_knobs({})
    assert (c["telemetry"], c["telemetry_buckets"], c["telemetry_every"]) == (True, 8, 1)
    assert (c["blackbox"], c["blackbox_k"], c["blackbox_window"]) == (False, 4, 32)
    assert chaos_run.read_knobs({"TELEM": "0"})["telemetry"] is False
