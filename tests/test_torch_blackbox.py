"""The port's black-box plane, and both planes through run_chaos, against the
JAX package.

* ``run_chaos`` at C = 16 on the persist-nothing crash mix (it loses
  committed entries) with the telemetry plane and the black box: the report
  (``telemetry``, ``timeline`` and ``forensics`` key for key, forensics
  non-empty), the final state, wire and CrashState, and the plane leaves
  equal to the JAX run's.
* ``blackbox_update`` on every round of that port run, each round's (ring
  in, state before, state after, consumed and emitted wire, crash flags,
  write mask) converted and fed to the JAX function under jax.jit; the
  per-member message tallies against JAX's ``_msg_activity``.
* The on-violation reduction (first-K offenders, the [W, M, k] gather) and
  the host decode (words, timelines, violation names, ring captures, the
  Chrome trace) against JAX's; a Cluster's planes, which leave its rounds
  as they are; ``python -m etcd_tpu_torch.chaos_run`` with CHAOS_BLACKBOX=1;
  plane-carrying epochs make no host sync (CUDA-graph capturable).

Every leaf is an integer: exact equality, no tolerance.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.models import blackbox as jbb
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.utils.config import CrashConfig as JCrashConfig
from etcd_tpu_torch import chaos_run
from etcd_tpu_torch.convert import to_numpy
from etcd_tpu_torch.harness import chaos as tch
from etcd_tpu_torch.harness.cluster import Cluster as TCluster
from etcd_tpu_torch.models import blackbox as tbb
from etcd_tpu_torch.models import telemetry as ttel
from etcd_tpu_torch.utils.config import CrashConfig, MemberChaosConfig
from etcd_tpu_torch.utils.tree import tree_clone

from test_torch_chaos import (
    _HostTraffic,
    _jax_driver_keys,
    assert_same_run,
    chaos_geometry,
    diff,
    jax_np,
    jspec,
    run_both,
)
from test_torch_cluster import CFG, SPEC
from test_torch_crash import assert_same_crash_state
from test_torch_telemetry import Recorder, jmask, jpre, jtree
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

# the persist-nothing model on no drops or partitions and many crashes
# (tests/test_torch_crash.py's mix), in a fault epoch of 20 rounds and heal
# epochs of 10: 50 rounds in all at this seed
NOTHING = dict(rounds=20, epoch_len=20, heal_len=10, seed=2, drop_p=0.0, partition_p=0.0,
               delay_p=0.08, crash_p=0.12, crash=CrashConfig(down_rounds=2, durability="none"))


@pytest.fixture(scope="module")
def nothing():
    """The run in both packages with both planes (the one JAX epoch-program
    pair of these tests), the port's rounds recorded."""
    spec, cfg = chaos_geometry()
    mp = pytest.MonkeyPatch()
    rec = Recorder(mp)
    try:
        out = run_both(spec, cfg, 16, jax_kw={"crash": JCrashConfig(
            **{"down_rounds": 2, "durability": "none"})}, telemetry=True, blackbox=True,
            **NOTHING)
    finally:
        mp.undo()
    return spec, out, rec.rounds


def test_run_with_both_planes_equals_jax(nothing):
    _, (jrep, trep, jout, end), _ = nothing
    assert_same_run(jrep, trep, jout, end)
    assert list(trep) == list(jrep)
    assert_same_crash_state(jout[3], end["crash"])
    jtele, jbox = jout[6], jout[7]
    assert diff(jax_np(jtele), to_numpy(end["tele"])) == []
    assert diff(jax_np(jbox.ring), to_numpy(end["bb"].ring)) == []
    for leaf in ("viol_groups", "viol_round"):
        assert np.array_equal(np.asarray(getattr(jbox, leaf)), getattr(end["bb"], leaf).numpy())


def test_report_has_the_planes_sections_key_for_key(nothing):
    _, (jrep, trep, _, _), _ = nothing
    for key in ("telemetry", "timeline", "forensics"):
        assert trep[key] == jrep[key], key
    f = trep["forensics"]
    assert trep["lost_commit"] > 0 and f["groups_violating"] > 0
    assert f["captured"] and f["window"] == tbb.DEFAULT_WINDOW
    first = f["captured"][0]
    assert "lost_commit" in first["violations"]
    assert first["timeline"][-1]["round"] == first["first_violation_round"]
    events = {e for row in first["timeline"] for m in row["members"] for e in m["events"]}
    assert "crash" in events
    rows = trep["timeline"]
    assert rows[-1]["round"] == trep["rounds"]
    assert rows[-1]["violations"]["lost_commit"] == trep["lost_commit"]
    text = json.dumps(trep, allow_nan=False)
    assert json.loads(text) == json.loads(json.dumps(jrep))


def test_blackbox_update_equals_jax_on_recorded_rounds(nothing):
    spec, _, rounds = nothing
    js = jspec(spec)
    jupd = jax.jit(jbb.blackbox_update, static_argnums=0)
    for i, r in enumerate(rounds):
        got = tbb.blackbox_update(spec, tree_clone(r["bb"]), r["pre"], r["post"],
                                  inbox=r["inbox"], outbox=r["outbox"], crashed=r["crashed"],
                                  restarted=r["restarted"], down=r["down"],
                                  write_mask=r["write_mask"])
        want = jupd(js, jtree(jbb.EventRing, r["bb"]), jpre(r["pre"]),
                    jtree(JNodeState, r["post"]), jtree(JMsg, r["inbox"]),
                    jtree(JMsg, r["outbox"]), jmask(r["crashed"]), jmask(r["restarted"]),
                    jmask(r["down"]), jmask(r["write_mask"]))
        assert diff(jax_np(want), to_numpy(got)) == [], f"round {i}"
    ring = rounds[-1]["bb"].ring
    assert int(ring.min()) >= 0            # bit 31 stays clear
    # role changes, crashes, restarts, down flags, sends and receipts recorded
    for bit in (2, 14, 15, 16, 17, 21, 25, 28):
        assert int(((ring >> bit) & 1).sum()) > 0, bit


@pytest.mark.parametrize("side", ["outbox", "inbox"])
def test_msg_activity_equals_jax(nothing, side):
    spec, _, rounds = nothing
    js = jspec(spec)
    for r in rounds[::5]:
        msg = r[side]
        sent, recv, sent_cls, recv_cls = jbb._msg_activity(js, jtree(JMsg, msg))
        count, cls = (sent, sent_cls) if side == "outbox" else (recv, recv_cls)
        got_count, got_bits = tbb.msg_activity(spec, msg, "sent" if side == "outbox"
                                               else "recv")
        assert np.array_equal(np.asarray(count), got_count.numpy())
        bits = sum(np.asarray(cls[g]).astype(np.int32) << g for g in range(4))
        assert np.array_equal(bits, got_bits.numpy())
    with pytest.raises(ValueError, match="side"):
        tbb.msg_activity(spec, rounds[0]["inbox"], "both")


@pytest.mark.parametrize("k", [1, 4, 40])
def test_first_k_offenders_and_gather_equal_jax(nothing, k):
    _, (_, _, jout, end), _ = nothing
    bb = end["bb"]
    rng = np.random.default_rng(k)
    for mask in (bb.viol_groups != 0, torch.from_numpy(rng.random(16) < 0.3),
                 torch.zeros(16, dtype=torch.bool)):
        want = np.asarray(jbb.first_k_offenders(jnp.asarray(mask.numpy()), k))
        assert np.array_equal(want, tbb.first_k_offenders(mask, k).numpy())
    got = tbb.gather_forensics(bb.ring, bb.viol_groups, bb.viol_round, k)
    jbox = jout[7]
    want = jbb.gather_forensics(jbox.ring, jbox.viol_groups, jbox.viol_round, k)
    assert got["rings"].shape == (bb.ring.ring.shape[0], 5, min(k, 16))
    for name in ("ids", "rings", "bits", "viol_round", "total", "round"):
        assert np.array_equal(np.asarray(want[name]), got[name]), name
        assert np.asarray(want[name]).dtype == got[name].dtype, name
    assert tbb.forensics_report(bb.ring, bb.viol_groups, bb.viol_round, k) == \
        jbb.forensics_report(jbox.ring, jbox.viol_groups, jbox.viol_round, k)


def test_host_decode_equals_jax(nothing):
    _, (_, trep, _, end), _ = nothing
    rng = np.random.default_rng(0)
    for w in list(rng.integers(0, 2**31, 64)) + [0, 2**31 - 1]:
        d = tbb.decode_word(w)
        assert d == jbb.decode_word(w)
        assert tbb.word_events(d) == jbb.word_events(d)
    ring = end["bb"].ring
    lanes = ring.ring[:, :, 3].numpy()
    for e in (0, 5, 40, 100):
        assert tbb.ring_timeline(lanes, e) == jbb.ring_timeline(lanes, e)
    for bits in range(64):
        assert tbb.violation_names(bits) == jbb.violation_names(bits)
    assert tbb.VIOLATION_BIT_NAMES == tch.VIOLATION_KEYS == jbb.VIOLATION_BIT_NAMES
    assert (tbb.ROLE_NAMES, tbb.MSG_CLASSES) == (jbb.ROLE_NAMES, jbb.MSG_CLASSES)
    assert np.array_equal(tbb._CLASS_TABLE, jbb._CLASS_TABLE)
    jring = jtree(jbb.EventRing, ring)
    assert tbb.ring_capture(ring, [0, 7]) == jbb.ring_capture(jring, [0, 7])
    spans = [{"op": "put", "start": 10.0, "dur": 0.002, "fields": {"key": "a"},
              "steps": [{"msg": "propose", "ts": 0.001, "fields": {}},
                        {"msg": "apply", "ts": 0.0015}]},
             {"op": "get", "start": 10.5, "dur": 0.001}]
    caps = trep["forensics"]["captured"]
    want = jbb.to_chrome_trace(caps, spans, round_us=500)
    assert tbb.to_chrome_trace(caps, spans, round_us=500) == want
    assert tbb.to_chrome_trace() == jbb.to_chrome_trace()
    assert json.loads(json.dumps(want)) == want


def test_init_blackbox_checks_the_window(nothing):
    spec, (_, _, _, end), _ = nothing
    for w in (1, 257):
        with pytest.raises(ValueError, match="window"):
            tbb.init_blackbox(spec, end["state"], window=w)
    b = tch.empty_blackbox(spec, end["state"], window=2)
    assert b.ring.ring.shape == (2, 5, 16) and int(b.viol_round.min()) == -1


def test_cluster_planes_only_read_and_record_the_rounds():
    """A Cluster with both planes steps as one without them, and its planes
    hold what the rounds did: one leader change, the new term's empty entry
    committed, and per-round event words (a role change, sends and
    receipts)."""
    spec = dataclasses.replace(SPEC, M=3)
    cls = [TCluster(spec=spec, cfg=CFG, device="cpu", **kw)
           for kw in ({}, dict(telemetry=True, blackbox=True))]
    for cl in cls:
        cl.campaign(0)
        cl.stabilize()
    bare, planes = cls
    assert diff(to_numpy(bare.eng.state), to_numpy(planes.eng.state)) == []
    assert diff(to_numpy(bare.eng.inbox), to_numpy(planes.eng.inbox)) == []
    rep = planes.telemetry_report()
    assert rep["leader_changes_total"] == 1 and rep["commit_latency_rounds"]["count"] >= 1
    words = planes.bb.ring[: int(planes.bb.round), :, 0]
    assert int(((words >> 2) & 1).sum()) >= 1                  # role changes
    assert int((words >> 25).sum()) > 0 and int((words >> 17 & 0xF).sum()) > 0


def test_chaos_run_with_the_black_box_prints_forensics(monkeypatch, capsys):
    monkeypatch.setattr(chaos_run, "EPOCH_LEN", 2)
    monkeypatch.setattr(chaos_run, "HEAL_LEN", 2)
    for k, v in (("CHAOS_C", "4"), ("CHAOS_ROUNDS", "4"), ("CHAOS_BLACKBOX", "1"),
                 ("CHAOS_BLACKBOX_K", "2"), ("CHAOS_BLACKBOX_WINDOW", "8"),
                 ("TELEM_EVERY", "2")):
        monkeypatch.setenv(k, v)
    chaos_run.main([], device="cpu")
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep) == _jax_driver_keys() | {"forensics"}
    assert rep["forensics"]["window"] == 8 and rep["forensics"]["groups_violating"] == 0
    # every epoch is 2 rounds: a row at every second epoch boundary, and the
    # last boundary's row when it falls between
    n = rep["rounds"] // 2
    assert len(rep["timeline"]) == (n + 1) // 2 + (n % 2 == 0)
    assert [r["round"] for r in rep["timeline"]][-1] == rep["rounds"]


@pytest.mark.parametrize("faultless", [False, True])
def test_plane_epochs_make_no_host_sync(faultless):
    """A crash-tier epoch with both planes, fault and heal, in 2 fleet chunks:
    its rounds read no value on the host and copy no host data to a tensor
    (what a CUDA graph cannot capture), the ring slot included."""
    spec, cfg = chaos_geometry(C=8)
    cfg = dataclasses.replace(cfg, fleet_chunks=2)
    state = tch.init_fleet(spec, 8, device="cpu")
    carry = (state, tch.empty_inbox(spec, 8, cfg.wire_int16, device="cpu"),
             tch.empty_held(spec, 8, cfg.wire_int16, "cpu"), tch.empty_crash_state(state),
             tch.prng.prng_key(0, "cpu"))
    planes = (ttel.init_telemetry(spec, state), tch.empty_blackbox(spec, state))
    fault, heal = tch.chaos_operands(spec, 0.1, 0.2, 0.3, 0.3, CrashConfig(down_rounds=2),
                                     0.0, MemberChaosConfig(), True, "cpu")
    epoch = tch.build_chaos_epoch(cfg, spec, 2, faultless, with_crash=True,
                                  with_telemetry=True, with_blackbox=True)
    prop_len = torch.zeros((5, 8), dtype=torch.int32)
    prop_data = torch.zeros((5, 1, 8), dtype=torch.int32)
    watch = _HostTraffic()
    with watch:
        out = epoch(*carry, prop_len, prop_data, tch.zero_violations("cpu"), *planes,
                    *(heal if faultless else fault))
    assert not watch.seen, dict(watch.seen)
    assert int(out[6].round) == 2 and int(out[7].ring.round) == 2


@pytest.mark.parametrize("seed", range(2))
def test_check_invariants_masks_equal_jax(seed):
    """The per-group masks the forensics plane folds into its bitmask, on
    random leaves where every checker fires somewhere; the counters stay
    those of the call without masks."""
    from types import SimpleNamespace

    from etcd_tpu.harness import chaos as jch

    rng = np.random.default_rng(seed)
    M, C = 5, 64
    leaves = {"role": rng.choice([0, 3], (M, C), p=[0.7, 0.3]),
              "term": rng.integers(1, 4, (M, C)), "applied": rng.integers(0, 3, (M, C)),
              "applied_hash": rng.integers(0, 2, (M, C)), "commit": rng.integers(0, 5, (M, C))}
    leaves = {k: v.astype(np.int32) for k, v in leaves.items()}
    prev = rng.integers(0, 5, (M, C)).astype(np.int32)
    jv, jm = jch.check_invariants(SimpleNamespace(**{k: jnp.asarray(v) for k, v in leaves.items()}),
                                  jnp.asarray(prev), jch.zero_violations(), with_masks=True)
    tst = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in leaves.items()})
    tv, tm = tch.check_invariants(tst, torch.from_numpy(prev), tch.zero_violations("cpu"),
                                  with_masks=True)
    assert len(tm) == 3
    for j, t in zip(jm, tm):
        assert np.array_equal(np.asarray(j), t.numpy()) and t.any()
    plain = tch.check_invariants(tst, torch.from_numpy(prev), tch.zero_violations("cpu"))
    assert {k: int(v) for k, v in tv.items()} == {k: int(v) for k, v in plain.items()} == \
        {k: int(getattr(jv, k)) for k in tch.VIOLATION_KEYS}
