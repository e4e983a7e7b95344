"""The fleet telemetry plane (etcd_tpu/models/telemetry.py): per-group lanes,
latency histograms and the Prometheus exposition.

  * :class:`FleetTelemetry` rides beside the fleet through the rounds:
    per-group event lanes [C] (leader changes, snapshot installs, rounds
    with a member down or healing) and cumulative power-of-two-bucket
    histograms of propose->commit latency, election duration
    (candidate->leader) and post-crash heal time (restart->caught up), in
    rounds.
  * :func:`telemetry_update` is one function of the (pre, post) round
    states that every consumer calls (the metered round, the chaos epoch,
    the Cluster). It only reads the state, so a round with the plane on
    leaves every state and wire leaf as the round with it off.
  * the host side: percentiles, the report, the chaos flight recorder's
    timeline rows, and the Prometheus text form (render, parse, and the
    /metrics family list).

Propose->commit latency is measured with a birth ring [L, C] beside the
log cursor: the round each log index first appeared at the group's append
frontier. When the group's commit frontier passes an index, ``round -
birth`` is counted. The counters are int32 like the JAX package's and wrap
as its sums do; the reports detect a wrap by a negative value.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import (
    ROLE_CANDIDATE,
    ROLE_LEADER,
    ROLE_PRE_CANDIDATE,
    Spec,
    TensorStruct,
)

# power-of-two histogram edges 1, 2, 4, ..., 2^(buckets-1) rounds; the last
# histogram slot is the +Inf bucket (the sample count), the cumulative
# Prometheus convention of metrics.LAG_BUCKETS
DEFAULT_BUCKETS = 8

I32 = torch.int32


def pow2_edges(buckets: int) -> tuple:
    return tuple(1 << i for i in range(buckets))


@dataclasses.dataclass
class FleetTelemetry(TensorStruct):
    """The telemetry carry, int32 leaves. The ``birth_ring``, ``prev_*``
    and ``*_since`` leaves track transitions; they are not metrics."""

    round: torch.Tensor              # rounds observed
    leader_changes: torch.Tensor     # [C] rounds a new leader emerged
    snapshot_installs: torch.Tensor  # [C] MsgSnap installs (applied jump > A)
    heal_rounds: torch.Tensor        # [C] rounds with a member down or healing
    commit_hist: torch.Tensor        # [buckets+1] propose->commit rounds
    commit_sum: torch.Tensor
    elect_hist: torch.Tensor         # candidate->leader rounds
    elect_sum: torch.Tensor
    heal_hist: torch.Tensor          # restart->caught-up rounds
    heal_sum: torch.Tensor
    birth_ring: torch.Tensor         # [L, C] round each index was appended
    prev_last: torch.Tensor          # [C] group append frontier last round
    prev_commit: torch.Tensor        # [C] running max of the commit frontier
    cand_since: torch.Tensor         # [M, C] round candidacy began (-1 none)
    heal_since: torch.Tensor         # [M, C] round a restart completed (-1)


def init_telemetry(spec: Spec, state: NodeState,
                   buckets: int = DEFAULT_BUCKETS) -> FleetTelemetry:
    """Telemetry attached to a live (unpacked) fleet on its device. The
    prev_* leaves start at the current frontiers, so entries already in
    flight count their latency from the attach round. Every leaf has
    storage of its own (a CUDA graph's carry is loaded leaf by leaf)."""
    if not 2 <= buckets <= 16:
        raise ValueError(f"telemetry buckets={buckets} outside [2, 16]")
    C = state.term.shape[-1]
    dev = state.term.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    def neg():
        return torch.full((spec.M, C), -1, dtype=I32, device=dev)

    return FleetTelemetry(
        round=zeros(),
        leader_changes=zeros(C), snapshot_installs=zeros(C), heal_rounds=zeros(C),
        commit_hist=zeros(buckets + 1), commit_sum=zeros(),
        elect_hist=zeros(buckets + 1), elect_sum=zeros(),
        heal_hist=zeros(buckets + 1), heal_sum=zeros(),
        birth_ring=zeros(spec.L, C),
        prev_last=state.last_index.amax(0).to(I32),
        prev_commit=state.commit.amax(0).to(I32),
        cand_since=neg(), heal_since=neg(),
    )


def _hist_add(hist, total_sum, samples, mask):
    """Count the masked samples into the cumulative histogram (<= edge per
    bucket, +Inf last) and add their sum, as int32 that wraps. One pass per
    edge, so no [..., buckets] temporary is made."""
    edges = pow2_edges(hist.shape[0] - 1)
    counts = [((samples <= e) & mask).sum() for e in edges] + [mask.sum()]
    hist = hist + torch.stack(counts).to(I32)
    total_sum = total_sum + torch.where(mask, samples, 0).sum().to(I32)
    return hist, total_sum


def _any_groups(mask: torch.Tensor) -> torch.Tensor:
    return mask.any(0).to(I32)


def telemetry_update(spec: Spec, tele: FleetTelemetry, pre, post: NodeState,
                     restarted=None, down=None) -> FleetTelemetry:
    """One round's telemetry pass over the (unpacked) states before and
    after the round; reads only. ``pre`` needs ``role`` and ``applied``
    (a NodeState, or a snapshot of those leaves taken before a round that
    writes into its state). ``restarted`` and ``down`` ([M, C] bool or
    None) come from the chaos tier's crash bookkeeping: nodes whose
    restart completed this round (their heal clock starts), and nodes that
    are down (they count toward the group's heal_rounds)."""
    r = tele.round
    L = spec.L

    # propose->commit latency through the birth ring
    li = post.last_index.amax(0).to(I32)                          # [C]
    cm = post.commit.amax(0).to(I32)                              # [C]
    slots = torch.arange(L, dtype=I32, device=li.device).unsqueeze(1)
    # the log index at each ring slot under the frontier li (floor modulo,
    # engine.member_window_mask's cursor arithmetic)
    ent_idx = li - (li - 1 - slots) % L                           # [L, C]
    born = (ent_idx > tele.prev_last) & (ent_idx > 0)
    birth = torch.where(born, r, tele.birth_ring)
    # prev_commit is a running max: a commit frontier that legally regresses
    # across a persist-nothing crash must not count its entries again
    committed = (ent_idx > tele.prev_commit) & (ent_idx <= cm) & (ent_idx > 0)
    commit_hist, commit_sum = _hist_add(tele.commit_hist, tele.commit_sum,
                                        torch.clamp_min(r - birth, 0), committed)

    # election duration (candidate->leader rounds)
    is_cand = (post.role == ROLE_PRE_CANDIDATE) | (post.role == ROLE_CANDIDATE)
    cand_since = torch.where(is_cand & (tele.cand_since < 0), r, tele.cand_since)
    new_lead = (post.role == ROLE_LEADER) & (pre.role != ROLE_LEADER)
    elect_hist, elect_sum = _hist_add(
        tele.elect_hist, tele.elect_sum,
        torch.where(cand_since >= 0, r - cand_since, 0), new_lead)
    # leaving candidacy (won, or back to follower) clears the clock
    cand_since = torch.where(is_cand, cand_since, -1)

    # snapshot installs: the ring apply moves `applied` by at most Spec.A a
    # round, so a larger jump is a MsgSnap install; crash rewinds move it down
    inst = (post.applied - pre.applied) > spec.A

    # post-crash heal time (restart -> caught up to the commit frontier)
    heal_since = tele.heal_since
    if restarted is not None:
        heal_since = torch.where(restarted, r, heal_since)
    healed = (heal_since >= 0) & (post.commit >= cm)
    if down is not None:
        healed = healed & ~down
    heal_hist, heal_sum = _hist_add(tele.heal_hist, tele.heal_sum,
                                    torch.clamp_min(r - heal_since, 0), healed)
    heal_since = torch.where(healed, -1, heal_since)
    healing = heal_since >= 0
    if down is not None:
        healing = healing | down

    return FleetTelemetry(
        round=r + 1,
        leader_changes=tele.leader_changes + _any_groups(new_lead),
        snapshot_installs=tele.snapshot_installs + _any_groups(inst),
        heal_rounds=tele.heal_rounds + _any_groups(healing),
        commit_hist=commit_hist, commit_sum=commit_sum,
        elect_hist=elect_hist, elect_sum=elect_sum,
        heal_hist=heal_hist, heal_sum=heal_sum,
        birth_ring=birth,
        prev_last=li,
        prev_commit=torch.maximum(tele.prev_commit, cm),
        cand_since=cand_since, heal_since=heal_since,
    )


# ---------------------------------------------------------------------------
# host-side reporting
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hist_percentile(hist, q: float):
    """Percentile of a cumulative pow2 histogram: the smallest bucket upper
    bound that covers the fraction q of the samples (Prometheus
    histogram_quantile on integer buckets). None without samples;
    float('inf') when only the +Inf bucket covers it."""
    h = _host(hist)
    total = int(h[-1])
    if total == 0:
        return None
    target = q * total
    for i in range(len(h) - 1):
        if int(h[i]) >= target:
            return 1 << i
    return float("inf")


def _json_pctl(p):
    # past the top finite edge the percentile is the string "inf": json.dumps
    # would write float('inf') as the bare token Infinity, which strict JSON
    # parsers reject
    return "inf" if p == float("inf") else p


def _hist_block(hist, total_sum) -> dict:
    h = _host(hist)
    nb = len(h) - 1
    return {
        "hist": {**{f"le_{e}": int(c) for e, c in zip(pow2_edges(nb), h[:-1])},
                 "inf": int(h[-1])},
        "count": int(h[-1]),
        "sum": int(total_sum),
        "p50": _json_pctl(hist_percentile(h, 0.5)),
        "p99": _json_pctl(hist_percentile(h, 0.99)),
    }


LANES = ("leader_changes", "snapshot_installs", "heal_rounds")
HISTS = (("commit_hist", "commit_sum"), ("elect_hist", "elect_sum"),
         ("heal_hist", "heal_sum"))


def telemetry_report(tele: FleetTelemetry, groups: int | None = None) -> dict:
    """The report as a plain dict, from one narrow transfer: each [C] lane
    is reduced on its device (total, largest group, any negative) before
    the copy. ``groups`` keeps the first N lanes only (the Cluster's lane
    padding stays out of the aggregates). Raises OverflowError if a counter
    has wrapped."""
    reduced = []
    for name in LANES:
        v = getattr(tele, name)
        if groups is not None:
            v = v[:groups]
        if v.numel():
            reduced += [v.sum(), v.amax().long(), (v < 0).any().long()]
        else:
            reduced += [v.sum()] + [torch.zeros((), dtype=torch.int64, device=v.device)] * 2
    vals = torch.stack(reduced + [tele.round.long()]).tolist()
    hists = {h: _host(getattr(tele, h)) for pair in HISTS for h in pair}
    out = {"rounds": vals[-1]}
    wrapped = False
    for i, name in enumerate(LANES):
        total, top, neg = vals[3 * i: 3 * i + 3]
        out[f"{name}_total"] = total
        out[f"{name}_max_group"] = top
        wrapped |= bool(neg)
    out["commit_latency_rounds"] = _hist_block(hists["commit_hist"], hists["commit_sum"])
    out["election_duration_rounds"] = _hist_block(hists["elect_hist"], hists["elect_sum"])
    out["heal_latency_rounds"] = _hist_block(hists["heal_hist"], hists["heal_sum"])
    for h, s in HISTS:
        wrapped |= int(hists[h][-1]) < 0 or int(hists[s]) < 0
    if wrapped:
        raise OverflowError(
            "FleetTelemetry counter wrapped (i32); shorten the window or "
            "re-init telemetry per report window")
    return out


CRASH_ROW_KEYS = ("crashes_injected", "entries_lost_fsync", "restarts_completed",
                  "conf_changes_applied")


def flight_record(tele: FleetTelemetry, viol=None, crash_metrics=None,
                  kind: str = "") -> dict:
    """One row of the chaos flight recorder's timeline: the cumulative
    histograms, the lane totals (int32 sums, as the JAX row's), and the
    violation and crash counters at an epoch boundary. Consecutive rows are
    monotone non-decreasing per counter; a wrapped (negative) counter sets
    ``wrapped``. One transfer of the reduced values: the birth ring and
    the [M, C] clocks never leave the device."""
    parts = [tele.round.view(1)]
    for h, s in HISTS:
        parts += [getattr(tele, h), getattr(tele, s).view(1)]
    parts += [getattr(tele, name).sum().to(I32).view(1) for name in LANES]
    vkeys = list(viol.names()) if viol is not None else []
    parts += [getattr(viol, k).to(I32).view(1) for k in vkeys]
    if crash_metrics is not None:
        parts += [getattr(crash_metrics, k).to(I32).view(1) for k in CRASH_ROW_KEYS]
    vals = torch.cat(parts).tolist()
    nb = tele.commit_hist.shape[0]
    rec = {"kind": kind, "round": vals[0]}
    at = 1
    for h, s in HISTS:
        rec[h] = vals[at: at + nb]
        rec[s] = vals[at + nb]
        at += nb + 1
    for name in LANES:
        rec[name] = vals[at]
        at += 1
    rec["wrapped"] = (
        any(v < 0 for h, _ in HISTS for v in rec[h])
        or any(rec[k] < 0 for k in ("commit_sum", "elect_sum", "heal_sum") + LANES))
    if viol is not None:
        rec["violations"] = dict(zip(vkeys, vals[at: at + len(vkeys)]))
        at += len(vkeys)
    if crash_metrics is not None:
        rec.update(zip(CRASH_ROW_KEYS, vals[at:]))
    return rec


# ---------------------------------------------------------------------------
# the Prometheus exposition format (the /metrics wire form)
# ---------------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if v == float("inf"):
            return "+Inf"
        return repr(v)
    return str(v)


def prometheus_render(families) -> str:
    """Exposition text of metric families: (name, mtype, help, samples),
    each sample (suffix, labels, value), suffix "" for a counter or gauge
    and "_bucket"/"_sum"/"_count" for a histogram's series."""
    lines = []
    for name, mtype, help_text, samples in families:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for suffix, labels, value in samples:
            lab = ""
            if labels:
                lab = "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
            lines.append(f"{name}{suffix}{lab} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def histogram_samples(edges, cum_counts, count: int, total_sum) -> list:
    """The _bucket/_sum/_count samples of one histogram family from its
    cumulative bucket counts (+Inf is ``count``)."""
    out = [("_bucket", {"le": str(e)}, int(c)) for e, c in zip(edges, cum_counts)]
    out.append(("_bucket", {"le": "+Inf"}, int(count)))
    out.append(("_sum", {}, total_sum))
    out.append(("_count", {}, int(count)))
    return out


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def prometheus_parse(text: str) -> dict:
    """Exposition text back to families, checked: every sample belongs to a
    family with a # TYPE line (histogram series by their suffixes), and a
    histogram's buckets are cumulative and end in a +Inf bucket equal to
    its _count, beside a _sum. Returns {family: {"type", "help", "samples":
    {(series, ((label, value), ...)): float}}}."""
    fams: dict = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            fams.setdefault(name, {"samples": {}})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            name, _, mtype = line[len("# TYPE "):].partition(" ")
            if mtype not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {ln}: unknown metric type {mtype!r}")
            fams.setdefault(name, {"samples": {}})["type"] = mtype
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        sname, _, rawlab, rawval = m.groups()
        labels = dict(_LABEL.findall(rawlab)) if rawlab else {}
        value = float(rawval.replace("+Inf", "inf"))
        fam = sname
        if fam not in fams:
            for suf in ("_bucket", "_sum", "_count"):
                if sname.endswith(suf) and sname[: -len(suf)] in fams:
                    fam = sname[: -len(suf)]
                    break
        if fam not in fams or "type" not in fams[fam]:
            raise ValueError(f"line {ln}: sample {sname!r} has no # TYPE declaration")
        fams[fam]["samples"][(sname, tuple(sorted(labels.items())))] = value
    for name, fam in fams.items():
        if fam.get("type") != "histogram":
            continue
        raw = [(dict(k[1]).get("le"), v) for k, v in fam["samples"].items()
               if k[0] == name + "_bucket"]
        if any(le is None for le, _ in raw):
            raise ValueError(f"histogram {name} has a _bucket sample without an le label")
        buckets = sorted(raw, key=lambda kv: float(kv[0].replace("+Inf", "inf")))
        if not buckets or buckets[-1][0] != "+Inf":
            raise ValueError(f"histogram {name} missing +Inf bucket")
        counts = [v for _, v in buckets]
        if any(a > b for a, b in zip(counts, counts[1:])):
            raise ValueError(f"histogram {name} buckets not cumulative")
        cnt = fam["samples"].get((name + "_count", ()))
        if cnt is None or cnt != buckets[-1][1]:
            raise ValueError(f"histogram {name} +Inf bucket != _count")
        if (name + "_sum", ()) not in fam["samples"]:
            raise ValueError(f"histogram {name} missing _sum")
    return fams


def _hist_family(blk: dict, name: str, help_text: str):
    edges = [k[3:] for k in blk["hist"] if k.startswith("le_")]
    cum = [blk["hist"][f"le_{e}"] for e in edges]
    return (name, "histogram", help_text,
            histogram_samples(edges, cum, blk["count"], blk["sum"]))


def server_metric_families(summary: dict, telemetry: dict | None = None,
                           contention=None, slow: dict | None = None) -> list:
    """The /metrics family list: the reference's metric names over the
    fleet summary (models/metrics.py fleet_summary), the telemetry report's
    latency histograms when there is one, the etcd_tpu_* gauges, and the
    slow-request counters in ``slow`` ({"slow_apply_total",
    "slow_read_indexes_total"}); ``contention`` has ``late_total`` and
    ``max_exceeded``."""
    g = "gauge"

    def plain(v):
        return [("", {}, v)]

    fams = [
        ("etcd_server_has_leader", g, "Whether or not a leader exists (1 / 0).",
         plain(int(summary["groups_with_leader"] == summary["groups"]))),
        ("etcd_server_proposals_committed_total", g,
         "The total number of consensus proposals committed.",
         plain(summary["commit_max"])),
        ("etcd_server_proposals_applied_total", g,
         "The total number of consensus proposals applied.",
         plain(summary.get("applied_max", summary["commit_max"]))),
        ("etcd_server_proposals_pending", g,
         "The current number of pending proposals to commit.",
         plain(summary.get("lag_sum", 0))),
        ("etcd_server_leader_changes_seen_total", "counter",
         "The number of leader changes seen.",
         plain(telemetry["leader_changes_total"] if telemetry else 0)),
        ("etcd_tpu_groups", g, "Raft groups in the fleet.", plain(summary["groups"])),
        ("etcd_tpu_groups_with_leader", g, "Groups with >= 1 leader.",
         plain(summary["groups_with_leader"])),
        ("etcd_tpu_commit_max", g, "Max commit index across the fleet.",
         plain(summary["commit_max"])),
        ("etcd_tpu_commit_apply_lag_max", g, "Max commit-apply lag (entries).",
         plain(summary["commit_apply_lag_max"])),
        ("etcd_tpu_term_max", g, "Max term across the fleet.", plain(summary["term_max"])),
    ]
    lag_hist = summary.get("commit_apply_lag_hist")
    if lag_hist is not None:
        edges = [k[3:] for k in lag_hist if k.startswith("le_")]
        cum = [lag_hist[f"le_{e}"] for e in edges]
        fams.append((
            "etcd_tpu_commit_apply_lag_entries", "histogram",
            "Commit-apply lag across fleet nodes at scrape time (entries).",
            histogram_samples(edges, cum, lag_hist["inf"], summary.get("lag_sum", 0))))
    if telemetry is not None:
        for key, mname, help_text in (
            ("commit_latency_rounds", "etcd_tpu_commit_latency_rounds",
             "Propose-to-commit latency (lockstep rounds)."),
            ("election_duration_rounds", "etcd_tpu_election_duration_rounds",
             "Candidate-to-leader election duration (lockstep rounds)."),
            ("heal_latency_rounds", "etcd_tpu_heal_latency_rounds",
             "Crash-restart to caught-up heal time (lockstep rounds)."),
        ):
            fams.append(_hist_family(telemetry[key], mname, help_text))
        fams.append((
            "etcd_tpu_snapshot_installs_total", "counter",
            "Snapshot installs observed (applied-jump detector).",
            plain(telemetry["snapshot_installs_total"])))
    if slow is not None:
        fams.append((
            "etcd_server_slow_apply_total", "counter",
            "The total number of slow apply requests "
            "(likely overloaded from slow disk).",
            plain(int(slow.get("slow_apply_total", 0)))))
        fams.append((
            "etcd_server_slow_read_indexes_total", "counter",
            "The total number of pending read indexes not in sync with "
            "leader's or timed out read index requests.",
            plain(int(slow.get("slow_read_indexes_total", 0)))))
    if contention is not None:
        fams.append((
            "etcd_tpu_ticker_late_total", "counter",
            "Ticks later than the contention threshold.",
            plain(contention.late_total)))
        fams.append((
            "etcd_tpu_ticker_late_max_seconds", g, "Worst observed tick lateness.",
            plain(float(f"{contention.max_exceeded:.6f}"))))
    return fams
