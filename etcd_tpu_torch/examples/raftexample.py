"""raftexample — a minimal replicated KV on the raw consensus core
(examples/raftexample.py, the JAX package's; the same program on the port).

The ``contrib/raftexample`` analog (kvstore.go + raft.go + httpapi.go):
the canonical "how to drive RawNode" program. N nodes each own a
``RawNode`` over a ``MemoryStorage``; the driver loop mirrors the
reference's raft.go serveChannels Ready cycle —

    rd = node.ready()
    save rd.hard_state + rd.entries to storage   (wal.Save analog)
    apply rd.snapshot if set
    send rd.messages over the network            (transport.Send)
    apply rd.committed_entries to the kv store
    node.advance(rd)

— with the in-process message exchange standing in for rafthttp (drop
is legal, so the dict-based network may lose messages under test
faults). Proposals carry int32 words resolved through a shared payload
table, exactly like the server runtime's payloadRef scheme.

Run: ``python -m etcd_tpu_torch.examples.raftexample [--device cpu]``
(3-node demo: elect, replicate a few puts, print each node's store). The
nodes' lanes run on the CUDA card unless ``--device`` (or ``device=``)
names another device.
"""
from __future__ import annotations

import argparse
import dataclasses

from etcd_tpu_torch.models.rawnode import RawNode, Ready
from etcd_tpu_torch.storage.raftstorage import (
    ConfState,
    MemoryStorage,
    Snapshot,
    SnapshotMeta,
)
from etcd_tpu_torch.types import ENTRY_NORMAL, ROLE_LEADER, Spec
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Proposal:
    key: str
    value: str


class KVStore:
    """kvstore.go: the applied state machine — a dict fed by committed
    entries; words resolve through the shared proposal table."""

    def __init__(self, proposals: dict[int, Proposal]):
        self.proposals = proposals
        self.data: dict[str, str] = {}
        self.applied_words: list[int] = []

    def apply(self, word: int) -> None:
        if word == 0:
            return  # empty (leader-election) entry
        p = self.proposals.get(word)
        if p is None:
            return  # foreign/unknown ref after a restart
        self.data[p.key] = p.value
        self.applied_words.append(word)

    def lookup(self, key: str) -> str | None:
        return self.data.get(key)


class RaftExampleNode:
    """raft.go raftNode: one member's RawNode + storage + kv bundle."""

    def __init__(self, cfg: RaftConfig, spec: Spec, nid: int,
                 proposals: dict[int, Proposal],
                 storage: MemoryStorage | None = None,
                 device=None):
        if storage is None:
            # bootstrap a fresh member with the initial voter set
            # (raftexample boots via raft.StartNode(peers); here the
            # voter ConfState arrives as the bootstrap snapshot meta)
            storage = MemoryStorage()
            storage.apply_snapshot(Snapshot(meta=SnapshotMeta(
                index=1, term=1,
                conf_state=ConfState(voters=tuple(range(spec.M))))))
        self.storage = storage
        applied = storage.snapshot().meta.index
        self.node = RawNode(cfg, spec, self.storage, nid, applied=applied,
                            device=device)
        self.kv = KVStore(proposals)
        self.nid = nid

    def process_ready(self, network: "Network") -> None:
        # serveChannels' Ready cycle (contrib/raftexample/raft.go)
        if not self.node.has_ready():
            return
        rd: Ready = self.node.ready()
        if rd.hard_state is not None:
            self.storage.set_hard_state(rd.hard_state)
        if rd.entries:
            self.storage.append(list(rd.entries))
        if rd.snapshot is not None:
            self.storage.apply_snapshot(rd.snapshot)
        for hm in rd.messages:
            network.send(hm)
        for e in rd.committed_entries:
            if e.type == ENTRY_NORMAL:
                self.kv.apply(e.data)
        self.node.advance(rd)


class Network:
    """The in-process rafthttp stand-in: per-node inboxes with optional
    drop masks (Send MUST NOT block / drop is OK)."""

    def __init__(self, nodes: dict[int, RaftExampleNode]):
        self.nodes = nodes
        self.inboxes: dict[int, list] = {n: [] for n in nodes}
        self.drop: set[tuple[int, int]] = set()  # (frm, to) pairs

    def send(self, hm) -> None:
        if (hm.frm, hm.to) in self.drop:
            return
        if hm.to in self.inboxes:
            self.inboxes[hm.to].append(hm)

    def deliver(self) -> int:
        moved = 0
        for nid, box in self.inboxes.items():
            msgs, self.inboxes[nid] = box, []
            for hm in msgs:
                self.nodes[nid].node.step(hm)
                moved += 1
        return moved


class Cluster:
    """The whole example: nodes + network + the httpapi-style front."""

    def __init__(self, n: int = 3, cfg: RaftConfig | None = None,
                 device=None):
        spec = Spec(M=max(n, 3), L=32, E=1, K=2, W=4, R=2, A=4)
        cfg = cfg or RaftConfig()
        self.spec, self.cfg = spec, cfg
        self.device = resolve_device(device)
        self.proposals: dict[int, Proposal] = {}
        self._next_word = 1
        self.nodes = {
            i: RaftExampleNode(cfg, spec, i, self.proposals, device=self.device)
            for i in range(n)
        }
        self.network = Network(self.nodes)

    # -- driver
    def pump(self, rounds: int = 1) -> None:
        for _ in range(rounds):
            for node in self.nodes.values():
                node.process_ready(self.network)
            self.network.deliver()

    def settle(self, max_rounds: int = 64) -> None:
        for _ in range(max_rounds):
            self.pump()
            if not any(self.inflight()):
                return

    def inflight(self):
        return [len(b) for b in self.network.inboxes.values()] + \
            [1 for n in self.nodes.values() if n.node.has_ready()]

    def elect(self, nid: int = 0) -> int:
        self.nodes[nid].node.campaign()
        self.settle()
        return self.leader()

    def leader(self) -> int:
        for i, n in self.nodes.items():
            if n.node.status().soft_state.role == ROLE_LEADER:
                return i
        return -1

    # -- httpapi.go front: PUT proposes, GET serves the local store
    def put(self, key: str, value: str) -> None:
        lead = self.leader()
        if lead < 0:
            raise RuntimeError("no leader")
        word = self._next_word
        self._next_word += 1
        self.proposals[word] = Proposal(key, value)
        self.nodes[lead].node.propose(word)
        self.settle()

    def get(self, key: str, nid: int = 0) -> str | None:
        return self.nodes[nid].kv.lookup(key)


def main(argv=None) -> int:
    """The demo: elect a leader, put three keys, print each node's store."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the device the lanes run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    c = Cluster(3, device=args.device)
    lead = c.elect(0)
    print(f"leader: node {lead}")
    for k, v in (("hello", "world"), ("foo", "bar"), ("x", "42")):
        c.put(k, v)
    for nid, node in sorted(c.nodes.items()):
        print(f"node {nid}: {dict(sorted(node.kv.data.items()))}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
