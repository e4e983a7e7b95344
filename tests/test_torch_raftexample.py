"""The port's raftexample (etcd_tpu_torch/examples/raftexample.py) against
the JAX package's examples/raftexample.py: tests/test_raftexample.py's
operations on one Cluster(3), in order (elect, put, overwrite, drop and
heal, restart from storage, leader status), each node's kv, HardState,
applied, applied_hash and Status after each, and main()'s printed text,
equal to RAWNODE_PIN.json ("raftexample"); the slow twin runs the JAX
package live. Each test builds its own cluster."""
import json

import pytest
import torch

from etcd_tpu_torch.harness import rawnode_session as S

from make_rawnode_pins import jax_package
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

PIN = json.loads(S.PIN.read_text())


def test_raftexample_sequence_equals_pin():
    got = json.loads(json.dumps(S.run_raftexample(S.port_package("cpu"))))
    want = PIN["raftexample"]
    for g, w in zip(got["ops"], want["ops"]):
        assert g == w, f"after {w['op']}: port {g} JAX {w}"
    assert len(got["ops"]) == len(want["ops"])
    assert (got["main"], got["main_rc"]) == (want["main"], want["main_rc"])
    restart = want["ops"][-2]
    assert (restart["k1"], restart["k5"]) == ("v1", "v5")


@pytest.mark.slow
def test_raftexample_sequence_equals_jax_live():
    want = json.loads(json.dumps(S.run_raftexample(jax_package())))
    assert json.loads(json.dumps(S.run_raftexample(S.port_package("cpu")))) == want


def test_restart_replays_from_its_own_storage():
    """A node rebuilt from its MemoryStorage applies the committed entries
    again into a fresh kv (the raftexample replayWAL path), in a cluster
    this test builds."""
    p = S.port_package("cpu")
    c = p.Cluster(3)
    assert c.elect(0) == 0
    c.put("a", "1")
    c.put("b", "2")
    old = c.nodes[1]
    c.nodes[1] = reborn = p.RaftExampleNode(c.cfg, c.spec, 1, c.proposals,
                                            storage=old.storage)
    c.network.nodes = c.nodes
    c.settle()
    assert reborn.kv.data == {"a": "1", "b": "2"} == c.nodes[0].kv.data
    assert reborn.node.n.applied_hash == c.nodes[0].node.n.applied_hash


def test_cluster_and_main_default_to_cuda():
    from etcd_tpu_torch.examples import raftexample

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default does not raise here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        raftexample.Cluster(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        raftexample.main([])
