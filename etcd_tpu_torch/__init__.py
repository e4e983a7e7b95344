"""etcd_tpu_torch: the PyTorch/CUDA port of the batched Raft engine.

A second package beside ``etcd_tpu`` (the JAX reference, unchanged). It
imports torch and numpy only, never jax, flax or etcd_tpu, and mirrors the
JAX package's module paths so each function has a named counterpart. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
from etcd_tpu_torch.types import Spec
from etcd_tpu_torch.utils.config import RaftConfig

__all__ = ["Spec", "RaftConfig"]
