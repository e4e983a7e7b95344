"""Device selection for the port's entry points: the card unless the caller
asks for another device, never a silent fall back to the CPU."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("etcd_tpu_torch runs on a CUDA device by default and "
                           "none is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev


def eager_mode(device):
    """The mode the port's rounds run in on ``device``: ``torch.inference_mode``
    on the CPU, where a round is thousands of small eager ops and autograd's
    version counters and view tracking, which nothing in the port reads, cost
    about a fifth of its time; no change on a card, where a round is a graph
    replay. A tensor made in the mode is not written in place outside it."""
    return torch.inference_mode(torch.device(device).type == "cpu")


def in_eager_mode(fn):
    """Run ``fn``, whose device comes as ``device=``, in ``eager_mode`` of it."""
    @functools.wraps(fn)
    def run(*a, device=None, **k):
        with eager_mode(resolve_device(device)):
            return fn(*a, device=device, **k)
    return run
