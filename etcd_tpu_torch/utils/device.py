"""Device selection for the port's entry points: the card unless the caller
asks for another device, never a silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("etcd_tpu_torch runs on a CUDA device by default and "
                           "none is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev
