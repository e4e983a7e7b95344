"""The inbox compaction: wrappers, plain versions and build.

The function of the Pallas kernel experiments/pallas_compact.py, at its two
sites in the round:

* ``compact_wire_carry``, the JAX engine's round-boundary compaction
  (etcd_tpu/models/engine.py), which writes the compact wire (int16 under
  ``wire_int16``); its plain form is ``compact_wire_carry_plain``;
* ``compact_inbox_slots``, the in-round ``compact_inbox`` of
  etcd_tpu/models/raft.py over a node batch's delivered inbox slots, int32
  out; its plain form is ``compact_slots``.

On a CUDA tensor each wrapper launches the hand-written kernel in
compact_wire.cu and counts the launch in ``kernels.LAUNCHES`` under its own
key; on a CPU tensor it runs the plain form. Any other device, a layout the
kernel does not read, or a kernel that fails to build or launch, raises.

The kernel is built from the repository's source at first use with
``nvcc`` into ``_build/`` beside this file, as a shared library with a
plain C interface loaded through ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from etcd_tpu_torch.kernels import LAUNCHES
from etcd_tpu_torch.types import ENT_FIELDS, Msg, Spec

SOURCE = pathlib.Path(__file__).with_name("compact_wire.cu")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SLOTS = 32   # kMaxSlots in the source


def compact_slots(flat: Msg, B: int) -> Msg:
    """Leaves [S, N, (E,) C] -> the first ``B`` nonempty slots (type != 0)
    of each (N, C) column in slot order, [B, N, (E,) C]; output slots past
    the last nonempty one are all zero. A cumsum rank over the slot axis
    and a one-hot contraction, as the JAX functions compute it."""
    nonempty = flat.type != 0
    rank = torch.cumsum(nonempty.to(torch.int32), 0, dtype=torch.int32) - 1
    bs = torch.arange(B, dtype=torch.int32, device=rank.device).view(
        (B,) + (1,) * rank.dim())
    sel = (rank.unsqueeze(0) == bs) & nonempty.unsqueeze(0)    # [B, S, N, C]

    def take(_, x):
        s = sel if x.dim() == sel.dim() - 1 else sel.unsqueeze(3)
        if x.dtype == torch.bool:
            return (s & x.unsqueeze(0)).any(1)
        return (s.to(x.dtype) * x.unsqueeze(0)).sum(1, dtype=x.dtype)

    return flat.map(take)


def compact_wire_carry_plain(spec: Spec, msgs: Msg, bound: int,
                             out_dtype=torch.int32) -> Msg:
    """Keep-masked outbox [from, K, to, (E,) C] -> the first ``bound``
    nonempty slots per (receiver, cluster) in delivery order (from-major),
    stored [B, to(*E), C]. Integer leaves come out as ``out_dtype``."""
    S = spec.M * spec.K
    B = min(bound, S)
    C = msgs.type.shape[-1]
    flat = msgs.map(lambda _, x: x.reshape((S,) + x.shape[2:]))
    return compact_slots(flat, B).map(
        lambda _, x: x.reshape(B, -1, C).to(
            torch.bool if x.dtype == torch.bool else out_dtype))


def compact_wire_carry(spec: Spec, msgs: Msg, bound: int,
                       out_dtype=torch.int32) -> Msg:
    """The round-boundary compaction on the device ``msgs`` lies on: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Leaves
    [from, K, to, (E,) C] -> [B, to(*E), C]."""
    dev = msgs.type.device
    if dev.type == "cpu":
        return compact_wire_carry_plain(spec, msgs, bound, out_dtype)
    _check_cuda(dev, "compact_wire_carry")
    M, K, E = spec.M, spec.K, spec.E
    S = M * K
    C = msgs.type.shape[-1]
    _check_leaves(msgs, lambda name: (M, K, M) + ((E,) if name in ENT_FIELDS else ())
                  + (C,))
    flat = msgs.map(lambda _, x: x.view((S,) + x.shape[2:]))
    out = _launch(flat, min(bound, S), out_dtype)
    LAUNCHES["compact_wire"] += 1
    return out.map(lambda _, x: x.view(x.shape[0], -1, C))


def compact_inbox_slots(flat: Msg, B: int) -> Msg:
    """``compact_slots`` on the device ``flat`` lies on: the CUDA kernel with
    int32 output for a CUDA tensor (the in-round ``compact_inbox`` site),
    the plain version for a CPU tensor. Leaves [S, N, (E,) C], contiguous,
    int32 (``reject`` bool) -> [B, N, (E,) C]."""
    dev = flat.type.device
    if dev.type == "cpu":
        return compact_slots(flat, B)
    _check_cuda(dev, "compact_inbox_slots")
    S, N = flat.type.shape[:2]
    C = flat.type.shape[-1]
    E = flat.ent_term.shape[2]
    _check_leaves(flat, lambda name: (S, N) + ((E,) if name in ENT_FIELDS else ())
                  + (C,))
    out = _launch(flat, B, torch.int32)
    LAUNCHES["compact_inbox"] += 1
    return out


def _check_cuda(dev, where: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{where}: no kernel for device {dev}")


def _check_leaves(msgs: Msg, want_shape) -> None:
    """Every leaf a contiguous tensor of the shape the kernel reads, int32
    (``reject`` bool), on the device of ``type``."""
    dev = msgs.type.device
    for name, x in msgs.items():
        want = want_shape(name)
        dtype = torch.bool if name == "reject" else torch.int32
        if tuple(x.shape) != want or x.dtype != dtype or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"compact_wire kernel: leaf {name} must be a "
                             f"contiguous {dtype} {want} tensor on {dev}; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}"
                             f"{'' if x.is_contiguous() else ', not contiguous'}")


def _launch(flat: Msg, B: int, out_dtype) -> Msg:
    """The kernel on checked slots [S, N, (E,) C] -> [B, N, (E,) C]."""
    S, N = flat.type.shape[:2]
    C = flat.type.shape[-1]
    E = flat.ent_term.shape[2]
    if not 1 <= B <= S <= MAX_SLOTS:
        raise ValueError(f"compact_wire kernel takes 1 <= bound <= S <= "
                         f"{MAX_SLOTS}; got bound={B}, S={S}")
    if out_dtype not in (torch.int16, torch.int32):
        raise ValueError(f"compact_wire kernel writes int16 or int32, not {out_dtype}")
    dev = flat.type.device
    ins, outs = [], []
    bool_mask = ent_mask = 0
    for f, (name, x) in enumerate(flat.items()):
        if name == "reject":
            bool_mask |= 1 << f
        if name in ENT_FIELDS:
            ent_mask |= 1 << f
        ins.append(x)
        outs.append(torch.empty((B,) + tuple(x.shape[1:]), device=dev,
                                dtype=torch.bool if name == "reject" else out_dtype))
    ptrs = ctypes.c_void_p * len(ins)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _library().etcd_compact_wire(
            ptrs(*[t.data_ptr() for t in ins]), ptrs(*[t.data_ptr() for t in outs]),
            bool_mask, ent_mask, S, N, E, B, C,
            2 if out_dtype == torch.int16 else 4, stream)
    if rc != 0:
        raise RuntimeError(f"compact_wire kernel launch failed (code {rc})")
    return Msg(**{name: out for name, out in zip(Msg.names(), outs)})


def build() -> tuple[pathlib.Path, str]:
    """Compile compact_wire.cu for sm_90a unless a library built from the
    same source bytes, flags and nvcc version exists. Returns (library
    path, nvcc's output)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("compact_wire: nvcc not found (CUDA toolkit needed)")
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update("\0".join(NVCC_FLAGS + (version,)).encode())
    lib = BUILD_DIR / f"compact_wire_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"compact_wire: nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.etcd_compact_wire
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
