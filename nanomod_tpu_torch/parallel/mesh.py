# Port of nanomod_tpu/parallel/mesh.py: the mesh is a grid of torch
# devices, shard_map's psum / all_gather are sums and concatenations of
# shard tensors, and _accumulate is kernel K9 (csrc/accumulate.cu).
"""Device mesh: genome-coordinate parallel detection over torch devices.

The position axis of the battery inputs is sharded over a ('data', 'pos')
grid of devices (the system's analog of tensor parallelism) while read
batches stream data-parallel:

    mesh axes: ('data', 'pos')
      data: read batches; per-position accumulators of each data shard are
            summed across this axis
      pos:  genomic coordinates; pools [P, C] are split on P, shards taken
            in the grid's row-major order (the linearized ('data', 'pos')
            axis, so mesh neighbours are genome neighbours)

``make_mesh`` builds the grid over the process's CUDA devices and raises
when there are fewer than asked for.  Tests and chip_smoke.py set
``DEVICES``, the device list it takes instead, which may repeat a device
(eight shards on the CPU, four on one card): the counterpart of the JAX
tests' eight virtual CPU devices.  ``distributed_detect_step`` is the
self-contained demo step (K9 accumulation, sum over 'data', pooled rank
components on K3, gather of D); the production multi-device path is
parallel/sharded.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.stats import kernels


# the devices make_mesh builds a mesh over; None: every CUDA device of the
# process.  A test hook: a list here may repeat a device.
DEVICES: Optional[List] = None


class Mesh:
    """A ('data', 'pos') grid of torch devices.  ``devices`` lists them in
    row-major order: shard s of a position-sharded array lives on
    ``devices[s]``."""

    def __init__(self, devices: Sequence[torch.device], data: int):
        self.devices: List[torch.device] = list(devices)
        self.shape = {"data": data, "pos": len(self.devices) // data}

    @property
    def size(self) -> int:
        return len(self.devices)

    def data_devices(self) -> List[torch.device]:
        """The first device of each data row."""
        pos = self.shape["pos"]
        return [self.devices[d * pos] for d in range(self.shape["data"])]


def make_mesh(n_devices: Optional[int] = None, data: int = 0,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'pos') mesh over ``devices`` (default: ``DEVICES``,
    else every CUDA device of this process) of ``n_devices`` shards
    (default: all).

    ``data`` = size of the data axis (0 = auto: 2 if divisible, else 1).
    Raises ValueError when fewer devices exist than asked for."""
    if devices is None:
        devices = DEVICES
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(
            f"--n_devices {n} but only {len(devices)} CUDA device(s) "
            f"available; for CPU testing set parallel.mesh.DEVICES to a "
            f"device list, e.g. ['cpu'] * n")
    devices = devices[:n]
    if data == 0:
        data = 2 if n % 2 == 0 and n > 1 else 1
    pos = n // data
    return Mesh(devices[: data * pos], data)


def shard_pools_over_positions(mesh: Mesh, z, lab, n1, n2):
    """Split the battery inputs on the position axis over the whole mesh:
    one (z, lab, n1, n2) tuple a shard, on its device."""
    arrays = [torch.as_tensor(np.asarray(a)) for a in (z, lab, n1, n2)]
    parts = [torch.tensor_split(a, mesh.size) for a in arrays]
    return [tuple(p[s].to(dev) for p in parts)
            for s, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# K9: per-position (count, Σ, Σ²) of read events
# ---------------------------------------------------------------------------

def _flat_events(read_pos, read_val, read_ok):
    return (read_pos.reshape(-1), read_val.reshape(-1),
            read_ok.reshape(-1).to(torch.bool))


def accumulate_plain(read_pos, read_val, read_ok, genome_len: int):
    """Plain PyTorch twin of K9 (index_add_): (cnt, s1, s2) [genome_len]
    f32 over the events that are ok and inside the genome.  Positions index
    as the reference's scatter into [genome_len + 1] does: a negative one
    counts from the end (-1 is the dropped slot, -2 the last position)."""
    pos, val, ok = _flat_events(read_pos, read_val, read_ok)
    pos = pos.to(torch.int64)
    pos = torch.where(pos < 0, pos + genome_len + 1, pos)
    keep = ok & (pos >= 0) & (pos < genome_len)
    p = pos[keep]
    v = val[keep].to(torch.float32)
    out = []
    for src in (torch.ones_like(v), v, v * v):
        acc = torch.zeros(genome_len, dtype=torch.float32, device=v.device)
        out.append(acc.index_add_(0, p, src))
    return tuple(out)


def accumulate_cuda(read_pos, read_val, read_ok, genome_len: int):
    """Launch K9 on CUDA tensors; what accumulate_plain gives, the sums to
    f32 rounding (the atomics land in no fixed order)."""
    pos, val, ok = _flat_events(read_pos, read_val, read_ok)
    dev = pos.device
    if dev.type != "cuda" or val.device != dev or ok.device != dev:
        raise ValueError("accumulate_cuda needs CUDA tensors on one device")
    if pos.dtype != torch.int32 or val.dtype != torch.float32:
        raise ValueError(f"positions must be int32 and values float32, got "
                         f"{pos.dtype} and {val.dtype}")
    n = pos.numel()
    if val.numel() != n or ok.numel() != n:
        raise ValueError("read_pos, read_val and read_ok must match in size")
    if n >= 2 ** 31 or genome_len >= 2 ** 31:
        raise ValueError("events and genome length must stay below 2^31")
    pos, val, ok = pos.contiguous(), val.contiguous(), ok.contiguous()
    # [G, 4]: (count, sum, sum of squares, unused), one float4 a position
    acc = torch.zeros((genome_len, 4), dtype=torch.float32, device=dev)
    kbuild.launch("accumulate", "nm_accumulate", dev, pos.data_ptr(),
                  val.data_ptr(), ok.data_ptr(), n, genome_len,
                  acc.data_ptr())
    kbuild.LAUNCHES["accumulate"] += 1
    return acc[:, 0], acc[:, 1], acc[:, 2]


def accumulate(read_pos, read_val, read_ok, genome_len: int):
    """(cnt, s1, s2) on the device of ``read_pos``: the plain version for
    CPU tensors, kernel K9 for CUDA tensors (raises if it cannot launch)."""
    fn = accumulate_plain if read_pos.device.type == "cpu" else accumulate_cuda
    return fn(read_pos, read_val, read_ok, genome_len)


def distributed_detect_step(mesh: Mesh, genome_len: int, read_pos, read_val,
                            read_ok, z, lab, n1, n2):
    """One multi-device detection step:

      1. data-parallel accumulation of read events (K9 on the first device
         of each data row, reads split on axis 0 over 'data'), summed over
         the 'data' axis;
      2. position-sharded KS / rank components over the pooled layout
         (pooled_rank_components, K3's pooled entry on CUDA), a shard a
         device;
      3. the per-position D of every shard concatenated in shard order.

    Returns (cnt, s1, s2, d_all, trs, ties) on the mesh's first device:
    counts, sums and sums of squares [G], then D, two-rank sums and tie
    sums [P]."""
    home = mesh.devices[0]
    reads = [torch.as_tensor(np.asarray(a))
             for a in (read_pos, read_val, read_ok)]
    chunks = [torch.tensor_split(a, mesh.shape["data"]) for a in reads]
    cnt = s1 = s2 = None
    for d, dev in enumerate(mesh.data_devices()):
        part = accumulate(*(c[d].to(dev) for c in chunks),
                          genome_len=genome_len)
        part = [t.to(home) for t in part]
        if cnt is None:
            cnt, s1, s2 = part
        else:
            cnt, s1, s2 = cnt + part[0], s1 + part[1], s2 + part[2]
    outs = [kernels.pooled_rank_components(*shard)
            for shard in shard_pools_over_positions(mesh, z, lab, n1, n2)]
    d_all, trs, ties = (torch.cat([o[i].to(home) for o in outs])
                        for i in range(3))
    return cnt, s1, s2, d_all, trs, ties
