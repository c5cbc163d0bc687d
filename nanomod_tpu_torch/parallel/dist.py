# Port of nanomod_tpu/parallel/dist.py: the collectives run over
# torch.distributed (gloo, CPU tensors) instead of jax.distributed;
# _encode_keys / _decode_keys and the merges are copies.
"""Multi-process orchestration over torch.distributed.

The reference scales across nodes by shelling qsub jobs at an SGE cluster
and polling qstat (ref bin/scripts/mySimulate.py:344-457).  Here one process
a rank runs under ``torch.distributed`` with the **gloo** backend on CPU
tensors (``python -m torch.distributed.run --nproc_per_node N -m
nanomod_tpu_torch.cli ...``):

  * FAST5 ingest is rank-local: each process reads its round-robin shard of
    the file list and builds partial position pools;
  * pools merge across ranks with a ragged allgather of packed observations
    before the battery, which each rank runs on its own device;
  * simulation grids and Annotate file lists shard the same way.

Everything that crosses between ranks is host numpy (key tables,
observations, count matrices, statistics), so gloo's CPU collectives carry
it, raw bytes included; NCCL would refuse two ranks on one card.  In one
process every helper is the identity, so the same code runs everywhere.
The merges take an injectable ``gather`` / ``process_count`` so that
thread fakes can run every rank's code path in one test process.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _world_size_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize():
    """Initialise the gloo process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when WORLD_SIZE > 1; a no-op
    otherwise or when the group exists.  Raises when gloo is unavailable:
    nothing falls back to a single process."""
    import torch.distributed as tdist

    if _world_size_env() <= 1:
        return
    if not tdist.is_available() or not tdist.is_gloo_available():
        raise RuntimeError("WORLD_SIZE > 1 but torch.distributed's gloo "
                           "backend is not available in this PyTorch build")
    if tdist.is_initialized():
        return
    tdist.init_process_group("gloo", init_method="env://",
                             rank=int(os.environ["RANK"]),
                             world_size=_world_size_env())


def shutdown():
    """Destroy the process group if one exists."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one.  A
    WORLD_SIZE above 1 without a process group raises: the caller forgot
    initialize(), and running as one process would be wrong."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    if _world_size_env() > 1:
        raise RuntimeError(
            f"WORLD_SIZE={_world_size_env()} but no torch.distributed "
            "process group: call nanomod_tpu_torch.parallel.dist."
            "initialize() first")
    return 0, 1


def rank_device(name="cuda") -> torch.device:
    """The device of this rank: with more than one process, ``cuda``
    without an index means cuda:{LOCAL_RANK % device_count} (every rank
    shares cuda:0 on a one-card machine), which becomes the process's
    current CUDA device; anything else is as given."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None and process_info()[1] > 1:
        n = torch.cuda.device_count()
        if n:
            dev = torch.device("cuda",
                               int(os.environ.get("LOCAL_RANK", 0)) % n)
            torch.cuda.set_device(dev)
    return dev


def shard_list(items: Sequence, process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> List:
    """Round-robin shard of a work list for this process (files, grid
    points); process id and count default to the process group's."""
    if process_id is None or process_count is None:
        rank, size = process_info()
        pid = rank if process_id is None else process_id
        pcount = size if process_count is None else process_count
    else:
        pid, pcount = process_id, process_count
    return [x for i, x in enumerate(items) if i % pcount == pid]


def _multihost_gather(x):
    """Concatenate every rank's (possibly different-length) array along
    axis 0, in rank order, over the gloo process group.

    all_gather needs identical shapes on every rank, so the local lengths
    are gathered first, axis 0 is padded to the global max, the padded
    arrays are gathered, and each rank's true prefix is sliced back out.
    Rows cross as raw bytes, so every dtype (f64, bool, int8) arrives
    exact."""
    import torch.distributed as tdist

    x = np.ascontiguousarray(x)
    size = tdist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    tdist.all_gather(lens, torch.tensor([x.shape[0]], dtype=torch.int64))
    lens = [int(t) for t in lens]
    m = max(lens, default=0)
    if m == 0:
        return x
    row = x.dtype.itemsize * int(np.prod(x.shape[1:], dtype=np.int64))
    pad = np.zeros((m, row), dtype=np.uint8)
    pad[: x.shape[0]] = x.view(np.uint8).reshape(x.shape[0], row)
    bufs = [torch.empty((m, row), dtype=torch.uint8) for _ in range(size)]
    tdist.all_gather(bufs, torch.from_numpy(pad))
    raw = np.concatenate([b.numpy()[:n] for b, n in zip(bufs, lens)])
    return raw.view(x.dtype).reshape((-1,) + x.shape[1:])


def _encode_keys(keys, width: int) -> np.ndarray:
    """(chrom, strand) tuples -> fixed-width uint8 rows (NUL padded):
    strings cross between ranks as bytes."""
    arr = np.zeros((len(keys), width), dtype=np.uint8)
    for i, (c, s) in enumerate(keys):
        b = f"{c}\t{s}".encode()
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return arr


def _decode_keys(rows: np.ndarray):
    out = set()
    for row in np.asarray(rows, dtype=np.uint8):
        b = row.tobytes().rstrip(b"\x00")
        if b:
            # strand is the single char after the LAST tab, so chrom names
            # containing tabs (legal in some FASTA headers) round-trip
            c, _, s = b.decode().rpartition("\t")
            out.add((c, s))
    return sorted(out)


def merge_pools_across_hosts(pools: Dict, gather=None,
                             process_count: Optional[int] = None,
                             max_capacity: int = 0):
    """Merge per-rank partial pools (accum.pools.PositionPools dicts) into
    identical full pools on every rank.

    One process: identity.  Several: the local pool set is flattened into
    four packed observation arrays (global-key id, position, value, base
    code) plus a byte-encoded key table and one width scalar, so the merge
    costs six gather() calls whatever the key and position counts, then is
    re-packed with PoolBuilder's grouping (pack_observations: the same
    majority-vote base, the same capacity-cap subsample).  Positions travel
    as int32 (genomic coordinates < 2^31)."""
    pc = process_info()[1] if process_count is None else process_count
    if pc == 1:
        return pools
    gather = gather or _multihost_gather
    from nanomod_tpu_torch.accum.pools import _BASE_TO_CODE, pack_observations

    # phase 1: agree on the global (chrom, strand) key table; the byte
    # width of its rows is agreed first (it differs per rank)
    local_keys = sorted(pools)
    local_w = max((len(f"{c}\t{s}".encode()) for c, s in local_keys),
                  default=0)
    width = int(gather(np.array([local_w], dtype=np.int32)).max(initial=1))
    keys = _decode_keys(gather(_encode_keys(local_keys, width)))
    gid = {key: i for i, key in enumerate(keys)}

    # phase 2: flatten local observations with global key ids
    kid, opos, oval, obase = [], [], [], []
    for key in local_keys:
        pp = pools[key]
        cnt = pp.counts
        mask = np.arange(pp.values.shape[1])[None, :] < cnt[:, None]
        opos.append(np.repeat(pp.positions, cnt))
        oval.append(pp.values[mask])
        codes = _BASE_TO_CODE[
            np.frombuffer(pp.base.astype("S1").tobytes(), dtype=np.uint8)]
        obase.append(np.repeat(codes, cnt))
        kid.append(np.full(int(cnt.sum()), gid[key], np.int32))

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.empty(0, dtype))

    g_kid = gather(cat(kid, np.int32))
    g_pos = gather(cat(opos, np.int32)).astype(np.int64)
    g_val = gather(cat(oval, np.float32))
    g_cod = gather(cat(obase, np.int8))

    # phase 3: re-pack per key with PoolBuilder semantics
    merged = {}
    for key in keys:
        sel = g_kid == gid[key]
        if not sel.any():
            continue
        merged[key] = pack_observations(
            key[0], key[1], g_pos[sel], g_val[sel], g_cod[sel],
            max_capacity=max_capacity)
    return merged


def merge_annotate_stats(n_ok: int, errors: Dict, hist: Dict,
                         gather=None, process_count: Optional[int] = None):
    """Merge per-rank Annotate statistics (ok count, error-taxonomy path
    lists, resegment-window histogram) so every rank reports the global
    totals, the analog of the reference parent polling its workers'
    failed_Q/reseg_Q (ref myRefBaseSignalAnnotation.py:1473-1494).  They
    cross as one JSON byte blob a rank through the ragged allgather."""
    pc = process_info()[1] if process_count is None else process_count
    if pc == 1:
        return n_ok, errors, hist
    gather = gather or _multihost_gather
    blob = json.dumps({
        "n_ok": int(n_ok),
        "errors": {k: list(v) for k, v in errors.items()},
        "hist": {str(k): int(v) for k, v in hist.items()},
    }).encode()
    lens = gather(np.array([len(blob)], dtype=np.int32))
    buf = np.frombuffer(blob, dtype=np.uint8)
    width = int(lens.max(initial=1))
    row = np.zeros((1, width), dtype=np.uint8)
    row[0, : len(blob)] = buf
    rows = gather(row)
    tot_ok, merged_err, merged_hist = 0, {}, {}
    for i in range(rows.shape[0]):
        d = json.loads(rows[i, : int(lens[i])].tobytes().decode())
        tot_ok += d["n_ok"]
        for k, v in d["errors"].items():
            merged_err.setdefault(k, []).extend(v)
        for k, v in d["hist"].items():
            merged_hist[int(k)] = merged_hist.get(int(k), 0) + v
    return tot_ok, merged_err, merged_hist


def ingest_group_multihost(folder: str, cfg):
    """Each rank reads its round-robin file shard of one group; the partial
    pools merge across ranks, so every rank returns the identical full
    pools."""
    from nanomod_tpu_torch.config import replace
    from nanomod_tpu_torch.detect import ingest_group
    from nanomod_tpu_torch.io.fast5 import iter_fast5_files

    files = shard_list(sorted(iter_fast5_files(folder)))
    # partial pools stay exact; the capacity cap applies once, at the merge
    # (a cap of a cap would not match the single-process subsample)
    partial = ingest_group(folder, replace(cfg, pool_capacity=0),
                           files=files)
    return merge_pools_across_hosts(partial,
                                    max_capacity=cfg.pool_capacity)
