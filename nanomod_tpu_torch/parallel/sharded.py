# Port of nanomod_tpu/parallel/sharded.py: the shard_map step is a loop
# over the mesh's shards, and the ppermute halo exchange with the stencil
# assembly one launch of kernel K7 a card (csrc/stencil.cu), which reads the
# neighbours' boundary columns itself (over NVLink between cards that can
# reach each other, else from copies of those columns on its own card).
"""Position-sharded multi-device detection.

The position axis of each (chrom, strand) join is split into one
contiguous shard a device of the ('data', 'pos') mesh (parallel/mesh.py):

  * the battery components (K3) and, past the per-strand cap, the capped
    KS (K6) run on each shard's slice: rows are independent;
  * the only coupling between shards is the ±k neighbor p-value
    combination (ref myDetect.py:383): K7 assembles each shard's [2k+1, L]
    stencil on its card, reading the k boundary columns of (selected KS
    numerator, ne1, ne2, position, valid) of its neighbours straight from
    their inputs (or from copies of those k columns where two cards have
    no peer access), one launch for every shard of a card (the plain
    version copies the columns as halo blocks);
  * the float64 p-value transforms run on the host per shard, through the
    same stats.battery / stats.special code as the single-device path, so
    the sharded run is byte-identical to it.

The capped KS's draws are keyed by each row's absolute index in its join
(``row_offset + s * shard_len + i``), so they equal the single-device
tiling's.
"""

from __future__ import annotations

import numpy as np
import torch

from nanomod_tpu_torch.config import StatConfig
from nanomod_tpu_torch.device import to_device
from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.parallel.mesh import Mesh
from nanomod_tpu_torch.stats import battery, kernels, special

_PAD_POS = -(2 ** 30)


# ---------------------------------------------------------------------------
# K7: the neighbor stencil of every shard
# ---------------------------------------------------------------------------

# shards of one card that share a launch (csrc/stencil.cu kMaxShards: their
# descriptors travel in the kernel's parameters)
MAX_SHARDS_A_LAUNCH = 16


def stencil_payload(num, cap, n1c, n2c, pos, valid, cov: int):
    """[5, n] int32 rows (selected KS numerator, ne1, ne2, position, valid)
    of a run of columns: the capped numerator and min(n, cov) where either
    group exceeds ``cov`` (cov > 0), the plain ones otherwise."""
    if cov > 0:
        need = (n1c > cov) | (n2c > cov)
        num = torch.where(need, cap, num)
        n1c = torch.where(need, n1c.clamp(max=cov), n1c)
        n2c = torch.where(need, n2c.clamp(max=cov), n2c)
    return torch.stack([num, n1c, n2c, pos, valid.to(torch.int32)])


def stencil_plain(num, cap, n1c, n2c, pos, valid, left, right, *, k: int,
                  cov: int):
    """The [2k+1, L] stencil (d, ne1, ne2 int32, ok bool) of a shard from
    its [L] vectors and the [5, k] halo blocks of its neighbours (zeros at
    a mesh edge)."""
    length = num.shape[0]
    ext = torch.cat([left, stencil_payload(num, cap, n1c, n2c, pos, valid,
                                           cov), right], dim=1)
    valid = valid.to(torch.bool)
    rows = [], [], [], []
    for off in range(-k, k + 1):
        si = ext[:, k + off: k + off + length]
        if off == 0:
            ok = valid
        else:
            ok = (si[4] > 0) & valid & (si[3] - pos == off)
        for out, x in zip(rows, (si[0], si[1], si[2], ok)):
            out.append(x)
    return tuple(torch.stack(r) for r in rows)


def _shard_length(shards, k: int) -> int:
    """The shards' common length L; raises unless every shard has it and
    k <= L."""
    length = shards[0][0].shape[0]
    if any(sh[0].shape[0] != length for sh in shards):
        raise ValueError("every shard of a stencil step must have one "
                         "length")
    if k > length:
        raise ValueError(f"neighbor window {k} exceeds the shard length "
                         f"{length}")
    return length


def halos(shards, k: int, cov: int):
    """The (left, right) [5, k] halo blocks of every shard: ``shards`` lists
    each shard's (num, cap, n1c, n2c, pos, valid) [L] tensors on its
    device, in mesh order.  The k boundary columns of each neighbour's
    payload are copied to the shard's device; the mesh's two edges get
    zeros (valid 0)."""
    length = _shard_length(shards, k)

    def edge(s, cols, dev):
        if s < 0 or s >= len(shards):
            return torch.zeros((5, k), dtype=torch.int32, device=dev)
        return stencil_payload(*(t[cols] for t in shards[s]), cov).to(dev)

    return [(edge(s - 1, slice(length - k, length), sh[0].device),
             edge(s + 1, slice(0, k), sh[0].device))
            for s, sh in enumerate(shards)]


def sharded_stencil_plain(shards, k: int, cov: int):
    """Plain PyTorch twin of K7, the whole step: each shard's neighbour
    columns copied as [5, k] halo blocks (halos), then each shard's
    stencil (stencil_plain) on its device."""
    return [stencil_plain(*sh, left, right, k=k, cov=cov)
            for sh, (left, right) in zip(shards, halos(shards, k, cov))]


def _check_stencil_shard(sh, length):
    """The card index of a shard; raises unless its six [L] inputs are
    contiguous CUDA tensors of that card: five int32, valid bool or
    uint8."""
    card = sh[0].get_device()
    for i, t in enumerate(sh):
        want = t.dtype is torch.int32 if i < 5 else t.dtype in (torch.bool,
                                                                 torch.uint8)
        if (not want or t.get_device() != card or t.shape != (length,)
                or not t.is_contiguous()):
            raise ValueError("a shard's num, cap, n1c, n2c, pos (int32) and "
                             "valid (bool) must be contiguous [L] tensors on "
                             "one CUDA card")
    if card < 0:
        raise ValueError("sharded_stencil_cuda needs CUDA tensors")
    return card


def sharded_stencil_cuda(shards, k: int, cov: int):
    """K7 on CUDA shards: the whole step in one launch a card (a launch
    for each MAX_SHARDS_A_LAUNCH shards of a card that holds more), each
    shard reading its neighbours' columns itself: in place, over NVLink
    where a neighbour lies on another card that this card can reach (peer
    access, enabled once a pair of cards), else from a copy of the
    neighbour's k edge columns on its own card (``_stencil_step_cuda``).
    Returns each shard's (d, ne1, ne2, ok) [2k+1, L] on its card, as
    sharded_stencil_plain."""
    cards = sorted({sh[0].get_device() for sh in shards})
    staged = {(a, b) for a in cards for b in cards
              if a != b and not torch.cuda.can_device_access_peer(a, b)}
    return _stencil_step_cuda(shards, k, cov, staged)


def _staged_edge(shard, lo: int, hi: int, dev):
    """Columns lo..hi of a shard's six vectors, copied onto card ``dev``
    (a cross-device copy where the shard lies on another card), as the
    seven words of a K7 column descriptor: six pointers, then lo; and the
    tensors that hold them."""
    ints = torch.empty((5, hi - lo), dtype=torch.int32, device=dev)
    for row, t in zip(ints, shard[:5]):
        row.copy_(t[lo:hi])
    valid = shard[5][lo:hi].to(dev, copy=True)
    words = [row.data_ptr() for row in ints] + [valid.data_ptr(), lo]
    return words, (ints, valid)


def _stencil_step_cuda(shards, k: int, cov: int, staged=frozenset()):
    """K7's step, each shard reading the k edge columns of a neighbour in
    place, except where (the shard's card, the neighbour's card) is in
    ``staged``: there the columns are first copied onto the shard's card
    (after its stream has waited for the neighbour's) and read at their
    own offset.  sharded_stencil_cuda stages the pairs of cards that cannot
    reach each other; a pair of one card stages too, so that the route
    runs on one card."""
    length = _shard_length(shards, k)
    if (2 * k + 1) * length >= 2 ** 31 or 2 * k + 1 > 65535:
        raise ValueError("a shard's stencil must hold fewer than 2^31 "
                         "entries and at most 65,535 offsets")
    devs = [torch.device("cuda", _check_stencil_shard(sh, length))
            for sh in shards]
    nsh = len(shards)
    cards = {}
    for s, dev in enumerate(devs):
        cards.setdefault(dev, []).append(s)
    # the cards each card reads from: peer access where read in place, and
    # the reader's stream waits for the neighbour's work on those inputs
    reads = {dev: {devs[n] for s in idx for n in (s - 1, s + 1)
                   if 0 <= n < nsh and devs[n] != dev}
             for dev, idx in cards.items()}
    for dev, peers in reads.items():
        for peer in peers:
            if (dev.index, peer.index) not in staged:
                kbuild.enable_peer_access(dev, peer)
            torch.cuda.current_stream(dev).wait_stream(
                torch.cuda.current_stream(peer))
    keep = []  # the staged copies, alive until their launch is queued

    def side(s, n, lo, hi):
        """The seven words of shard s's neighbour n: its own pointers and
        column 0, a copy of its columns lo..hi, or nulls at a mesh edge."""
        if not 0 <= n < nsh:
            return [0] * 7
        if (devs[s].index, devs[n].index) not in staged:
            return [t.data_ptr() for t in shards[n]] + [0]
        words, held = _staged_edge(shards[n], lo, hi, devs[s])
        keep.append(held)
        return words

    cols = [[t.data_ptr() for t in shards[s]] + [0]
            + side(s, s - 1, length - k, length) + side(s, s + 1, 0, k)
            for s in range(nsh)]
    out = [None] * nsh
    rows = 2 * k + 1
    for dev, idx in cards.items():
        for lo in range(0, len(idx), MAX_SHARDS_A_LAUNCH):
            part = idx[lo: lo + MAX_SHARDS_A_LAUNCH]
            n = len(part)
            ints = torch.empty((3, n, rows, length), dtype=torch.int32,
                               device=dev)
            ok = torch.empty((n, rows, length), dtype=torch.bool, device=dev)
            table = np.array([cols[s] for s in part], dtype=np.uint64)
            step = n * rows * length * 4
            base = ints.data_ptr()
            kbuild.launch("stencil", "nm_stencil_step", dev,
                          table.ctypes.data, n, length, k, cov, base,
                          base + step, base + 2 * step, ok.data_ptr())
            kbuild.LAUNCHES["stencil"] += 1
            d, ne1, ne2 = (x.unbind(0) for x in ints.unbind(0))
            for s, *outs in zip(part, d, ne1, ne2, ok.unbind(0)):
                out[s] = tuple(outs)
    # a neighbour's card may reuse its inputs' memory only once the reads
    # from it have run
    for dev, peers in reads.items():
        for peer in peers:
            torch.cuda.current_stream(peer).wait_stream(
                torch.cuda.current_stream(dev))
    return out


def sharded_stencil(shards, k: int, cov: int):
    """The stencil of every shard (``shards``: each shard's (num, cap, n1c,
    n2c, pos, valid) [L] tensors on its device, in mesh order), each on
    its shard's device: the plain version when every shard lies on the
    CPU, kernel K7 when every shard lies on a card (raises if it cannot
    launch)."""
    kinds = {sh[0].device.type for sh in shards}
    if kinds == {"cpu"}:
        return sharded_stencil_plain(shards, k, cov)
    if kinds == {"cuda"}:
        return sharded_stencil_cuda(shards, k, cov)
    raise ValueError(f"the shards of a stencil step lie on {sorted(kinds)}: "
                     f"all on the CPU or all on CUDA cards")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _encode_shards(pool, values, counts, cap, spans, shard_len):
    """Each shard's [shard_len, cap] tile and [shard_len] int32 counts,
    encoded on the threads of ``pool``, a shard a task.  The tiles are
    those of battery._tile_slice over the whole join in one piece: int16
    milli values when every value of the join is an exact multiple of
    0.001 within int16 range (each shard is checked on its thread, the
    join is the AND of the shards), else the values' own type."""
    w = min(cap, values.shape[1])
    if values.dtype == np.int16:
        milli = [values[lo:hi, :w] for lo, hi in spans]
    else:
        milli = list(pool.map(
            lambda sp: battery._milli_values(values[sp[0]:sp[1], :w]),
            spans))
        if any(m is None for m in milli):
            milli = None

    def tile(s):
        lo, hi = spans[s]
        src = values[lo:hi, :w] if milli is None else milli[s]
        v = np.zeros((shard_len, cap), dtype=src.dtype)
        v[: hi - lo, :w] = src
        c = np.zeros(shard_len, dtype=np.int32)
        c[: hi - lo] = np.minimum(counts[lo:hi], cap)
        return v, np.maximum(c, 1)

    return list(pool.map(tile, range(len(spans))))


def sharded_join_battery(
    mesh: Mesh,
    values1: np.ndarray, counts1: np.ndarray,
    values2: np.ndarray, counts2: np.ndarray,
    positions: np.ndarray,
    strand: str = "+",
    cfg: StatConfig = StatConfig(),
    want_mstd: bool = False,
    combine: bool = True,
    row_offset: int = 0,
) -> battery.TestResult:
    """Full battery + neighbor combination for ONE (chrom, strand) join,
    position-sharded over ``mesh``.

    Drop-in for stats.battery.run_battery inside detect.detect_from_pools,
    plus the per-join combination, which equals the global one because the
    ±k stencil never crosses (chrom, strand) boundaries (pos_check
    invalidates such neighbors in both).  ``combine=True`` fills
    res.stcomb / res.pcomb when the config calls for a combination column;
    ``row_offset`` is the join-row index of this call's first row.

    The host's work runs a shard a thread: each shard's slice is encoded
    and copied to its device, and later finalized in float64, on a thread
    of its own; the kernels are launched from the calling thread."""
    from concurrent.futures import ThreadPoolExecutor

    p_total = len(counts1)
    battery._check_i32_bounds(counts1, counts2)
    nsh = mesh.size
    shard_len = _round_up(max(_round_up(p_total, nsh) // nsh, 8), 8)
    spans = [(min(s * shard_len, p_total), min((s + 1) * shard_len, p_total))
             for s in range(nsh)]

    c1 = battery._capacity_bucket(int(counts1.max(initial=1)))
    c2 = battery._capacity_bucket(int(counts2.max(initial=1)))
    n1 = counts1.astype(np.int32)
    n2 = counts2.astype(np.int32)
    cov = int(cfg.coverages[0 if strand == "+" else 1])
    capped = cov > 0 and bool(((n1 > cov) | (n2 > cov)).any())
    want_comb = (combine and cfg.test_method != "ks"
                 and cfg.neighbor_pvalues > 0)
    if want_comb and p_total and int(positions.max()) >= 2 ** 31:
        raise ValueError("a position overflows int32")

    def stencil_rows(s):
        """The shard's positions (padding at _PAD_POS) and valid flags."""
        lo, hi = spans[s]
        pos = np.full(shard_len, _PAD_POS, dtype=np.int32)
        pos[: hi - lo] = positions[lo:hi]
        return pos, np.arange(shard_len) < hi - lo

    def upload(s, t1, t2):
        """Shard s's tiles, its draws' absolute row index within the join
        (identical to the single-device tiling's) and its stencil rows,
        copied to its device."""
        dev = mesh.devices[s]
        arrays = list(t1 + t2)
        if capped:
            lo = row_offset + s * shard_len
            arrays.append(np.arange(lo, lo + shard_len, dtype=np.int32))
        if want_comb:
            arrays += stencil_rows(s)
        return [to_device(a, dev) for a in arrays]

    workers = max(1, min(nsh, battery._nthreads(), 8))
    with ThreadPoolExecutor(workers) as pool:
        tiles1 = _encode_shards(pool, values1, counts1, c1, spans, shard_len)
        tiles2 = _encode_shards(pool, values2, counts2, c2, spans, shard_len)
        is_milli = (tiles1[0][0].dtype == np.int16
                    and tiles2[0][0].dtype == np.int16)
        shards = list(pool.map(upload, range(nsh), tiles1, tiles2))

        # per shard, on its device: K3, K6 past the cap, the stencil's
        # inputs
        packed, caps, stencil_in = [], [], []
        for s, sh in enumerate(shards):
            v1d, cn1d, v2d, cn2d = sh[:4]
            if is_milli:
                pk = kernels.battery_components_packed_milli(v1d, cn1d, v2d,
                                                             cn2d)
            else:
                pk = kernels.battery_components_packed(v1d, cn1d, v2d, cn2d)
            packed.append(pk)
            cap = None
            if capped:
                cap = kernels.capped_ks_d(
                    v1d, cn1d, v2d, cn2d, sh[4], cov=cov,
                    repeats=cfg.downsampling,
                    quantile_idx=battery._quantile_idx(cfg),
                    seed=cfg.downsampling_seed)
            caps.append(cap)
            if want_comb:
                # uncapped, no row exceeds cov and the stencil never reads
                # the capped numerators: the plain ones stand in for them
                num = pk[0].view(torch.int32)
                stencil_in.append((num, num if cap is None else cap, cn1d,
                                   cn2d, *sh[-2:]))
        nb = (sharded_stencil(stencil_in, int(cfg.neighbor_pvalues), cov)
              if want_comb else None)

        # ---- host float64 finalization, a shard a thread ----
        out = {k: np.empty(p_total, np.float64)
               for k in ("stu", "pu", "stt", "pt", "stks", "pks")}
        mstd = np.empty((p_total, 4), np.float64) if want_mstd else None
        stcomb = np.empty(p_total, np.float64) if want_comb else None
        pcomb = np.empty(p_total, np.float64) if want_comb else None
        w = (special.stouffer_weights(cfg.neighbor_pvalues, cfg.weights_dif)
             if want_comb and cfg.test_method == "stouffer" else None)

        def finalize(s):
            lo, hi = spans[s]
            n_rows = hi - lo
            if n_rows <= 0:
                return
            cols = battery.finalize_packed(
                packed[s].cpu().numpy(), n_rows, n1[lo:hi], n2[lo:hi],
                None if caps[s] is None else caps[s].cpu().numpy(),
                cov, is_milli, want_mstd)
            for key in ("stu", "pu", "stt", "pt", "stks", "pks"):
                out[key][lo:hi] = cols[key]
            if want_mstd:
                mstd[lo:hi] = cols["mstd"]
            if want_comb:
                # neighbor p-values from the halo-exchanged exact
                # components, through the same f64 transform as the center
                # column (bit-identical: D = integer numerator / (ne1*ne2)
                # in f64)
                d_nb, ne1_nb, ne2_nb, ok_nb = (t[:, :n_rows].cpu().numpy()
                                               for t in nb[s])
                ne1m = ne1_nb.astype(np.float64)
                ne2m = ne2_nb.astype(np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    dm = d_nb.astype(np.float64) / (ne1m * ne2m)
                p_nb = special.clamp_p(special.ks_pvalue(dm, ne1m, ne2m))
                mat = np.where(ok_nb, p_nb, 1.0).T   # [n_rows, 2k+1]
                if cfg.test_method == "fisher":
                    st, pv = special.fisher_combine(mat, axis=1)
                else:
                    st, pv = special.stouffer_combine(mat, w, axis=1)
                stcomb[lo:hi] = special.clamp_stat(st)
                pcomb[lo:hi] = special.clamp_p(pv)

        list(pool.map(finalize, range(nsh)))

    return battery.TestResult(**out, stcomb=stcomb, pcomb=pcomb, mstd=mstd)
