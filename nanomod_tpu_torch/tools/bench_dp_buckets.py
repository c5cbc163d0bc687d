"""The banded DP a read-length bucket on the card: the reference's
tools/bench_dp_buckets.py, on the port's kernels.

For each bucket (M, W), at B = 64 reads that are their reference window
with 10 % substitutions, it measures on the card:

    k1        K1 (csrc/banded_sw.cu) through banded_sw_cuda
    k1_plain  K1's plain PyTorch version (banded_sw_plain), once
    walk      K2 (csrc/walk.cu) through banded.walk, in the pipeline's
              mode (codes four a byte where 2M+W is a multiple of 4)
    pack      pack_outputs alone (plain PyTorch: a stack and a cat), beside
              pack_bound, its bytes (the codes and the three [B] outputs
              read once, the packed rows written once) over 3.35 TB/s
    pack_fetch  pack_outputs and the device-to-host copy of the packed
              codes, as dispatch_dp and fetch_outputs do

K1's outputs must equal its plain version's.  Kernel times are medians of
3 samples of 10 back-to-back launches between CUDA events, with the timing
code of kernels/ab_time.py; k1_plain and pack_fetch are one call each.
Prints the card's name and power limit, then one JSON line a bucket.

    python -m nanomod_tpu_torch.tools.bench_dp_buckets [M:W ...]

Default buckets: 2048:128 4096:128 8192:128 16384:128 4096:2048
4096:4096 (the last two above W = 1024: a block of warps a read).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B = 64
# an H100 SXM's HBM3 rate at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
DEFAULT = ((2048, 128), (4096, 128), (8192, 128), (16384, 128),
           (4096, 2048), (4096, 4096))


def reads(m, w, seed=0):
    rng = np.random.default_rng(seed)
    read_codes = rng.integers(0, 4, (B, m)).astype(np.uint8)
    ref_codes = rng.integers(0, 4, (B, m + w)).astype(np.uint8)
    lens = np.full(B, m, np.int32)
    # plant similarity so that tracebacks have a realistic length
    ref_codes[:, w // 2: w // 2 + m] = np.where(
        rng.random((B, m)) < 0.9, read_codes,
        ref_codes[:, w // 2: w // 2 + m])
    return read_codes, ref_codes, lens


def bench_bucket(torch, m, w):
    from nanomod_tpu_torch.kernels.ab_time import _time_ms
    from nanomod_tpu_torch.resquiggle import banded
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    dev = torch.device("cuda", 0)
    rd, rf, ln = (torch.from_numpy(x).to(dev) for x in reads(m, w))
    out = {"bucket": m, "W": w, "batch": B}
    got = banded_sw_cuda(rd, rf, ln)
    out["k1_ms"] = _time_ms(torch, lambda: banded_sw_cuda(rd, rf, ln), 10)
    t0 = time.perf_counter()
    want = banded.banded_sw_plain(rd, rf, ln)
    torch.cuda.synchronize()
    out["k1_plain_ms"] = (time.perf_counter() - t0) * 1e3
    out["k1_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
    if not out["k1_equal"]:
        raise AssertionError(f"K1 differs from its plain version at M {m}, "
                             f"W {w}")
    tb, best, bi, bk = got
    codes, packed = banded.walk(tb, bi, bk)
    out["walk_mode"] = "codes2" if packed else "codes"
    out["walk_ms"] = _time_ms(torch, lambda: banded.walk(tb, bi, bk), 10)

    out["pack_ms"] = _time_ms(
        torch, lambda: banded.pack_outputs(codes, best, bi, bk), 10)
    packed_bytes = codes.numel() + 12 * B
    out["pack_bound_ms"] = 2 * packed_bytes / HBM_BYTES_PER_S * 1e3

    def pack_fetch():
        p = banded.pack_outputs(codes, best, bi, bk)
        host = torch.empty(p.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(p, non_blocking=True)
        torch.cuda.synchronize()
        return host
    pack_fetch()
    t0 = time.perf_counter()
    pack_fetch()
    out["pack_fetch_ms"] = (time.perf_counter() - t0) * 1e3
    out["mean_best"] = float(best.mean())
    return out


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench_dp_buckets needs a CUDA card")
    buckets = [tuple(int(x) for x in a.split(":")) for a in argv] or DEFAULT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for m, w in buckets:
        rows.append(bench_bucket(torch, m, w))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
