"""Sharded against union multi-process detect at scale on the port: the
reference's tools/scale_sharded.py, with two torch.distributed ranks
(gloo, started by ``torch.distributed.run``) in place of two
jax.distributed processes.

Generates a corrected-FAST5 dataset with scale_run's generator at a
reduced genome (the reference's sizes and seeds), then runs the same
detect twice over two ranks:

    merge_mode="union"    every observation gathered to every rank
    merge_mode="sharded"  observations routed once to the owner of their
                          coordinate range (parallel/shardmerge.py)

and reports, a mode: wall time, peak RSS a rank, the bytes each rank
routed to the other (the sharded exchange's ``dcn_route`` stage; the union
merge sends all of a rank's observations by construction), and whether the
two modes' sign-test tables are byte-equal.

    python -m nanomod_tpu_torch.tools.scale_sharded [OUT] [--device cpu]

Ranks run on the card (every rank on cuda:0 on a one-card machine, rank r
on cuda:{r % cards} with several) or, with --device cpu, on the CPU.  Env:
SSH_GENOME (1,500,000), SSH_READS (18,000 a group), SSH_READ_LEN (3,000).
OUT defaults to nanomod_scale_sharded under the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from nanomod_tpu_torch.tools import scale_run as sr
from nanomod_tpu_torch.tools.common import out_root, rss_gb

GENOME_LEN = int(os.environ.get("SSH_GENOME", 1_500_000))
N_READS = int(os.environ.get("SSH_READS", 18_000))
READ_LEN = int(os.environ.get("SSH_READ_LEN", 3_000))
RANKS = 2
TIMEOUT_S = 7200


def worker(root, mode, device):
    """One rank of a mode's detect (under torch.distributed.run)."""
    from nanomod_tpu_torch.config import DetectConfig, RankConfig
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.parallel import dist

    dist.initialize()
    rank, world = dist.process_info()
    try:
        cfg = DetectConfig(
            wrk_base1=os.path.join(root, "ctrl"),
            wrk_base2=os.path.join(root, "case"),
            out_folder=os.path.join(root, f"out_{mode}_r{rank}"
                                    if mode == "union" else f"out_{mode}"),
            file_id="ss", min_lr=0, rank=RankConfig(window=10),
            tile_positions=16384, merge_mode=mode, out_level=1,
            metrics_file=os.path.join(root, f"metrics_{mode}.json"),
        )
        run_detect(cfg, device=dist.rank_device(device))
        # a file a rank: the ranks' standard outputs interleave
        with open(os.path.join(root, f"rss_{mode}_r{rank}.json"), "w") as f:
            json.dump({"rank": rank, "world": world, "mode": mode,
                       "rss_gb": rss_gb()}, f)
    finally:
        dist.shutdown()


def run_mode(mode, root, device):
    """Both ranks of a mode through torch.distributed.run; raises when a
    rank fails."""
    from nanomod_tpu_torch.metrics import metrics_path
    env = dict(os.environ)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), "-m",
         "nanomod_tpu_torch.tools.scale_sharded", "--worker", mode,
         "--device", device, root],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} ranks failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rss, dcn, launches = [], [], []
    for r in range(RANKS):
        with open(os.path.join(root, f"rss_{mode}_r{r}.json")) as f:
            rss.append(json.load(f)["rss_gb"])
        with open(metrics_path(os.path.join(root, f"metrics_{mode}.json"),
                               r, RANKS)) as f:
            m = json.load(f)
        st = m.get("stages", {}).get("dcn_route")
        dcn.append(int(st["items"]) if st else None)
        launches.append(m.get("kernel_launches"))
    return {"mode": mode, "wall_s": wall,
            "rss_gb": rss,
            "dcn_payload_bytes": dcn, "kernel_launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?",
                    default=out_root("nanomod_scale_sharded"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", choices=("union", "sharded"), default=None,
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    root = a.out
    if a.worker:
        worker(root, a.worker, a.device)
        return {"worker": a.worker}
    sr.GENOME_LEN = GENOME_LEN
    sr.N_READS = N_READS
    sr.READ_LEN = READ_LEN
    os.makedirs(root, exist_ok=True)
    genome_arr, levels, planted = sr.genome(0, GENOME_LEN)
    ctrl, case = os.path.join(root, "ctrl"), os.path.join(root, "case")
    t0 = time.time()
    if not os.path.isdir(ctrl):
        sr.gen_group(ctrl, genome_arr, levels, np.random.default_rng(1))
        sr.gen_group(case, genome_arr, levels, np.random.default_rng(2),
                     planted=planted)
    print(f"[gen] 2x{N_READS} reads x {READ_LEN} "
          f"({2 * N_READS * READ_LEN / 1e6:.0f}M observations) "
          f"in {time.time() - t0:.0f}s", flush=True)

    results = [run_mode("sharded", root, a.device),
               run_mode("union", root, a.device)]
    for res in results:
        print("[scale_sharded] " + json.dumps(res), flush=True)
    # the sharded ranks' concatenated table against rank 0's union table
    with open(os.path.join(root, "out_sharded", "ss_sign_test.txt"),
              "rb") as f:
        sharded = f.read()
    with open(os.path.join(root, "out_union_r0", "ss_sign_test.txt"),
              "rb") as f:
        union = f.read()
    identical = sharded == union
    print(f"[scale_sharded] outputs byte-identical: {identical} "
          f"({len(sharded)} bytes)", flush=True)
    summary = {"results": results, "identical": identical,
               "table_bytes": len(sharded),
               "observations": 2 * N_READS * READ_LEN,
               "device": a.device}
    with open(os.path.join(root, "scale_sharded_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if not identical:
        raise AssertionError("the sharded and union tables differ")
    return summary


if __name__ == "__main__":
    main()
