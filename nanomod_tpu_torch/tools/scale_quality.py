"""Multi-seed detection quality at E. coli scale on the port: the
reference's tools/scale_quality.py.

For each seed: the 4.6 Mb genome and two groups of corrected reads with 20
planted sites of scale_run (the genome and sites derive only from the
seed), then detect in four modes, recording the planted sites recovered in
the top 50:

    stouffer   the reference's default (weighted Stouffer combination)
    fisher     Fisher combination
    capped     per-strand coverage cap 10 and the KS on 100 subsamples (K6)
    region     RegionRankbyST window ranking

The reference's manifest, tools/scale_manifest.json (seed -> genome
sha256, planted positions), is read, not written: at its genome length a
seed whose genome digest or planted sites differ from it fails the run.
This tool writes its own manifest and summary under OUT:

    python -m nanomod_tpu_torch.tools.scale_quality [OUT] [SEEDS...]
        [--device cpu]

OUT defaults to nanomod_squality under the temporary directory, SEEDS to 0
1 2; each seed's reads (~6 GB at the default size) are deleted after its
runs.  SCALE_GENOME, SCALE_READS and SCALE_READ_LEN set the size;
SCALE_CPU=1 makes the CPU the default device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import time

import numpy as np

from nanomod_tpu_torch.config import DetectConfig, RankConfig, StatConfig
from nanomod_tpu_torch.tools.common import metrics_summary, out_root
from nanomod_tpu_torch.tools.scale_run import CHROM, gen_group, genome

GENOME_LEN = int(os.environ.get("SCALE_GENOME", 4_600_000))
N_READS = int(os.environ.get("SCALE_READS", 35_000))
READ_LEN = int(os.environ.get("SCALE_READ_LEN", 3_000))
N_SITES = 20
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE_MANIFEST = os.path.join(REPO, "tools", "scale_manifest.json")


def dataset_for_seed(root, seed):
    """Write a seed's two groups under ``root``; returns (ctrl, case,
    planted, genome sha256)."""
    genome_arr, levels, planted = genome(seed, GENOME_LEN, N_SITES)
    ctrl = os.path.join(root, f"s{seed}_ctrl")
    case = os.path.join(root, f"s{seed}_case")
    gen_group(ctrl, genome_arr, levels, np.random.default_rng(seed * 10 + 1),
              n_reads=N_READS, read_len=READ_LEN)
    gen_group(case, genome_arr, levels, np.random.default_rng(seed * 10 + 2),
              planted=planted, n_reads=N_READS, read_len=READ_LEN)
    digest = hashlib.sha256(genome_arr.tobytes()).hexdigest()
    return ctrl, case, planted, digest


MODES = {
    "stouffer": dict(stats=StatConfig(test_method="stouffer")),
    "fisher": dict(stats=StatConfig(test_method="fisher")),
    "capped": dict(stats=StatConfig(test_method="stouffer",
                                    coverages=(10, 10), downsampling=100)),
    "region": dict(stats=StatConfig(test_method="stouffer"),
                   rank=RankConfig(window=10, region_rank_by_st=True,
                                   percentile=0.1)),
}


def recall(sites, planted, close, top_n=50):
    """Planted sites with a top-``top_n`` site within ``close`` positions
    (the reference's getTopRank tolerance: 2 * neighborPvalues for site
    ranking, the region window for RegionRankbyST)."""
    top = np.array([s.pos for s in sites[:top_n] if s.chrom == CHROM],
                   dtype=np.int64)
    if len(top) == 0:
        return 0
    return sum(1 for p in planted if np.abs(top - p).min() <= close)


def check_manifest(seed, digest, planted, path=REFERENCE_MANIFEST):
    """Hold a seed's genome digest and planted sites to the reference's
    manifest when it was made at this genome length and site count;
    returns whether they were compared.  Raises when they differ."""
    with open(path) as f:
        ref = json.load(f)
    entry = ref["seeds"].get(str(seed))
    if (entry is None or ref["genome_len"] != GENOME_LEN
            or ref["n_sites"] != N_SITES):
        return False
    if entry["genome_sha256"] != digest or entry["planted"] != planted:
        raise AssertionError(f"seed {seed}: the genome or planted sites "
                             f"differ from {path}")
    return True


def main(argv=None):
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.kernels import build as kbuild

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=out_root("nanomod_squality"))
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device",
                    default="cpu" if os.environ.get("SCALE_CPU") else "cuda")
    a = ap.parse_args(argv)
    root = a.out
    seeds = a.seeds or [0, 1, 2]
    os.makedirs(root, exist_ok=True)
    manifest = {"genome_len": GENOME_LEN, "reads_per_group": N_READS,
                "read_len": READ_LEN, "n_sites": N_SITES,
                "generator": "nanomod_tpu_torch/tools/scale_quality.py",
                "seeds": {}}
    results = {}
    for seed in seeds:
        t0 = time.time()
        ctrl, case, planted, digest = dataset_for_seed(root, seed)
        print(f"[squality] seed {seed}: generated in {time.time()-t0:.0f}s",
              flush=True)
        compared = check_manifest(seed, digest, planted)
        manifest["seeds"][str(seed)] = {
            "genome_sha256": digest, "planted": planted,
            "matches_reference_manifest": compared}
        results[seed] = {}
        for mode, kw in MODES.items():
            cfg = DetectConfig(
                wrk_base1=ctrl, wrk_base2=case,
                out_folder=os.path.join(root, "out"),
                file_id=f"s{seed}_{mode}", min_lr=0,
                rank=kw.get("rank", RankConfig(window=10)),
                stats=kw["stats"], save_test=False, out_level=2,
                metrics_file=os.path.join(root, "out",
                                          f"s{seed}_{mode}.json"),
            )
            kbuild.reset_launches()        # each mode's own launches
            t0 = time.time()
            table, order, sites = run_detect(cfg, device=a.device)
            close = (cfg.rank.window + 1 if cfg.rank.region_rank_by_st
                     else 2 * cfg.stats.neighbor_pvalues)
            r = recall(sites, planted, close)
            results[seed][mode] = {
                "recall_top50": f"{r}/{N_SITES}",
                "wall_s": time.time() - t0,
                "positions": int(len(table)),
                "kernel_launches":
                    metrics_summary(cfg.metrics_file)["kernel_launches"],
            }
            print(f"[squality] seed {seed} {mode}: "
                  f"{json.dumps(results[seed][mode])}", flush=True)
        shutil.rmtree(ctrl)
        shutil.rmtree(case)
    with open(os.path.join(root, "scale_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    out = os.path.join(root, "quality_summary.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print("[squality] " + json.dumps(results))
    print(f"[squality] manifest -> {os.path.join(root, 'scale_manifest.json')}")
    return results


if __name__ == "__main__":
    main()
