"""Command-line interface of the port: the five subcommands of
nanomod_tpu.cli, with the same flags plus ``--device`` (default ``cuda``)::

    python -m nanomod_tpu_torch.cli Annotate --wrkBase1 READS --Ref ref.fa
    python -m nanomod_tpu_torch.cli detect --wrkBase1 CTRL --wrkBase2 CASE
    python -m nanomod_tpu_torch.cli simulate --wrkBase1 ... --Percentages 0.3,0.5
    python -m nanomod_tpu_torch.cli simulat2 --Percentage 0.2 --CaseSize 2000
    python -m nanomod_tpu_torch.cli DownSampling --CaseSize 100

``--metricsFile`` (Annotate, detect) writes per-stage timings and the CUDA
kernels' launch counts as JSON.  Plots are not ported: detect accepts
``--plotType`` and draws nothing, and the harness writes every ``.output``
/ ``.done`` file but prints a line instead of drawing ``hist_<FileID>.png``.
"""

from __future__ import annotations

import argparse

import glob
import os

from nanomod_tpu_torch.config import (OUTPUT_DEBUG, OUTPUT_ERROR, OUTPUT_INFO,
                                      OUTPUT_WARNING, AnnotateConfig, DetectConfig,
                                      RankConfig, SimulateConfig, StatConfig,
                                      replace)


def _common(parser):
    g = parser.add_argument_group("Common options")
    g.add_argument("--outLevel", type=int, default=OUTPUT_WARNING,
                   choices=[OUTPUT_DEBUG, OUTPUT_INFO, OUTPUT_WARNING, OUTPUT_ERROR])
    g.add_argument("--wrkBase1", help="base folder of the first group")
    g.add_argument("--window", type=int, default=21,
                   help="full window width (stored as half-width)")
    g.add_argument("--FileID", default="mod")
    g.add_argument("--outFolder", default="mRes/")
    g.add_argument("--MinCoverage", type=int, default=5)
    g.add_argument("--topN", type=int, default=30)
    g.add_argument("--neighborPvalues", type=int, default=2)
    g.add_argument("--WeightsDif", type=float, default=2.0)
    g.add_argument("--testMethod", default="stouffer",
                   choices=["fisher", "stouffer", "ks"])
    g.add_argument("--rankUse", default="pv", choices=["st", "pv"])
    g.add_argument("--SaveTest", type=int, default=1, choices=[0, 1])
    g.add_argument("--RegionRankbyST", type=int, default=0, choices=[0, 1])
    g.add_argument("--percentile", type=float, default=0.1)
    g.add_argument("--WindOvlp", type=int, default=0, choices=[0, 1])
    g.add_argument("--NA", type=str, default="", choices=["", "A", "C", "G", "T"])


def _device_arg(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default), "
                             "cuda:N or cpu; never falls back")


def _stat_cfg(a, coverages="0-0") -> StatConfig:
    cov = list(map(int, coverages.split("-")))
    if len(cov) == 1:
        cov = [cov[0], cov[0]]
    return StatConfig(
        neighbor_pvalues=a.neighborPvalues,
        weights_dif=max(a.WeightsDif, 1.0),
        test_method=a.testMethod,
        coverages=(cov[0], cov[1]),
        downsampling=getattr(a, "downsampling", 100),
        downsampling_quantile=getattr(a, "downsampling_quantile", 0.25),
    )


def _rank_cfg(a) -> RankConfig:
    return RankConfig(
        window=(a.window - 1) // 2,
        top_n=a.topN,
        rank_use=a.rankUse,
        region_rank_by_st=bool(a.RegionRankbyST),
        percentile=min(max(a.percentile, 0.0), 0.99),
        wind_ovlp=bool(a.WindOvlp),
        na=a.NA,
    )


def cmd_detect(a):
    from nanomod_tpu_torch.detect import run_detect
    cfg = DetectConfig(
        wrk_base1=a.wrkBase1, wrk_base2=a.wrkBase2,
        out_folder=a.outFolder, file_id=a.FileID, out_level=a.outLevel,
        min_coverage=a.MinCoverage,
        stats=_stat_cfg(a, a.coverages), rank=_rank_cfg(a),
        min_lr=a.min_lr, min_lr_nb=a.min_lr_nb, mstd=bool(a.mstd),
        save_test=bool(a.SaveTest), plot_type=a.plotType, make_plots=False,
        metrics_file=a.metricsFile or None, profile_dir=a.profileDir or None,
        n_devices=a.n_devices, tile_positions=a.tile_positions,
        pool_capacity=a.pool_capacity, merge_mode=a.merge_mode,
    )
    if a.Pos:
        parts = a.Pos.split(":")
        kw = {"chrom": parts[0]}
        if len(parts) > 1:
            kw["pos"] = int(parts[1]) - 1
        if len(parts) > 2:
            kw["pos2"] = int(parts[2]) - 1
        cfg = replace(cfg, **kw)
    table, order, sites = run_detect(cfg, device=a.device)
    for s in sites[: cfg.rank.top_n]:
        print(f"Rank {s.rank}: {s.chrom} {s.strand} {s.pos + 1} {s.base}")


def _sim_cfg(a, percentages=(0.3,), percentage=0.3) -> SimulateConfig:
    return SimulateConfig(
        wrk_base1=a.wrkBase1, wrk_base2=a.wrkBase2,
        wrk_base3=getattr(a, "wrkBase3", None),
        out_folder=a.outFolder, file_id=a.FileID, out_level=a.outLevel,
        percentages=tuple(percentages), percentage=percentage,
        case_size=getattr(a, "CaseSize", None),
        run_type=getattr(a, "runType", 2),
        foldersep=getattr(a, "foldersep", 3),
        min_coverage=a.MinCoverage,
        stats=_stat_cfg(a), rank=_rank_cfg(a),
    )


def _no_histogram(cfg: SimulateConfig):
    """Where the reference draws the rank histogram (matplotlib), say that
    it is not drawn."""
    print(f"hist_{cfg.file_id}.png not drawn: plots are not ported "
          f"(the .output files are in {cfg.out_folder})")


def _output_ids(out_folder: str, prefix: str = "") -> list:
    return [os.path.basename(p)[:-7] for p in
            glob.glob(os.path.join(out_folder, f"{prefix}*.output"))]


def cmd_simulate(a):
    from nanomod_tpu_torch.harness.simulate import (merge_grid_outputs,
                                                    run_simulate,
                                                    run_simulate_grid)
    percs = sorted(float(x) for x in a.Percentages.split(","))
    cfg = _sim_cfg(a, percentages=percs)
    if a.wrkBase3 is None:
        # grid mode (ref mySimulate.py:344-467): the subfolder-pair grid
        fids, _ = run_simulate_grid(cfg, device=a.device)
        merge_grid_outputs(cfg, fids)
    else:
        run_simulate(cfg, device=a.device)
    _no_histogram(cfg)


def cmd_simulat2(a):
    from nanomod_tpu_torch.harness.simulate import (run_simulat2,
                                                    run_simulat2_sweep,
                                                    summarize_outputs)
    cfg = _sim_cfg(a, percentage=a.Percentage or 0.2)
    if a.runType == 2:
        run_simulat2(cfg, device=a.device)
    elif a.runType == 1:
        run_simulat2_sweep(cfg, device=a.device)
    else:
        summarize_outputs(cfg.out_folder, _output_ids(cfg.out_folder))
        _no_histogram(cfg)


def cmd_downsampling(a):
    from nanomod_tpu_torch.harness.simulate import (run_downsampling,
                                                    run_downsampling_sweep,
                                                    summarize_outputs)
    cfg = _sim_cfg(a)
    if a.runType == 2:
        run_downsampling(cfg, device=a.device)
    elif a.runType == 1:
        run_downsampling_sweep(cfg, device=a.device)
    else:
        summarize_outputs(cfg.out_folder,
                          _output_ids(cfg.out_folder, a.mprefix or cfg.file_id))
        _no_histogram(cfg)


def cmd_annotate(a):
    from nanomod_tpu_torch.resquiggle.pipeline import annotate_folder
    cfg = AnnotateConfig(
        wrk_base1=a.wrkBase1, ref_fasta=a.Ref, out_level=a.outLevel,
        kmer_model_file=a.kmer_model_file,
        resegment_wind=a.Resegment_wind,
        resegment_signal_wind=a.Resegment_signal_wind,
        min_num_signal=a.MinNumSignal,
        threads=a.threads, files_per_thread=a.files_per_thread,
        basecall_1d=a.basecall_1d, basecall_2strand=a.basecall_2strand,
        recursive=bool(a.recursive), resume=bool(a.resume),
        align=a.alignStr,
        metrics_file=a.metricsFile or None,
        n_devices=a.n_devices,
    )
    annotate_folder(cfg, device=a.device)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="nanomod_tpu_torch",
        description="nanopore modification detection on PyTorch + CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("detect", help="detect modifications between two groups")
    _common(p)
    p.add_argument("--wrkBase2")
    p.add_argument("--Pos", default="")
    p.add_argument("--mstd", type=int, default=0)
    p.add_argument("--plotType", default="Density", choices=["Violin", "Density"])
    p.add_argument("--min_lr", type=int, default=500)
    p.add_argument("--min_lr_nb", type=int, default=0)
    p.add_argument("--downsampling_quantile", type=float, default=0.25)
    p.add_argument("--downsampling", type=int, default=100)
    p.add_argument("--coverages", type=str, default="0-0")
    p.add_argument("--metricsFile", default="",
                   help="write per-stage timing/throughput JSON here")
    p.add_argument("--profileDir", default="",
                   help="device trace dir (not ported: raises if set)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="0/1 = single device (the only mode ported)")
    p.add_argument("--tile_positions", type=int, default=16384,
                   help="positions per device stats tile")
    p.add_argument("--pool_capacity", type=int, default=0,
                   help="cap per-position signal reservoirs (deterministic "
                        "subsample beyond the cap; 0 = keep everything)")
    p.add_argument("--merge_mode", choices=("union", "sharded"),
                   default="union",
                   help="multi-host pool merge (only 'union', i.e. one "
                        "process, is ported)")
    _device_arg(p)
    p.set_defaults(func=cmd_detect)

    p = sub.add_parser("simulate", help="percentage-mixing simulation")
    _common(p)
    p.add_argument("--wrkBase2")
    p.add_argument("--wrkBase3",
                   help="second control folder (worker mode); omit to run "
                        "the subfolder-pair grid over wrkBase1/wrkBase2")
    p.add_argument("--Percentages", type=str, default="0.3")
    p.add_argument("--foldersep", type=int, default=3,
                   help="control-test subfolder offset in grid mode "
                        "(mk = (mi + foldersep) %% n_control_subfolders)")
    _device_arg(p)
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("simulat2", help="case-size scaling simulation")
    _common(p)
    p.add_argument("--wrkBase2")
    p.add_argument("--Percentage", type=float, default=None)
    p.add_argument("--CaseSize", type=int, default=None)
    p.add_argument("--runType", type=int, default=2, choices=[1, 2, 3])
    _device_arg(p)
    p.set_defaults(func=cmd_simulat2)

    p = sub.add_parser("DownSampling", help="coverage-scaling simulation")
    _common(p)
    p.add_argument("--wrkBase2")
    p.add_argument("--CaseSize", type=int, default=None)
    p.add_argument("--runType", type=int, default=2, choices=[1, 2, 3])
    p.add_argument("--mprefix", type=str, default="")
    _device_arg(p)
    p.set_defaults(func=cmd_downsampling)

    p = sub.add_parser("Annotate", help="resquiggle reads against a reference")
    p.add_argument("--outLevel", type=int, default=OUTPUT_WARNING)
    p.add_argument("--wrkBase1")
    p.add_argument("--Ref")
    p.add_argument("--kmer_model_file", default=None)
    p.add_argument("--Resegment_wind", type=int, default=4)
    p.add_argument("--Resegment_signal_wind", type=int, default=4)
    p.add_argument("--MinNumSignal", type=int, default=4)
    p.add_argument("--threads", type=int, default=12)
    p.add_argument("--files_per_thread", type=int, default=300)
    p.add_argument("--basecall_1d", default="Basecall_1D_000")
    p.add_argument("--basecall_2strand", default="BaseCalled_template")
    p.add_argument("--recursive", type=int, default=1, choices=[0, 1])
    p.add_argument("--alignStr", type=str, default="dp",
                   choices=["dp", "bwa", "minimap2"])
    p.add_argument("--resume", type=int, default=0, choices=[0, 1],
                   help="skip FAST5s already carrying NanomoCorrected_000")
    p.add_argument("--metricsFile", default="",
                   help="write per-stage timing/throughput JSON here")
    p.add_argument("--n_devices", type=int, default=0,
                   help="0/1 = single device (the only mode ported)")
    _device_arg(p)
    p.set_defaults(func=cmd_annotate)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
