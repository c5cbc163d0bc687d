# Copied from nanomod_tpu/harness/plots.py; differs in that matplotlib is
# imported inside the functions that draw (_pyplot), not at module load.
"""Plotting: matplotlib equivalents of the reference's R/ggplot2 outputs.

  * plot_top_sites — per-site window plots of the two groups' signal
    distributions (violin or mirrored density) with log10 p-value tracks
    (ref bin/scripts/Rscript/Base_Most_Significant_Plot.R, driven by
    myDetect.mboxplot/plot1 :129-299)
  * plot_rank_histogram — stacked rank-percentile fractions per sweep value
    (ref Rscript/Hist_sim_plot*.R, driven by mySimulate.mplotHis :519-541)

Plots are not perf-critical; everything here is host-side matplotlib with
the Agg backend.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend; raises ImportError where
    matplotlib is not installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _gaussian_kde_curve(vals: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Silverman-bandwidth Gaussian KDE evaluated on `grid` (the mirrored
    density panels of Base_Most_Significant_Plot.R:86-188 use R's
    stat_density, which defaults to a Gaussian kernel)."""
    n = len(vals)
    if n < 2:
        return np.zeros_like(grid)
    sd = float(np.std(vals))
    if sd == 0:
        sd = 1e-3
    bw = 1.06 * sd * n ** (-0.2)
    diffs = (grid[:, None] - vals[None, :]) / bw
    return np.exp(-0.5 * diffs ** 2).sum(axis=1) / (n * bw * np.sqrt(2 * np.pi))


def collect_site_window(table, site, pools1, pools2, cfg):
    """Gather everything one site's plot page needs — per-position signal
    vectors of both groups, x labels and the ranking p-values — as a plain
    dict (picklable: the multi-host sharded path ships these to rank 0).
    Returns None when either group lacks the site's (chrom, strand)."""
    key = (site.chrom, site.strand)
    g1 = pools1.get(key)
    g2 = pools2.get(key)
    if g1 is None or g2 is None:
        return None
    try:
        site_gid = table.keys.index(key)
    except ValueError:
        site_gid = -1
    w = cfg.rank.window
    positions = range(site.pos - w, site.pos + w + 1)
    data1, data2, labels, pvals = [], [], [], []
    for p in positions:
        i1 = np.searchsorted(g1.positions, p)
        i2 = np.searchsorted(g2.positions, p)
        ok1 = i1 < len(g1.positions) and g1.positions[i1] == p
        ok2 = i2 < len(g2.positions) and g2.positions[i2] == p
        v1 = g1.values[i1, : g1.counts[i1]] if ok1 else np.empty(0)
        v2 = g2.values[i2, : g2.counts[i2]] if ok2 else np.empty(0)
        data1.append(v1[np.isfinite(v1)])
        data2.append(v2[np.isfinite(v2)])
        base = g2.base[i2] if ok2 else "?"
        labels.append(f"{p + 1}/{base}")
        hits = np.where(
            (table.positions == p) & (table.group_ids == site_gid))[0]
        _, p_col = table.columns(cfg.stats)
        pvals.append(float(p_col[hits[0]]) if len(hits) else 1.0)
    return {"rank": site.rank, "chrom": site.chrom, "strand": site.strand,
            "pos": site.pos, "data1": data1, "data2": data2,
            "labels": labels, "pvals": pvals}


def render_site_pages(path, site_datas, cfg):
    """Render collected site windows (collect_site_window dicts) into one
    PDF, one page per site, in rank order."""
    plt = _pyplot()
    from matplotlib.backends.backend_pdf import PdfPages
    w = cfg.rank.window
    with PdfPages(path) as pdf:
        for sd in sorted(site_datas, key=lambda d: d["rank"]):
            data1, data2 = sd["data1"], sd["data2"]
            labels, pvals = sd["labels"], sd["pvals"]
            fig, (ax1, ax2) = plt.subplots(
                2, 1, figsize=(max(8, w * 1.7), 6),
                gridspec_kw={"height_ratios": [3, 1]}, sharex=True)
            xs = np.arange(len(labels))
            violin = getattr(cfg, "plot_type", "Density") == "Violin"
            all_vals = np.concatenate(
                [v for v in data1 + data2 if len(v)] or [np.zeros(1)])
            grid = np.linspace(all_vals.min() - 0.5, all_vals.max() + 0.5, 80)
            for i, (d1, d2) in enumerate(zip(data1, data2)):
                if violin:
                    if len(d1):
                        parts = ax1.violinplot([d1], positions=[i - 0.18],
                                               widths=0.32, showextrema=False)
                        for b in parts["bodies"]:
                            b.set_facecolor("#4878CF")
                            b.set_alpha(0.6)
                    if len(d2):
                        parts = ax1.violinplot([d2], positions=[i + 0.18],
                                               widths=0.32, showextrema=False)
                        for b in parts["bodies"]:
                            b.set_facecolor("#D65F5F")
                            b.set_alpha(0.6)
                else:
                    # mirrored density: group1 up, group2 down, per position
                    for d, color, sign in ((d1, "#4878CF", 1.0),
                                           (d2, "#D65F5F", -1.0)):
                        if not len(d):
                            continue
                        dens = _gaussian_kde_curve(np.asarray(d, float), grid)
                        peak = dens.max()
                        if peak > 0:
                            dens = dens / peak * 0.42
                        ax1.fill_betweenx(grid, i, i + sign * dens,
                                          facecolor=color, alpha=0.6, lw=0)
            if not violin:
                ax1.axhline(0, color="0.85", lw=0.5, zorder=0)
            ax1.set_ylabel("normalized signal")
            ax1.set_title(
                f"rank {sd['rank']}: {sd['chrom']}:{sd['pos'] + 1} "
                f"({sd['strand']}) — group1 blue vs group2 red")
            ax2.bar(xs, np.log10(np.maximum(pvals, 1e-300)), color="#6ACC65")
            ax2.set_ylabel("log10 p")
            ax2.set_xticks(xs)
            ax2.set_xticklabels(labels, rotation=90, fontsize=7)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
    return path


def plot_top_sites(table, sites, pools1, pools2, cfg, max_sites: int = None):
    """One page per top site: signal distributions of both groups across the
    ±window neighborhood plus p-value bar tracks.

    cfg.plot_type selects the reference's two modes
    (ref Base_Most_Significant_Plot.R:5-85 violin, :86-188 mirrored density;
    selected by --plotType, ref bin/NanoMod.py detect options)."""
    max_sites = max_sites or cfg.rank.top_n
    os.makedirs(cfg.out_folder, exist_ok=True)
    path = os.path.join(cfg.out_folder, f"rplot_{cfg.file_id}.pdf")
    datas = []
    for site in sites[:max_sites]:
        sd = collect_site_window(table, site, pools1, pools2, cfg)
        if sd is not None:
            datas.append(sd)
    return render_site_pages(path, datas, cfg)


def plot_rank_histogram(grouped: Dict, labels: List[str], out_path: str,
                        xlabel: str = "MixedPerc"):
    """Stacked per-bin fraction bars across the sweep values
    (Hist_sim_plot.R equivalent)."""
    plt = _pyplot()
    keys = sorted(grouped)
    xs = np.arange(len(keys))
    cmap = plt.get_cmap("RdYlGn_r")
    colors = [cmap(i / max(len(labels) - 1, 1)) for i in range(len(labels))]
    fig, ax = plt.subplots(figsize=(max(6, len(keys) * 1.5), 4))
    bottom = np.zeros(len(keys))
    for lab, color in zip(labels, colors):
        vals = np.array([grouped[k].get(lab, 0.0) for k in keys])
        ax.bar(xs, vals, bottom=bottom, label=lab, color=color, width=0.7)
        bottom += vals
    ax.set_xticks(xs)
    ax.set_xticklabels([str(k) for k in keys])
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Fraction")
    ax.legend(fontsize=7, bbox_to_anchor=(1.02, 1), loc="upper left",
              title="Rank percentile")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_rank_histogram_grid(panels: Dict[str, tuple], out_path: str,
                             ncols: int = 3, xlabel: str = "MixedPerc",
                             fmt: str = None, dpi: int = 300):
    """Faceted grid of stacked rank-percentile histograms, one panel per
    dataset/method — the Hist_sim_plot9.R / Hist_sim_plot27.R equivalents
    (9/27 facets over modification types × methods).

    `panels` maps panel title -> (grouped, labels) as returned by
    harness.simulate.group_ranks / summarize_outputs.  `fmt` overrides the
    output format regardless of the path suffix — fmt="tiff" (or an
    out_path ending in .tif/.tiff) is the Hist_sim_plot9tif.R equivalent
    (ref Rscript/Hist_sim_plot9tif.R:1-29, a 300-dpi TIFF export)."""
    plt = _pyplot()
    names = list(panels)
    n = len(names)
    ncols = min(ncols, max(n, 1))
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(ncols * 3.2, nrows * 2.6),
                             squeeze=False, sharey=True)
    cmap = plt.get_cmap("RdYlGn_r")
    legend_handles = None
    legend_labels = None
    for idx, name in enumerate(names):
        ax = axes[idx // ncols][idx % ncols]
        grouped, labels = panels[name]
        keys = sorted(grouped)
        xs = np.arange(len(keys))
        colors = [cmap(i / max(len(labels) - 1, 1)) for i in range(len(labels))]
        bottom = np.zeros(len(keys))
        handles = []
        for lab, color in zip(labels, colors):
            vals = np.array([grouped[k].get(lab, 0.0) for k in keys])
            h = ax.bar(xs, vals, bottom=bottom, color=color, width=0.7)
            handles.append(h)
            bottom += vals
        if legend_handles is None:
            legend_handles, legend_labels = handles, labels
        ax.set_xticks(xs)
        ax.set_xticklabels([str(k) for k in keys], fontsize=6, rotation=45)
        ax.set_title(name, fontsize=8)
        if idx // ncols == nrows - 1:
            ax.set_xlabel(xlabel, fontsize=7)
    for idx in range(n, nrows * ncols):
        axes[idx // ncols][idx % ncols].axis("off")
    if legend_handles:
        fig.legend(legend_handles, legend_labels, fontsize=6,
                   loc="center left", bbox_to_anchor=(1.0, 0.5),
                   title="Rank percentile")
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight", format=fmt, dpi=dpi)
    plt.close(fig)
    return out_path
