"""The DownSampling entry: one unit is one ``run_downsampling`` call at
one CaseSize (``random_times`` trials, each a sample of CaseSize reads of
each group, the coverage-at-target check, a whole ``detect_from_pools``
and the target's rank).  The groups are loaded once in set-up, as
``run_downsampling_sweep`` loads them.  Call ``i`` of a run takes the seed
``(seed * 1000003 + i) mod 2^32``, so the trials sample other reads in
every call and run, and the same number of them.

The benchmark wraps two names in the harness module for its own use: it
counts the calls of ``pools_from_selections`` (two an attempt, so rejected
attempts show), and keeps the table and order of the trials drawn for the
check from ``detect_from_pools``'s return."""

from __future__ import annotations

import os

import numpy as np

from benchmark.reference import compare as cmp
from benchmark.reference import detect as ref_detect
from benchmark.entries.detect import table_dict

SPAN = "bench.unit.downsampling"
# trials the check compares, about; drawn from the seed over the window
CHECKED_TRIALS = 6


def call_seed(seed: int, i: int) -> int:
    return (seed * 1000003 + i) % (1 << 32)


def setup(ctx) -> dict:
    import time

    from nanomod_tpu_torch.config import (RankConfig, SimulateConfig,
                                          StatConfig)
    from nanomod_tpu_torch.harness import simulate
    folders = ctx.inputs["folders"]
    st = ctx.traffic["stats"]
    base = SimulateConfig(
        wrk_base1=folders["case"], wrk_base2=folders["ctrl"],
        out_folder=os.path.join(ctx.workdir, "out"), file_id="bench",
        case_size=ctx.traffic["case_size"],
        random_times=ctx.traffic["random_times"],
        target_chr=ctx.config["chrom"], target_pos=ctx.config["target_pos"],
        target_strand=ctx.config["target_strand"],
        min_coverage=st["min_coverage"],
        stats=StatConfig(neighbor_pvalues=st["neighbor_pvalues"],
                         weights_dif=st["weights_dif"]),
        rank=RankConfig(window=st["rank_window"]))
    state = {"ctx": ctx, "base": base, "calls": 0, "kept": [],
             "keep_p": 1.0, "pick": np.random.default_rng(
                 [ctx.seed % (1 << 63), 7]), "counting": False}
    state["case"] = simulate.FlatReads(simulate.load_group_reads(
        folders["case"]))
    state["ctrl"] = simulate.FlatReads(simulate.load_group_reads(
        folders["ctrl"]))
    t0 = time.perf_counter()
    w = unit(state)                   # warm-up: every shape of the window
    per_trial = (time.perf_counter() - t0) / max(w["work"]["trials"], 1)
    state["keep_p"] = min(1.0, CHECKED_TRIALS * per_trial
                          / max(ctx.seconds, 1e-9))
    state["counting"] = True
    return state


def unit(state) -> dict:
    from nanomod_tpu_torch.config import replace
    from nanomod_tpu_torch.harness import simulate
    from nanomod_tpu_torch.utils.observe import observer
    ctx = state["ctx"]
    seed_now = call_seed(ctx.seed, state["calls"])
    state["calls"] += 1
    state["trial"], state["pool_calls"] = 0, 0
    state["rows"] = []
    observer().reset()
    orig_detect = simulate.detect_from_pools
    orig_pools = simulate.pools_from_selections

    def detect_kept(pools1, pools2, cfg, **kw):
        table, order = orig_detect(pools1, pools2, cfg, **kw)
        if state["counting"]:
            state["rows"].extend(
                (np.asarray(table.cov1)[table.group_ids == g],
                 np.asarray(table.cov2)[table.group_ids == g])
                for g in range(len(table.keys)))
            trial = state["trial"]
            state["trial"] += 1
            if not state["kept"] or state["pick"].random() < state["keep_p"]:
                state["kept"].append({"seed": seed_now, "trial": trial,
                                      "got": table_dict(table, order)})
        return table, order

    def pools_counted(selections):
        state["pool_calls"] += 1
        return orig_pools(selections)

    simulate.detect_from_pools = detect_kept
    simulate.pools_from_selections = pools_counted
    try:
        ranks = simulate.run_downsampling(
            replace(state["base"], seed=seed_now), case_reads=state["case"],
            control_reads=state["ctrl"], device=ctx.device)
    finally:
        simulate.detect_from_pools = orig_detect
        simulate.pools_from_selections = orig_pools
    for kept in state["kept"]:
        if kept["seed"] == seed_now:
            kept["rank"] = ranks[kept["trial"]]
    stages = {k: v["seconds"] for k, v in observer().snapshot().items()}
    attempts = state["pool_calls"] // 2
    return {"work": {"trials": len(ranks), "units": 1, "attempts": attempts,
                     "rejected": attempts - len(ranks)},
            "stages": stages, "battery_rows": state.pop("rows")}


def rate(work: dict, seconds: float) -> float:
    return work["trials"] / seconds


def release(state):
    state.pop("case", None)
    state.pop("ctrl", None)


def _group(ctx, g):
    chrom = ctx.config["chrom"]
    return [(chrom, s, st, m) for s, st, m in ctx.generator.group_reads(
        ctx.config, ctx.traffic, ctx.seed, g)]


def _trials(ctx, seed_now, wanted, case, ctrl):
    """The reads of trials ``wanted`` of call ``seed_now``: run_downsampling's
    draws (NanoMod's myDownSampling0.py:38-132), replayed."""
    rs = np.random.RandomState(seed_now)
    size, times = ctx.traffic["case_size"], ctx.traffic["random_times"]
    tchrom, tpos = ctx.config["chrom"], ctx.config["target_pos"]
    tstrand = ctx.config["target_strand"]
    rt = repeat = cur = attempts = 0
    out = {}
    while rt < times and attempts < times * 30:
        attempts += 1
        n = int(size * (1 + min(repeat, 15) * 0.02))
        picks = []
        for group in (case, ctrl):
            keep = np.ones(len(group), bool)
            if len(group) > n:
                keep[:] = False
                keep[rs.choice(len(group), n, replace=False)] = True
            picks.append([r for r, k in zip(group, keep) if k])
        need = 0.95 * size / 5
        lacking = 0
        for reads in picks:
            for pos in range(tpos - 3, tpos + 4):
                cov = sum(1 for c, s, st, m in reads if c == tchrom
                          and s == tstrand and st <= pos < st + len(m))
                lacking += cov < need
        if lacking > 2:
            if lacking > 3 and cur > 5:
                repeat += 1
            cur += 1
            continue
        if rt in wanted:
            out[rt] = picks
        rt += 1
        cur = 0
    return out


def check(state, control: bool = False) -> dict:
    """The kept trials against the reference: each trial's table and its
    target rank; with ``control`` the reference in bfloat16 in the
    program's place."""
    ctx = state["ctx"]
    st = ctx.traffic["stats"]
    case, ctrl = _group(ctx, 0), _group(ctx, 1)
    close = 2 * st["neighbor_pvalues"]
    target = (ctx.config["chrom"], ctx.config["target_strand"],
              ctx.config["target_pos"])
    by_call = {}
    for k in state["kept"]:
        by_call.setdefault(k["seed"], []).append(
            (k["trial"], k["got"], k["rank"]))
    out = {"rows_differ": 0, "stat_gap": 0.0, "p_gap": 0.0,
           "order_gap": 0.0, "rank_differ": 0}
    for seed_now, trials in by_call.items():
        picks = _trials(ctx, seed_now, {t for t, _, _ in trials}, case, ctrl)
        for trial, got, rank in trials:
            args = dict(min_coverage=st["min_coverage"],
                        k=st["neighbor_pvalues"],
                        weights_dif=st["weights_dif"])
            ref = ref_detect.detect(*picks[trial], **args)
            if control:
                got = ref_detect.detect(*picks[trial], precision="bfloat16",
                                        **args)
                rank = ref_detect.rank_of_target(got, target, close,
                                                 st["rank_window"])
            nums = cmp.compare(got, ref)
            ref_rank = ref_detect.rank_of_target(ref, target, close,
                                                 st["rank_window"])
            out["rank_differ"] += int(rank != ref_rank)
            out["rows_differ"] += nums["rows_differ"]
            for k in ("stat_gap", "p_gap", "order_gap"):
                out[k] = max(out[k], nums[k])
    return out, {"trials_checked": len(state["kept"])}
