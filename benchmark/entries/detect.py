"""The detect entry: one unit is one whole ``run_detect`` of the two
corrected groups that set-up wrote, as a user runs ``detect`` (ingest,
pools, coverage filter, the battery, neighbour combination, the table
written, ranking).  Every unit runs the same work; the last unit's table
and order are what the check compares."""

from __future__ import annotations

import os

import numpy as np

from benchmark.reference import compare as cmp
from benchmark.reference import detect as ref_detect

SPAN = "bench.unit.detect"


def table_dict(table, order) -> dict:
    """The port's (SignTable, order) as the reference's dict."""
    r = table.res
    return dict(keys=list(table.keys), group_ids=np.asarray(table.group_ids),
                positions=np.asarray(table.positions, np.int64),
                cov1=np.asarray(table.cov1), cov2=np.asarray(table.cov2),
                stu=r.stu, pu=r.pu, stt=r.stt, pt=r.pt, stks=r.stks,
                pks=r.pks, stcomb=r.stcomb, pcomb=r.pcomb,
                order=np.asarray(order, np.int64))


def setup(ctx) -> dict:
    from nanomod_tpu_torch.config import DetectConfig, StatConfig
    folders = ctx.inputs["folders"]
    st = ctx.traffic["stats"]
    cfg = DetectConfig(
        wrk_base1=folders["ctrl"], wrk_base2=folders["case"],
        min_coverage=st["min_coverage"],
        stats=StatConfig(neighbor_pvalues=st["neighbor_pvalues"],
                         weights_dif=st["weights_dif"]),
        out_folder=os.path.join(ctx.workdir, "out"), file_id="bench",
        num_workers=ctx.threads,
        tile_positions=ctx.traffic["tile_positions"])
    state = {"cfg": cfg, "ctx": ctx}
    unit(state)                       # warm-up: every shape of the window
    return state


def unit(state) -> dict:
    from nanomod_tpu_torch.detect import run_detect
    from nanomod_tpu_torch.utils.observe import observer
    table, order, _ = run_detect(state["cfg"], device=state["ctx"].device)
    state["last"] = (table, order)
    stages = {k: v["seconds"] for k, v in observer().snapshot().items()}
    out_path = os.path.join(state["cfg"].out_folder, "bench_sign_test.txt")
    return {"work": {"positions": len(table), "units": 1,
                     "bytes_written": os.path.getsize(out_path)},
            "stages": stages,
            "battery_rows": [(np.asarray(table.cov1)[table.group_ids == g],
                              np.asarray(table.cov2)[table.group_ids == g])
                             for g in range(len(table.keys))]}


def rate(work: dict, seconds: float) -> float:
    return work["positions"] / seconds


def release(state):
    """Keep the last unit's outputs only, as numpy arrays."""
    state["got"] = table_dict(*state.pop("last"))


def _reads(ctx, group):
    gen = ctx.generator
    chrom = ctx.config["chrom"]
    for strand, start, means in gen.group_reads(ctx.config, ctx.traffic,
                                                ctx.seed, group):
        yield chrom, strand, start, means


def reference(ctx, precision="float64") -> dict:
    st = ctx.traffic["stats"]
    return ref_detect.detect(_reads(ctx, 0), _reads(ctx, 1),
                             min_coverage=st["min_coverage"],
                             k=st["neighbor_pvalues"],
                             weights_dif=st["weights_dif"],
                             precision=precision)


def check(state, control: bool = False):
    """(the numbers compared, what else to print): the last unit's table
    against the reference, or, with ``control``, the reference in bfloat16
    in its place."""
    ctx = state["ctx"]
    ref = reference(ctx)
    got = reference(ctx, "bfloat16") if control else state["got"]
    return cmp.compare(got, ref), {"rows": len(ref["positions"])}
