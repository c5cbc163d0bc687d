"""Seconds a million positions tested in the neighbour combination, the
ranking and the table written (stats/combine.py, rank/ranking.py,
format_core.cpp): the port's stages combine_pvalues, rank and save."""


def read(run):
    n = run.work.get("positions", 0)
    if not n:
        return None
    stages = ('combine_pvalues', 'rank', 'save')
    return sum(run.stages.get(s, 0.0) for s in stages) / (n / 1e6)
