"""iterations.odom: the aligner's iterations a scan, from each result's
iteration count, over the counted units."""


def read(run):
    its = [u["iterations"] for u in run.units if u.get("counted") and "iterations" in u]
    return sum(its) / len(its) if its else None
