"""scan_ms_p90.odom: the 90th percentile of the counted scans' times on the
host's clock (each from its start to its pose read back), over the window of
a traced run; Python's statistics.quantiles, the exclusive method."""

import statistics


def read(run):
    ms = [(u["t1"] - u["t0"]) * 1e3 for u in run.units if u.get("counted")]
    if len(ms) < 10:
        return None
    return statistics.quantiles(ms, n=10)[8]
