"""scan_ms: the window's milliseconds over the scans registered in it (the
first scan of a chain registers nothing and is not counted), on the host's
clock; each unit ends with its pose read back."""


def read(run):
    n = sum(1 for u in run.units if u.get("counted"))
    return run.window_s * 1e3 / n if n else None
