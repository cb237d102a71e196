"""probe_ms.odom: milliseconds a scan in tools.odometry.probed_cells (the host density probe), from the benchmark's ``probe``
spans (the card synchronised at both ends), over the counted units of a
traced run."""


def read(run):
    return run.span_ms("probe")
