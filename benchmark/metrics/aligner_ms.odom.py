"""aligner_ms.odom: milliseconds a scan in the aligner (registration.gicp), from the benchmark's ``aligner``
spans (the card synchronised at both ends), over the counted units of a
traced run."""


def read(run):
    return run.span_ms("aligner")
