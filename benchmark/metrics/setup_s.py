"""setup_s: seconds from the start of the process to the first timed unit
(imports, the kernels' build or load, the data made on the card, the
warm-up), on the host's clock."""


def read(run):
    return run.setup_s
