"""downsample_ms.odom: milliseconds a scan in voxel_downsample (filters/voxel_grid, kernel B2), from the benchmark's ``downsample``
spans (the card synchronised at both ends), over the counted units of a
traced run."""


def read(run):
    return run.span_ms("downsample")
