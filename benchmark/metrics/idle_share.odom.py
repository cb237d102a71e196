"""The device's idle share over the traced units: one minus the union of the
device operations' intervals (torch.profiler) over the traced window."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 1.0 - tr.busy_s / tr.window_s
