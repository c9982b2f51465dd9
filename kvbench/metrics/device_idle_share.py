"""1 - the union of the device's kernel, copy and memset intervals over
the traced slice, in percent (torch.profiler)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
