"""Device: the share of the traced slice of the window in which no
operation ran on the card (`torch.profiler`, kernels and copies, their
union)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
