"""The share of the profiled slice of the window in which no operation ran
on the card: 1 − (union of the device intervals) / the slice's length."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
