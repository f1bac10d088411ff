"""The share of the traced batch's span in which no operation ran on the
device (kernels, copies and sets, their intervals joined)."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    lo, hi = t.span_ns
    return 100.0 * (1.0 - t.busy_ns() / (hi - lo))
