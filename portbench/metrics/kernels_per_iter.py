"""Kernels launched in the traced batch over its lockstep iterations (its
largest info["iter"]): the dispatch the host pays an iteration."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.iters:
        return None
    return len(t.kernels) / t.iters
