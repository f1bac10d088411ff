"""The share of the window's batch time spent in `BatchedSCS(...)` (upload,
Ruiz equilibration, factorisation, g) against `.solve()`: the benchmark's
own spans around the two calls, each synchronised at both ends. The traced
batch is left out (the profiler slows it)."""


def read(run):
    b = [x for x in run.batches if not x.traced]
    total = sum(x.construct_s + x.solve_s for x in b)
    if not total > 0:
        return None
    return 100.0 * sum(x.construct_s for x in b) / total
