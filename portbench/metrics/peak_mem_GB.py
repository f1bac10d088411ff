"""The allocator's peak over the window, less what the harness itself holds
(the pool and one batch's copy): the solver's own footprint, which decides
which batch fits on the card."""


def read(run):
    if run.peak_bytes is None:
        return None
    return (run.peak_bytes - run.harness_bytes) / 1e9
