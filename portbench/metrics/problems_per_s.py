"""Problems returned "solved" in the window over the window's whole time,
each batch's construction (copy, equilibration, factorisation) included."""


def read(run):
    if not run.batches or not run.window_s > 0:
        return None
    return run.solved / run.window_s
