"""Mean DR iterations a problem took (info["iter"]) over the window."""

import numpy as np


def read(run):
    if not run.batches:
        return None
    return float(np.concatenate([b.iters for b in run.batches]).mean())
