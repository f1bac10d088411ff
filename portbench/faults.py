"""Faults planted in the timed path, each of which the reference has to
catch (`correct` false). The control script and the benchmark's tests use
them; the benchmark's own runs never do.

  unchanged  every DR segment returns its state unchanged and marked
             solved, so solve() hands back the cold start
  half       the solver gets the first half of the batch only, and the
             left-out problems are answered with the solved half's answers
  altered    one answer altered where it is produced: the dual entry of
             largest size of each batch's first problem changes sign

The exchange between chips has no fault here: every cell runs on one card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(name):
    from scs_tpu_torch import batch, batch_core  # noqa: PLC0415
    from scs_tpu_torch.info import SOLVED  # noqa: PLC0415

    cls, core = batch.BatchedSCS, batch_core.BatchedCore
    saved = (cls.__init__, cls.solve, core.run_seg)
    init, solve = cls.__init__, cls.solve
    if name == "unchanged":
        def run_seg(self, state, mats, max_iters, seg):
            return state._replace(status=torch.full_like(state.status, SOLVED))
        core.run_seg = run_seg
    elif name == "half":
        def half_init(self, data, cone, **settings):
            B = len(data["A"])
            self._full = B
            init(self, {k: v[: B // 2] for k, v in data.items()}, cone, **settings)

        def half_solve(self):
            res = solve(self)
            return res + res[: self._full - len(res)]
        cls.__init__, cls.solve = half_init, half_solve
    elif name == "altered":
        def altered_solve(self):
            res = solve(self)
            y = res[0]["y"]
            i = int(np.argmax(np.abs(y)))
            y[i] = -y[i]
            return res
        cls.solve = altered_solve
    else:
        raise ValueError(f"no fault {name!r}; faults are {FAULTS}")
    try:
        yield
    finally:
        cls.__init__, cls.solve, core.run_seg = saved
