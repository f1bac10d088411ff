"""The "auto" phase timers against the instrumented loop, on the card.

    python -m scs_tpu_torch.tools.timer_proto [--runs N] [--json PATH]

On tests/test_observability.py:159's QP (900 x 600, seed 11; f32, passed
in QP_KW as the TPU's default, at eps 1e-5, which is the high-accuracy
mode), N times (default 8): an instrumented solve (phase_timing="always") and an "auto" solve, and the
auto/instrumented ratio of lin_sys + cone an iteration that the reference
test bounds (`ratio()`, which chip_smoke.py's phase 13 and the port's card
test use). The auto estimate is the mean of the rounds the auto solve
timed along its way (`Core.phase_sample`; their count is printed). Beside
each ratio, from the auto solve's two states ([state0, final]) just after
it: the end snapshot (`Core.phase_times` without samples: the loop's
sequence, 5 rounds a state, the estimate before the rounds were spread
over the solve) and the earlier estimate (`phase_times_alone`: each phase
timed alone, back to back), each over the instrumented loop's measurement,
and per phase the earlier estimate over the snapshot's. The card's name and power limit
come first and on every line. Needs a CUDA card; nothing runs on import.
"""

from __future__ import annotations

import json
import sys

import numpy as np

QP_KW = dict(eps_abs=1e-5, eps_rel=1e-5, verbose=False, max_iters=20000, dtype="float32")


def qp_900x600():
    """tests/test_observability.py:159's QP: (data, m)."""
    from scipy import sparse  # noqa: PLC0415

    rng = np.random.RandomState(11)
    m, n = 900, 600
    A = rng.randn(m, n) / np.sqrt(m)
    G = rng.randn(n, n // 8)
    P = 0.1 / (n // 8) * (G @ G.T) + 1e-4 * np.eye(n)
    x = rng.randn(n)
    z = rng.randn(m)
    y = np.maximum(z, 0)
    c = -A.T @ y - P @ x
    b = A @ x + (y - z)
    return {"A": sparse.csc_matrix(A), "b": b, "c": c, "P": sparse.csc_matrix(np.triu(P))}, m


def per_iteration(info):
    """(lin_sys, cone) ms an iteration of a solve's info timers."""
    it = max(info["iter"], 1)
    return 1e3 * info["lin_sys_time"] / it, 1e3 * info["cone_time"] / it


def solves(data, m, **kw):
    """An instrumented and an "auto" solve of the same problem, in that
    order (tests/test_observability.py:159). On the card the kernel library
    is built first: a first build is setup, and would land in the
    instrumented loop's first linear step. Returns (instrumented info, auto
    info, the auto solver)."""
    from .. import SCS  # noqa: PLC0415
    from ..ops import _kernels  # noqa: PLC0415

    if kw.get("device", "cuda") != "cpu":
        _kernels.load("gemv")
    inst = SCS(data, {"l": m}, phase_timing="always", **kw).solve()["info"]
    auto_solver = SCS(data, {"l": m}, phase_timing="auto", **kw)
    auto = auto_solver.solve()["info"]
    return inst, auto, auto_solver


def ratio(data, m, **kw):
    """tests/test_observability.py:159's comparison on the port (`solves`):
    per iteration, lin_sys + cone of the auto estimate over the
    instrumented measurement. Returns (ratio, instrumented info, auto
    info)."""
    inst, auto, _ = solves(data, m, **kw)
    r_i, r_a = sum(per_iteration(inst)), sum(per_iteration(auto))
    return (r_a / r_i if r_i > 0 else float("nan")), inst, auto


def phase_times_alone(core, states, mats):
    """The earlier "auto" estimate: each phase timed alone, a warm call and
    then 5 more, each to a synchronize (solver.mean_call_time); seconds a
    call."""
    from ..solver import mean_call_time  # noqa: PLC0415

    t_lin = t_cone = 0.0
    for st in states:
        lin = core._step_lin(st, mats)
        t_lin += mean_call_time(lambda st=st: core._step_lin(st, mats), core._sync)
        t_cone += mean_call_time(lambda st=st, lin=lin: core._step_cone(st, *lin, mats),
                                 core._sync)
    return {"lin_sys": t_lin / len(states), "cone": t_cone / len(states)}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--runs", "--json"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i : i + 2]
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        sys.exit("timer_proto: PyTorch sees no CUDA device; this runs only on the card")
    from .gemv_proto import card  # noqa: PLC0415

    tag = card()
    print(tag)
    data, m = qp_900x600()
    runs = []
    for _ in range(int(opts.get("--runs", 8))):
        inst, auto, solver = solves(data, m, **dict(QP_KW, device="cuda"))
        r_i = sum(per_iteration(inst))
        core, states = solver.core, [solver._state0, solver._last_state]
        rounds = len(core._phase_samples)
        core._phase_samples, core._phase_cache = [], None
        seq = core.phase_times(states, solver.mats)
        alone = phase_times_alone(core, states, solver.mats)
        r = {"ratio": sum(per_iteration(auto)) / r_i, "iter": (inst["iter"], auto["iter"]),
             "rounds": rounds,
             "instrumented_ms": per_iteration(inst), "auto_ms": per_iteration(auto),
             "sequence": 1e3 * (seq["lin_sys"] + seq["cone"]) / r_i,
             "alone": 1e3 * (alone["lin_sys"] + alone["cone"]) / r_i,
             "alone_over_sequence": {k: alone[k] / seq[k] for k in ("lin_sys", "cone")}}
        runs.append(r)
        print(f"[timers] auto/instrumented {r['ratio']:.3f} (instrumented {inst['iter']} "
              f"iterations, lin_sys {r['instrumented_ms'][0]:.4f} + cone "
              f"{r['instrumented_ms'][1]:.4f} ms an iteration; auto {auto['iter']}, "
              f"{r['auto_ms'][0]:.4f} + {r['auto_ms'][1]:.4f} from {rounds} rounds along the "
              f"solve); from the auto solve's states just after it, over the instrumented: end "
              f"snapshot {r['sequence']:.3f}, each phase alone "
              f"{r['alone']:.3f}; alone over the snapshot: lin_sys "
              f"{r['alone_over_sequence']['lin_sys']:.3f}, cone "
              f"{r['alone_over_sequence']['cone']:.3f} [{tag}]", flush=True)
    for label, key in (("auto/instrumented", "ratio"), ("end snapshot/instrumented", "sequence")):
        ratios = np.array([r[key] for r in runs])
        print(f"[timers] {len(ratios)} {label} ratios {ratios.min():.3f}-{ratios.max():.3f}, "
              f"sd {ratios.std():.3f}: {int(((ratios <= 0.8) | (ratios >= 1.25)).sum())} outside "
              f"0.8-1.25, {int(((ratios <= 0.7) | (ratios >= 1.43)).sum())} outside 0.7-1.43 "
              f"[{tag}]")
    if "--json" in opts:
        with open(opts["--json"], "w") as fh:
            json.dump({"card": tag, "runs": runs}, fh, indent=1)


if __name__ == "__main__":
    main()
