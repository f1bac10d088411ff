"""The sharded CG's S x in one collective against Core's form, in turns on
the card.

    python -m scs_tpu_torch.tools.sharded_proto [--turns N] [--json PATH]

Both sharded cores override `_matvec_S`: a rank's rows of dy * (A x) are
its own products, so S x = rho_x x + A' D A x (+ P x) needs one
all_gather, the sum of the ranks' A' partials (with a bell P, its rows of
P x travel in the same gather). `Core._matvec_S` computes the same bits
through the cores' own A x and A'y: a gather and a sum, two all_gathers
(three with a bell P). This script solves chip_smoke.py phase 14's
problems both ways on one instance, in turns (fused, Core's, Core's,
fused, N times; default N = 1), each a cold solve:

  * the bench's bell LP (30000 x 20000) through ShardedSCS "bell", f32,
    eps 1e-4, at one NCCL rank and at two gloo ranks on one card;
  * the hi_acc cell's first QP (1500 x 1000, seed 4321) dense under
    "indirect" at two gloo ranks, f32, eps 1e-4.

Per solve: iterations, CG iterations, all_gathers, solve seconds, and
whether x, y and s are bit-equal to the first fused solve's. The card's
name and power limit come first. Needs a CUDA card; nothing runs on
import.
"""

from __future__ import annotations

import json
import sys
import time
import types

import numpy as np

WORLD_TIMEOUT = 1200.0  # seconds a world may take, its spawn included


def _problem(name):
    """(data, cone, settings) of a phase-14 problem."""
    if name == "bell":
        from ..bench_cli import gen_bell_lp  # noqa: PLC0415

        m, n = 30000, 20000
        return gen_bell_lp(m, n, 0.002), {"l": m}, dict(
            solver_strategy="bell", bell_block_size=128, eps_abs=1e-4, eps_rel=1e-4
        )
    from .flagship import gen_batch  # noqa: PLC0415

    A, P, b, c = gen_batch(32, 1500, 1000, seed=4321)
    return {"A": A[0], "P": P[0], "b": b[0], "c": c[0]}, {"l": 1500}, dict(
        allow_dense_input=True, dtype="float32", eps_abs=1e-4, eps_rel=1e-4
    )


def _rank(name, device, turns):
    """One rank: build the solver once, then cold solves in turns, the
    override swapped for Core._matvec_S on the instance for the unfused
    ones."""
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from ..parallel import ShardedSCS, make_mesh  # noqa: PLC0415
    from ..parallel.comm import gather_list  # noqa: PLC0415
    from ..parallel.mesh import rank_device  # noqa: PLC0415
    from ..solver import Core  # noqa: PLC0415

    rank_device(device, dist.group.WORLD)
    data, cone, kw = _problem(name)
    solver = ShardedSCS(data, cone, mesh=make_mesh(axis_name="rows"), max_iters=50000,
                        verbose=False, device=device, **kw)
    core, out, first = solver.core, [], None
    for fused in [True, False, False, True] * turns:
        if fused:
            core.__dict__.pop("_matvec_S", None)
        else:
            core._matvec_S = types.MethodType(Core._matvec_S, core)
        torch.cuda.synchronize()
        gather_list.calls = 0
        sol = solver.solve(warm_start=False)
        torch.cuda.synchronize()
        first = first or sol
        info = sol["info"]
        out.append(dict(
            fused=fused, status=info["status"], iter=info["iter"],
            cg_iters=int(solver._last_state.cg_iters), gathers=gather_list.calls,
            solve=info["solve_time"],
            bit_equal=all(np.array_equal(sol[k], first[k]) for k in ("x", "y", "s")),
        ))
    return out


def run(name, world, backend, turns):
    """The turns of one problem in one world; every rank's records."""
    from ..parallel.dryrun import spawn_world  # noqa: PLC0415
    from . import sharded_proto  # under its own name, so the ranks find _rank under -m too

    device = "cuda" if backend == "nccl" else "cuda:0"
    return spawn_world(world, sharded_proto._rank, (name, device, turns), backend=backend,
                       timeout=WORLD_TIMEOUT)


def main(argv=None):
    from .gemv_proto import card  # noqa: PLC0415

    argv = sys.argv[1:] if argv is None else argv
    turns = int(argv[argv.index("--turns") + 1]) if "--turns" in argv else 1
    json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
    tag = card()
    print(tag, flush=True)
    report = []
    for name, world, backend in (("bell", 1, "nccl"), ("bell", 2, "gloo"), ("dense", 2, "gloo")):
        t0 = time.perf_counter()
        res = run(name, world, backend, turns)
        for r, recs in enumerate(res):
            for rec in recs:
                if rec["status"] != "solved" or not rec["bit_equal"]:
                    raise AssertionError(f"{name} world {world} rank {r}: {rec}")
        for i, rec in enumerate(res[0]):
            print(f"{name} world {world} ({backend}) solve {i}: "
                  f"{'fused' if rec['fused'] else 'Core'} S x, {rec['iter']} iterations, "
                  f"{rec['cg_iters']} CG, {rec['gathers']} all_gathers a rank, solve "
                  f"{rec['solve']:.3f} s; x, y, s bit-equal to solve 0 on every rank [{tag}]",
                  flush=True)
        fused = [rec["solve"] for rec in res[0] if rec["fused"]]
        plain = [rec["solve"] for rec in res[0] if not rec["fused"]]
        print(f"{name} world {world} ({backend}): fused {min(fused):.3f}-{max(fused):.3f} s, "
              f"Core's {min(plain):.3f}-{max(plain):.3f} s; world wall "
              f"{time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
        report.append(dict(problem=name, world=world, backend=backend, solves=res[0]))
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"card": tag, "runs": report}, f, indent=1)


if __name__ == "__main__":
    main()
