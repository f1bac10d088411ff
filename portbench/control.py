"""The readings the limits of `correct` are set from, at a cell's own size,
on the card: sound runs (the program as the configuration states it), the
control (the program with its float32 path switched on, the nearest
precision below the configuration's float64) and the planted faults of
faults.py, each over a window of whole batches like a run's and the batch
drawn afresh from the seed after it, all in one process:

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 20 \
        [--modes sound,float32,unchanged,half,altered]

One JSON line a (seed, mode): the reference's numbers, the batches, and the
problems attempted and solved. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

MODES = ("sound", "float32", "unchanged", "half", "altered")


def reading(cfg, traffic, seed, seconds, mode, device):
    from portbench import faults, harness  # noqa: PLC0415

    override = {"dtype": "float32"} if mode == "float32" else None
    st = harness.settings_of(cfg, traffic, device)
    with faults.planted(mode) if mode in faults.FAULTS else contextlib.nullcontext():
        run = harness.run_cell(cfg, traffic, seed, seconds, device=device, override=override)
        batches = [(b.construct_s + b.solve_s, int(b.iters.max())) for b in run.batches]
        numbers = harness.check(run, float(st["eps_abs"]), float(st["eps_rel"]))
    return {
        "seed": seed, "mode": mode, "batches": len(run.batches),
        "attempted": run.attempted, "solved": run.solved, "window_s": run.window_s,
        "batch_s": [t for t, _ in batches],
        "batch_max_iter": [i for _, i in batches],
        **numbers,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import registry  # noqa: PLC0415

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            if mode not in MODES:
                raise SystemExit(f"no mode {mode!r}; modes are {MODES}")
            row = reading(cfg, traffic, seed, args.seconds, mode, args.device)
            print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
