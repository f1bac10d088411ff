"""Run one cell of the benchmark once, on the card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number the reference compared beside its limit; the
same numbers are the last lines of standard error. Exits 1 with no result
when PyTorch sees fewer CUDA devices than the cell asks for, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# top-level module names the run must not load, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "scs_tpu")


def forbidden_modules(modules=None):
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _num(v):
    """A reading as JSON holds it: an infinite or NaN one as its name."""
    return v if math.isfinite(v) else str(v)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, registry  # noqa: PLC0415

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])

    import scs_tpu_torch  # noqa: F401, PLC0415  (the system under test: no result without it)
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": int(cell["chips"]),
    }
    run = harness.run_cell(cfg, traffic, args.seed, args.seconds, trace=bool(args.trace),
                           device="cuda", t_start=T_START, device_info=device_info)
    device_info["memory_peak_bytes"] = int(max(run.peak_bytes, run.setup_peak_bytes))
    group = bench["per_layer"] if args.trace else bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in group}
    names = registry.cell_metrics(bench, cell["name"], bool(args.trace))
    metrics = harness.metrics(run, [(n, units[n]) for n in names])
    out = {
        "correct": False,
        "attempted": run.attempted,
        "failed": run.attempted - run.solved,
        "metrics": metrics,
        "device": device_info,
    }
    if args.trace:
        t = run.trace
        device_info["busy_s"] = t.busy_ns() / 1e9
        device_info["window_s"] = (t.span_ns[1] - t.span_ns[0]) / 1e9
        out["breakdown"] = {
            "device_ops": [[n[:200], ns / 1e9] for n, ns in t.top_ops()],
            "idle_gaps": [[n[:200], ns / 1e9] for n, ns in t.idle_gaps()],
        }
    out["window_s"] = run.window_s
    out["batch_s"] = [b.construct_s + b.solve_s for b in run.batches]
    out["batch_max_iter"] = [int(b.iters.max()) for b in run.batches]
    out["power_limit_W"] = _power_limit()
    run.trace = None
    st = harness.settings_of(cfg, traffic, "cuda")
    numbers = harness.check(run, float(st["eps_abs"]), float(st["eps_rel"]))
    correct, rows = harness.reference.judge(numbers, cfg["limits"])
    out["correct"] = correct
    out["readings"] = {k: _num(v) for k, v in numbers.items() if k not in cfg["limits"]}
    out["checks"] = {k: {"value": _num(v), "limit": lim} for k, v, lim in rows}
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the run must not load: {found}", file=sys.stderr)
        return 1
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
