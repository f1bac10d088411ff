"""The recording of the batched solve (scs_tpu_torch/trace.py) on the card.

    python -m scs_tpu_torch.tools.trace_proto [--batch B] [--pairs R] [--cpu] [--json PATH]

On B dense QPs (default 512; `bench_cli.gen_batch_device`'s recipe at n
1000, m 1500, in float64, at eps 1e-4 and eps_infeas 1e-7 under the direct
strategy), after a warm-up solve capped at 100 iterations:

1. the cost of recording: R pairs (default 3) of whole batches (a fresh
   copy, `BatchedSCS(...)`, `.solve()`, timed on the host between device
   synchronizes), recording off and on in turns (off, on, on, off, ...),
   and the host's ns a span and a sync cost, off and on;
2. one batch under torch.profiler (CUDA activity, as the benchmark's
   traced window): the clock check, the share of counted syncs whose stamp
   lies within 100 us after the end of a runtime call that waits
   (`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaMemcpy*`); the
   waiting calls after which no count follows within 100 us, by the
   innermost span they lie in; syncs by site with the device-idle time of
   the gaps they returned in; spans by name with their time and the
   device's idle time inside them. With --cpu, a second batch profiled
   with the host's aten operations names the operations around each wait
   that no count follows.

The card's name and power limit come first. Needs a CUDA card; nothing runs
on import.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
LAG_NS = 100_000
SETTINGS = dict(dtype="float64", eps_abs=1e-4, eps_rel=1e-4, eps_infeas=1e-7,
                solver_strategy="direct", device="cuda")


def _card():
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return f"{torch.cuda.get_device_name(0)}, power limit {limit}"


def _interval_ns(ev):
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def _batch(base, cone):
    from scs_tpu_torch import BatchedSCS  # noqa: PLC0415

    data = {k: v.clone() for k, v in base.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = BatchedSCS(data, cone, **SETTINGS)
    res = solver.solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, solver, res


def cost_of_recording(base, cone, pairs):
    """Seconds of whole batches with recording off and on, in turns."""
    from scs_tpu_torch import trace  # noqa: PLC0415

    times = {"off": [], "on": []}
    for r in range(pairs):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if side == "on":
                with trace.recording():
                    secs = _batch(base, cone)[0]
            else:
                secs = _batch(base, cone)[0]
            trace.clear()
            times[side].append(secs)
            print(f"batch recording {side}: {secs:.4f} s", flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"recording on-cost: median off {med['off']:.4f} s, on {med['on']:.4f} s, "
          f"on/off {med['on'] / med['off']:.5f}", flush=True)
    return {"times": times, "median": med, "ns_per_call": cost_per_call()}


def cost_per_call(n=100_000):
    """Host ns of one span (open and close) and of one sync, recording off
    and on: the median of 5 rounds of n calls each."""
    from scs_tpu_torch import trace  # noqa: PLC0415

    def span():
        with trace.span("x"):
            pass

    def sync():
        trace.host_sync("x")

    out = {}
    for name, call in (("span", span), ("sync", sync)):
        for side in ("off", "on"):
            rounds = []
            for _ in range(5):
                with trace.recording() if side == "on" else contextlib.nullcontext():
                    t0 = time.perf_counter_ns()
                    for _ in range(n):
                        call()
                    rounds.append((time.perf_counter_ns() - t0) / n)
                trace.clear()
            out[f"{name}_{side}"] = statistics.median(rounds)
    print("host ns a call:", {k: round(v, 1) for k, v in out.items()}, flush=True)
    return out


def _gaps(ops, lo, hi):
    gaps, end = [], lo
    for s, e in sorted(ops):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def _idle_in(gaps, a, b):
    return sum(max(0, min(g1, b) - max(g0, a)) for g0, g1 in gaps)


def traced_batch(base, cone, cpu=False):
    """One batch under the profiler: the clock check and the breakdowns.
    With `cpu`, the host's aten operations are traced too, and each wait
    no count follows is named by the operations around it."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    from scs_tpu_torch import trace  # noqa: PLC0415

    trace.clear()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        lo = time.time_ns()
        _, solver, res = _batch(base, cone)
        hi = time.time_ns()
    cuda = torch.autograd.DeviceType.CUDA
    ops, waits, aten, host = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = _interval_ns(ev)
        if ev.device_type() == cuda:
            ops.append((s, e))
            continue
        host.append((s, e, ev.name()))
        if ev.name().startswith(WAITS):
            waits.append((e, s, ev.name()))
        elif ev.name().startswith("aten::"):
            aten.append((s, e, ev.name()))
    waits.sort()
    recs = trace.records(lo, hi)
    spans = [r for r in recs if isinstance(r, trace.Span)]
    syncs = sorted((r for r in recs if isinstance(r, trace.Sync)), key=lambda r: r.t)
    by_id = {sp.id: sp for sp in spans}
    gaps = _gaps(ops, lo, hi)
    iters = max(r["info"]["iter"] for r in res)
    out = {"iters": iters, "window_ms": (hi - lo) / 1e6,
           "idle_ms": sum(g1 - g0 for g0, g1 in gaps) / 1e6,
           "bucket_ladder": solver.bucket_ladder, "device_prob_iters": solver.device_prob_iters,
           "syncs": len(syncs),
           "syncs_per_iter": len(syncs) / iters, "setup_breakdown": solver.setup_breakdown}

    # the clock check: each count follows the end of a waiting call
    ends = [w[0] for w in waits]
    lags = []
    for r in syncs:
        i = bisect.bisect_right(ends, r.t) - 1
        lags.append(r.t - ends[i] if i >= 0 else None)
    near = [x for x in lags if x is not None and x <= LAG_NS]
    by_site = defaultdict(list)
    for r, x in zip(syncs, lags):
        by_site[r.site].append(x)
    late = []
    for r, x in zip(syncs, lags):
        if x is not None and x <= LAG_NS:
            continue
        i = bisect.bisect_right(ends, r.t) - 1
        w0, w1 = (waits[i][1], waits[i][0]) if i >= 0 else (lo, lo)
        late.append({"site": r.site, "at_ms": (r.t - lo) / 1e6, "lag_us": (r.t - w1) / 1e3,
                     "wait_ms": (w1 - w0) / 1e6,
                     "between": sorted({h[2] for h in host if h[1] > w1 and h[0] < r.t})})
    out["clock"] = {
        "late": late,
        "lag_by_time": [(round((r.t - lo) / 1e6, 1), round(x / 1e3, 1))
                        for r, x in zip(syncs, lags) if x is not None],
        "within_100us": len(near) / max(len(syncs), 1),
        "lag_us_median": statistics.median(near) / 1e3 if near else None,
        "lag_us_max": max(near) / 1e3 if near else None,
        "by_site": {k: {"count": len(v), "within": sum(x is not None and x <= LAG_NS for x in v),
                        "lag_us": sorted(round(x / 1e3, 1) for x in v if x is not None)[-3:]}
                    for k, v in by_site.items()},
    }
    # waiting calls no count follows: waits the recording does not see
    stamps = [r.t for r in syncs]
    unseen = defaultdict(lambda: [0, 0])
    for e, s, name in waits:
        if not name.startswith(("cudaStreamSynchronize", "cudaDeviceSynchronize")):
            continue
        i = bisect.bisect_left(stamps, e)
        if i < len(stamps) and stamps[i] - e <= LAG_NS:
            continue
        inner = [sp for sp in spans if sp.t0 <= s and e <= sp.t1]
        where = max(inner, key=lambda sp: sp.t0).name if inner else "-"
        around = sorted((a for a in aten if a[0] <= s and e <= a[1]), key=lambda a: a[0])
        if around:  # the outermost and the innermost aten operation around the wait
            where += f" in {around[0][2]} / {around[-1][2]}"
        unseen[(name, where)][0] += 1
        unseen[(name, where)][1] += e - s
    out["unseen_waits"] = [
        {"call": k[0], "span": k[1], "count": v[0], "ms": v[1] / 1e6}
        for k, v in sorted(unseen.items(), key=lambda kv: -kv[1][1])]
    # syncs by site, with the idle time of the gaps they returned in
    sites = defaultdict(lambda: [0, 0.0])
    starts = [g[0] for g in gaps]
    taken = set()
    for r in syncs:
        sites[r.site][0] += 1
        i = bisect.bisect_right(starts, r.t) - 1
        if i >= 0 and gaps[i][1] >= r.t and i not in taken:
            taken.add(i)
            sites[r.site][1] += (gaps[i][1] - gaps[i][0]) / 1e6
    out["sites"] = {k: {"count": v[0], "gap_idle_ms": v[1]} for k, v in
                    sorted(sites.items(), key=lambda kv: -kv[1][1])}
    # spans by name: time and the device's idle time inside them
    names = defaultdict(lambda: [0, 0, 0])
    buckets = defaultdict(lambda: [0, 0, 0])  # segments by bucket: chunks, ns, idle ns
    for sp in spans:
        d = names[sp.name]
        idle = _idle_in(gaps, sp.t0, sp.t1)
        d[0] += 1
        d[1] += sp.t1 - sp.t0
        d[2] += idle
        if sp.name == "solve.segment":
            b = buckets[sp.attrs["bucket"]]
            b[0] += sp.attrs["chunks"]
            b[1] += sp.t1 - sp.t0
            b[2] += idle
    out["spans"] = {k: {"count": v[0], "ms": v[1] / 1e6, "idle_ms": v[2] / 1e6}
                    for k, v in names.items()}
    out["segments_by_bucket"] = {k: {"chunks": v[0], "ms": v[1] / 1e6, "idle_ms": v[2] / 1e6}
                                 for k, v in sorted(buckets.items(), reverse=True)}
    floor = [sp.t0 for sp in spans if sp.name == "solve.segment"
             and sp.attrs["bucket"] <= solver._MIN_BUCKET]
    seg_end = max((sp.t1 for sp in spans if sp.name == "solve.segment"), default=lo)
    out["floor_ms"] = (seg_end - min(floor)) / 1e6 if floor else 0.0
    out["parents"] = sorted({(sp.name, by_id[sp.parent].name if sp.parent else None)
                             for sp in spans})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="profile a second batch with the host's operations, naming unseen waits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_proto: needs a CUDA card", file=sys.stderr)
        return 1
    from scs_tpu_torch import BatchedSCS  # noqa: PLC0415
    from scs_tpu_torch.bench_cli import gen_batch_device  # noqa: PLC0415

    print(_card(), flush=True)
    m, n = 1500, 1000
    A, P, b, c = gen_batch_device(args.batch, m, n, seed=20, device="cuda")
    base = {"A": A.double(), "P": P.double(), "b": b.double(), "c": c.double()}
    del A, P, b, c
    cone = {"l": m}
    warm = {k: v.clone() for k, v in base.items()}
    BatchedSCS(warm, cone, **dict(SETTINGS, max_iters=100)).solve()
    del warm
    torch.cuda.synchronize()
    out = {"card": _card(), "batch": args.batch}
    if args.pairs:
        out["cost"] = cost_of_recording(base, cone, args.pairs)
    out["traced"] = t = traced_batch(base, cone)
    print(json.dumps({k: v for k, v in t.items() if k not in ("parents", "clock")}, indent=1),
          flush=True)
    print("clock:", json.dumps({k: v for k, v in t["clock"].items() if k != "lag_by_time"}),
          flush=True)
    print("span tree:", t["parents"], flush=True)
    if args.cpu:
        out["traced_cpu"] = t = traced_batch(base, cone, cpu=True)
        print("with the host's operations:", json.dumps(
            {k: t[k] for k in ("clock", "unseen_waits", "syncs")}, indent=1), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
