"""The spectral-cone kernels C4 (proj_logdet_vec) and C5 (proj_sl_vec) of
csrc/spectral_proj.cu on the card, at the synthetic shapes and on the rows
phase 15's solves hand them.

    python -m scs_tpu_torch.tools.spectral_proto [--other OLD.cu]
        [--no-capture] [--solves] [--json PATH]

Cases: the synthetic rows of tools/mixed_cone (logdet_rows at LOGDET_CASES,
sl_rows at SL_CASES), f32 and f64, and, unless --no-capture, the rows
captured (CaptureRows) early, in the middle and late in phase 15's two
solves: (a) 64 D-optimal designs in f64, (b) 64 planted problems over both
spectral cones in f32 (generated in worker processes). For each case:

  * the plain version on the CPU (in worker processes) with its counts: the
    plain map's serial passes a row (inner: the root in v's / the capped
    simplex's, outer: the root in mu's), its answer;
  * each build: its answer against the plain version's (max |kernel -
    plain| over max(1, |row|)), a bit-equal repeat, its own serial passes
    a row (its counts), and its device time from CUDA-graph replays of the
    bare entry point, in turns (there and back: the builds in order, then
    in reverse);
  * the difference of the builds' answers from the package's;
  * bound_ms, the roofline of the plain algorithm's work on the rows
    (mixed_cone.spectral_bound_ms, from the plain map's counts), and
    chain_ms, each build's serial floor from its own counts
    (mixed_cone.chain_ms: the longest row's inner passes at this design's
    operations a pass; a579e9c's design counts its evaluations, each a pass
    of its one chain).

--other: a build of an earlier spectral_proj.cu with the same entry points
(`git show a579e9c:scs_tpu_torch/ops/csrc/spectral_proj.cu`, the one-warp-a-
cone design; another layout is timed by editing a copy of the package's
source and passing it here). --solves: phase 15's solves timed with each
build's C4 / C5 in the solver (this, other, other, this). Every line carries the card's name and
power limit (nvidia-smi). --json writes the numbers to PATH. Needs a CUDA
card; nothing runs on import.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import mixed_cone as mc
from .gemv_proto import _bind, card, time_graph_ms

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def build(src, name):
    """A ctypes library of a spectral_proj.cu source with the package's
    entry points."""
    from ..ops import _kernels  # noqa: PLC0415

    return _bind(src, name, _kernels._SYMBOLS["spectral_proj"])


def launch(lib, kind, row, kk, out, inner=None, outer=None):
    """A call of the bare entry point on the current stream: row the inputs
    (t0, v0, w0) or (t0, w0) on the card, out the outputs, inner / outer
    int32 (k,) or None."""
    dtype = row[-1].dtype
    k, n = row[-1].shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if kind == "d":
        fn = getattr(lib, "proj_logdet_vec_" + SUFFIX[dtype])
        args = [*map(ptr, row), *map(ptr, out), ptr(inner), ptr(outer), k, n]
    else:
        fn = getattr(lib, "proj_sl_vec_" + SUFFIX[dtype])
        args = [*map(ptr, row), *map(ptr, out), ptr(inner), ptr(outer), k, n, kk]

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"spectral launch failed: cudaError {rc}")

    return call


def _stats(x):
    return f"max {int(x.max())}, mean {x.mean():.1f}"


def run_case(label, kind, rows_np, kk, dtype, libs, plain, tag, clock_hz):
    """One case through every build, in turns; `plain` the plain version's
    (answer, counts) (a future or the pair)."""
    dev = torch.device("cuda")
    row = [torch.as_tensor(x, dtype=dtype, device=dev) for x in rows_np]
    k, n = row[-1].shape
    outs, counts, times = {}, {}, {name: [] for name in libs}
    calls = {}
    for name, lib in libs.items():
        out = [torch.empty_like(x) for x in row]
        inner, outer = (torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(2))
        launch(lib, kind, row, kk, out, inner, outer)()
        again = [torch.empty_like(x) for x in row]
        launch(lib, kind, row, kk, again)()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"{label} {dtype} {name}: a repeated launch differs")
        outs[name] = [x.cpu().numpy() for x in out]
        counts[name] = (inner.cpu().numpy(), outer.cpu().numpy())
        calls[name] = launch(lib, kind, row, kk, out)
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(time_graph_ms(calls[name], reps=10, inner=5))
    out_p, cnt = plain if isinstance(plain, tuple) else plain.result()
    flat = lambda out: np.concatenate(  # noqa: E731
        [np.asarray(x, np.float64).reshape(k, -1) for x in out], 1)
    scale = np.maximum(np.abs(flat(rows_np)).max(1), 1.0)
    bound, bound_by = mc.spectral_bound_ms(kind, n, dtype, cnt, HBM_BYTES_PER_S, PEAK_FLOPS)
    rec = {"label": label, "dtype": str(dtype)[6:], "k": k, "n": n, "kk": kk, "bound_ms": bound,
           "bound_by": bound_by, "plain_inner_max": int(cnt["inner"].max()),
           "plain_outer_max": int(cnt["outer"].max()), "plain_inner": int(cnt["inner"].sum()),
           "plain_outer": int(cnt["outer"].sum()), "builds": {}}
    print(f"{label} {rec['dtype']}: bound {bound:.6f} ms by {bound_by}; plain map passes a row: "
          f"inner {_stats(cnt['inner'])}, outer {_stats(cnt['outer'])} [{tag}]", flush=True)
    for name in libs:
        inner, outer = counts[name]
        err = float((np.abs(flat(outs[name]) - flat(out_p)).max(1) / scale).max())
        diff = float((np.abs(flat(outs[name]) - flat(outs["this"])).max(1) / scale).max())
        rec["builds"][name] = b = {
            "ms": times[name], "max_err_vs_plain": err, "max_diff_vs_this": diff,
            "inner_max": int(inner.max()), "outer_max": int(outer.max()),
            "inner": int(inner.sum()), "outer": int(outer.sum()),
            "chain_ms": mc.chain_ms(kind, inner, clock_hz)}
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in b['ms'])} ms (in turns); |kernel - "
              f"plain| {err:.2e}, |build - this| {diff:.2e} of max(1, |row|); passes a row inner "
              f"{_stats(inner)}, outer {_stats(outer)}; chain {b['chain_ms']:.6f} ms; "
              f"{bound / min(b['ms']) * 100:.2f}% of bound", flush=True)
    return rec


def _solve(data, K, dtype):
    from .. import BatchedSCS  # noqa: PLC0415

    solver = BatchedSCS(data, K, dtype=dtype, eps_abs=1e-4, eps_rel=1e-4, max_iters=20000,
                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    iters = np.array([r["info"]["iter"] for r in res])
    solved = sum(r["info"]["status"] == "solved" for r in res)
    return secs, solved, iters


def phase15(libs, pool, tag, solves):
    """Phase 15's two batches: (a) the D-optimal designs, f64; (b) the
    planted spectral problems, f32. The rows are captured in the first
    solve, with the package's kernels; with `solves`, each solve timed with
    each build's kernels in the solver, in turns. Returns [(tag,
    CaptureRows, dtype)] and the solve records."""
    from ..ops import projections as pr  # noqa: PLC0415

    fut = mc.gen_mixed_batch(mc.SPECTRAL_K, mc.SPECTRAL_B, mc.SPECTRAL_SEED, pool=pool)
    dopt, _ = mc.gen_dopt_batch(mc.DOPT_B, mc.DOPT_N, mc.DOPT_P, mc.DOPT_SEED)
    planted, _, _ = mc.collect_mixed_batch(fut)
    batches = (("(a)", dopt, mc.dopt_cone(mc.DOPT_N, mc.DOPT_P), "float64"),
               ("(b)", planted, mc.SPECTRAL_K, "float32"))
    caps, records = [], []
    for name, data, K, dtype in batches:
        with mc.CaptureRows() as cap:
            secs, solved, iters = _solve(data, K, dtype)
        caps.append((name, cap, getattr(torch, dtype)))
        print(f"phase 15 {name} {dtype}: {solved}/{len(iters)} solved in {secs:.3f} s, iterations "
              f"mean {iters.mean():.1f}, max {iters.max()} (capture solve, this build) [{tag}]",
              flush=True)
        if not solves:
            continue
        order = list(libs) + list(libs)[::-1]
        for build in order:
            saved = dict(pr._CONE_FNS)
            for fn in ("proj_logdet_vec", "proj_sl_vec"):
                dt = getattr(torch, dtype)
                pr._CONE_FNS[(fn, dt)] = getattr(libs[build], f"{fn}_{SUFFIX[dt]}")
            try:
                secs, solved, iters = _solve(data, K, dtype)
            finally:
                pr._CONE_FNS.clear()
                pr._CONE_FNS.update(saved)
            records.append({"batch": name, "build": build, "solve_s": secs, "solved": solved,
                            "iters_mean": float(iters.mean()), "iters_max": int(iters.max())})
            print(f"phase 15 {name} {dtype} with the {build} build: {solved}/{len(iters)} solved "
                  f"in {secs:.3f} s, iterations mean {iters.mean():.1f}, max {iters.max()} [{tag}]",
                  flush=True)
    return caps, records


def main(argv=None):
    import multiprocessing  # noqa: PLC0415
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor  # noqa: PLC0415

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--other", "--json"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i : i + 2]
    capture, solves = "--no-capture" not in argv, "--solves" in argv
    if not torch.cuda.is_available():
        sys.exit("spectral_proto: PyTorch sees no CUDA device; this runs only on the card")
    from ..ops import _kernels  # noqa: PLC0415
    from .cone_proto import _ptxas  # noqa: PLC0415

    tag = card()
    print(tag, flush=True)
    clock_hz = mc.sm_clock_hz()
    srcs = {"this": ("spectral_proj", None)}
    if "--other" in opts:
        srcs["other"] = ("spectral_proj_other", opts["--other"])
    with ThreadPoolExecutor(len(srcs)) as ex:  # one nvcc a build, all at once
        list(ex.map(lambda ns: _kernels.build(*ns), srcs.values()))
    libs = {}
    for name, (lib, src) in srcs.items():
        libs[name] = _kernels.load(lib) if src is None else build(src, lib)
        print(f"ptxas, {name}: " + _ptxas(lib), flush=True)
    res = {"card": tag, "clock_hz": clock_hz, "cases": [], "solves": []}
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        cases = []
        for dtype in (torch.float32, torch.float64):
            for k, n in mc.LOGDET_CASES:
                cases.append((f"proj_logdet_vec (k={k}, n={n})", "d",
                              mc.logdet_rows(k, n, seed=k + n), None, dtype))
            for k, n, kk, asc in mc.SL_CASES:
                cases.append((f"proj_sl_vec (k={k}, n={n}, kk={kk})", "sl",
                              mc.sl_rows(k, n, kk, seed=k + n + kk, ascending=asc), kk, dtype))
        if capture:
            caps, res["solves"] = phase15(libs, pool, tag, solves)
            for name, cap, dtype in caps:
                ld_in, sl_in = cap.spectral_inputs(f"phase 15 {name}")
                cases += [(f"proj_logdet_vec {lab}", "d", rows, None, dtype)
                          for lab, *rows in ld_in]
                cases += [(f"proj_sl_vec {lab}", "sl", (t0, w0), kk, dtype)
                          for lab, t0, w0, kk in sl_in]
        np_type = {torch.float32: np.float32, torch.float64: np.float64}
        plain = [pool.submit(mc._spectral_plain,
                             (kind, [np.asarray(x, np_type[dtype]) for x in rows], kk))
                 for _, kind, rows, kk, dtype in cases]
        for (label, kind, rows, kk, dtype), p in zip(cases, plain):
            res["cases"].append(run_case(label, kind, rows, kk, dtype, libs, p, tag, clock_hz))
    if "--json" in opts:
        with open(opts["--json"], "w") as fh:
            json.dump(res, fh, indent=1, default=str)


if __name__ == "__main__":
    main()
