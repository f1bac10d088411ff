"""Every main path of the port in float32 and float64 on the card: the
measurements behind the CUDA default dtype (settings.AUTO_DTYPE).

    python -m scs_tpu_torch.tools.dtype_proto [--only NAME,...] [--rounds N]
        [--json PATH]
    python -m scs_tpu_torch.tools.dtype_proto --device cpu --small   # rehearsal

Workloads (WORKLOADS; chip_smoke.py's generators and sizes, from
tools/workloads.py, bench_cli.py, tools/flagship.py and tools/mixed_cone.py):

  flagship        512 dense QPs of 1500 x 1000, BatchedSCS "direct", eps 1e-4
                  (flagship.gen_qp_batch on the card, f32 data, seed 1234)
  dense_*         one dense QP of 300 x 200 (workloads.gen_dense_qp) under
                  "direct" and "indirect", eps 1e-4 and 1e-6
  bell            the 30000 x 20000 block-sparse LP under "bell", eps 1e-4
  bell_batch      8 LPs of 30720 x 20480 through BatchedSCS "bell", eps 1e-4
  mixed_cone      64 problems of 185 x 61 over MIXED_K, eps 1e-4, scale 1
  mixed_wide      128 problems of 5313 x 1771 over wide_cone(), eps 1e-4, scale 1
  hi_acc_*        32 QPs of 1500 x 1000 (flagship.gen_batch, seed 4321), eps
                  1e-4 (no polish) and 1e-6 (max_iters 50,000)
  dopt            64 D-optimal designs of 787 x 257, eps 1e-4 (max_iters 5,000)
  spectral        64 planted problems of 840 x 280 over SPECTRAL_K, eps 1e-4
  status_*        the infeasible and the unbounded LP of 1200 x 800
                  (workloads.gen_status_lps) under "direct", "indirect" and
                  "bell", the default eps_infeas 1e-7, max_iters 20,000
  *_eps_infeas_1e-5  the status LPs and the z / l workloads at eps 1e-4 again
                  at eps_infeas 1e-5 (chip_smoke.py phase 16's)

Every other setting is the solver's default, or the one chip_smoke.py
passes for the same workload (scale 1 on mixed_cone and mixed_wide). The data
is generated once, in float64 (the flagship's on the card in float32, as
the bench draws it), and handed unchanged to both dtypes. Each workload
runs `--rounds` rounds (default 3) in turns: f32 then f64, then f64 then
f32, and so on. For each run: the statuses, mean and max iterations, setup
and solve seconds (host clock, each ending in torch.cuda.synchronize()),
peak device memory (reset_peak_memory_stats() before the solver is built,
max_memory_allocated() after its solve; the caller's data on the card
included), and on the host in f64 the worst KKT residual over its limit
at eps (workloads.kkt_check's measure) over the solved problems, or the
certificate's residual for a status LP. One line a run; the card's name and
power limit first; --json writes every run (after each workload, so a cut
call keeps what it finished). Needs a CUDA card unless --device cpu; nothing
runs on import. --small shrinks every workload for a rehearsal on the CPU:
its numbers measure nothing.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from collections import Counter

import numpy as np
import torch

from . import workloads as wl
from ..bench_cli import gen_bell_batch, gen_bell_lp

DTYPES = ("float32", "float64")
STATUS_MAX_ITERS = 20_000  # the status LPs' cap, for time (default 100,000)
DOPT_MAX_ITERS = 5_000  # f64 solves all 64 in at most 1,850 (PERF.md)
HI_MAX_ITERS = 50_000  # chip_smoke.py phase 11's
INF = float("inf")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated() / 1e9
    return None


def _timed(device, build, solve):
    """(results, setup s, solve s, peak GB): build() then solve(solver), each
    ended by a synchronize; the peak device memory from before the build to
    the end of the solve (None on the CPU)."""
    _peak_reset(device)
    t0 = time.perf_counter()
    solver = build()
    _sync(device)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve(solver)
    _sync(device)
    return res, setup, time.perf_counter() - t0, _peak_gb(device)


def _summary(res):
    """(statuses Counter as a dict, mean iterations, max iterations)."""
    res = res if isinstance(res, list) else [res]
    its = np.array([r["info"]["iter"] for r in res])
    return dict(Counter(r["info"]["status"] for r in res)), float(its.mean()), int(its.max())


def _kkt_single(data, sol, eps):
    """workloads.kkt_check's worst ratio of one LP / QP over the nonnegative
    cone (no margin: the ratio is returned, nothing raises)."""
    return max(wl.kkt_check(data, sol, eps, margin=INF))


def _kkt_mixed(K, data, res, eps, A_rows=None):
    """The worst f64 residual over its limit (pri, dual, gap) of the solved
    problems of a mixed-cone batch (mixed_cone._check_one without cones)."""
    from . import mixed_cone as mc  # noqa: PLC0415

    worst = None
    for i, r in enumerate(res):
        if r["info"]["status"] == "solved":
            A = data["A"][i] if A_rows is None else A_rows[i]
            job = (K, A, data["b"][i], data["c"][i], r["x"], r["y"], r["s"], eps, False)
            worst = max(worst or 0.0, *mc._check_one(job)[:3])
    return worst


def _certificate(data, sol):
    """The residual of an infeasible / unbounded LP's certificate
    (workloads.certificate); None for another status."""
    cert = wl.certificate(data, sol)
    return None if cert is None else float(cert[0])


# ---------------------------------------------------------------------------
# Workloads: make(small, device, pool, extra settings) -> (run, config); run(dtype) ->
# (results, setup s, solve s, peak GB, KKT or certificate)
# ---------------------------------------------------------------------------


def _flagship(small, device, pool, extra):
    import scs_tpu_torch as st  # noqa: PLC0415
    from .flagship import FLAGSHIP, gen_qp_batch, kkt_check_batch  # noqa: PLC0415

    B, m, n = (4, 60, 40) if small else FLAGSHIP
    data, _, _ = gen_qp_batch(B, m, n, seed=1234, device=device)
    eps = 1e-4

    def run(dtype):
        res, setup, solve, peak = _timed(
            device,
            lambda: st.BatchedSCS(data, {"l": m}, dtype=dtype, eps_abs=eps, eps_rel=eps,
                                  max_iters=200 if small else 20000, device=device, **extra),
            lambda s: s.solve())
        solved = [i for i, r in enumerate(res) if r["info"]["status"] == "solved"]
        kkt = None
        if solved:
            sub = {k: v[solved] for k, v in data.items()}
            kkt = max(kkt_check_batch(sub, [res[i] for i in solved], eps, margin=INF))
        return res, setup, solve, peak, kkt

    return run, dict(B=B, m=m, n=n, eps=eps, strategy="direct (batched, inverse)")


def _dense(strategy, eps):
    def make(small, device, pool, extra):
        import scs_tpu_torch as st  # noqa: PLC0415

        m, n = (60, 40) if small else (wl.DENSE_QP_M, wl.DENSE_QP_N)
        data, _ = wl.gen_dense_qp(m, n)

        def run(dtype):
            sol, setup, solve, peak = _timed(
                device,
                lambda: st.SCS(data, {"l": m}, dtype=dtype, solver_strategy=strategy,
                               eps_abs=eps, eps_rel=eps, max_iters=200 if small else 100_000,
                               verbose=False, device=device, **extra),
                lambda s: s.solve())
            ok = sol["info"]["status"] == "solved"
            return sol, setup, solve, peak, _kkt_single(data, sol, eps) if ok else None

        return run, dict(m=m, n=n, eps=eps, strategy=strategy)

    return make


def _bell(small, device, pool, extra):
    import scs_tpu_torch as st  # noqa: PLC0415

    m, n = (600, 400) if small else (wl.BELL_M, wl.BELL_N)
    data = gen_bell_lp(m, n, 0.02 if small else wl.BELL_DENSITY)
    eps = wl.BELL_EPS

    def run(dtype):
        sol, setup, solve, peak = _timed(
            device,
            lambda: st.SCS(data, {"l": m}, dtype=dtype, solver_strategy="bell", eps_abs=eps,
                           eps_rel=eps, max_iters=200 if small else 50000, verbose=False,
                           device=device, **extra),
            lambda s: s.solve())
        ok = sol["info"]["status"] == "solved"
        return sol, setup, solve, peak, _kkt_single(data, sol, eps) if ok else None

    return run, dict(m=m, n=n, eps=eps, strategy="bell")


def _bell_batch(small, device, pool, extra):
    import scs_tpu_torch as st  # noqa: PLC0415

    B, m, n = (2, 512, 384) if small else (wl.BATCH_B, wl.BATCH_M, wl.BATCH_N)
    data = gen_bell_batch(B, m, n, 0.02 if small else wl.BATCH_DENSITY, wl.BATCH_WIDTH,
                          wl.BATCH_SEED)
    eps = wl.BATCH_EPS

    def run(dtype):
        res, setup, solve, peak = _timed(
            device,
            lambda: st.BatchedSCS(data, {"l": m}, solver_strategy="bell", dtype=dtype,
                                  eps_abs=eps, eps_rel=eps, max_iters=200 if small else 20000,
                                  verbose=False, device=device, **extra),
            lambda s: s.solve())
        kkt = [_kkt_single({"A": data["A"][i], "b": data["b"][i], "c": data["c"][i]}, r, eps)
               for i, r in enumerate(res) if r["info"]["status"] == "solved"]
        return res, setup, solve, peak, max(kkt) if kkt else None

    return run, dict(B=B, m=m, n=n, eps=eps, strategy="bell (batched)")


def _mixed_runner(K, data, device, small, extra, A_rows=None, max_iters=20000):
    import scs_tpu_torch as st  # noqa: PLC0415
    from . import mixed_cone as mc  # noqa: PLC0415

    eps = mc.MIXED_EPS

    def run(dtype):
        res, setup, solve, peak = _timed(
            device,
            lambda: st.BatchedSCS(data, K, dtype=dtype, eps_abs=eps, eps_rel=eps,
                                  max_iters=min(max_iters, 200) if small else max_iters,
                                  device=device, **extra),
            lambda s: s.solve())
        return res, setup, solve, peak, _kkt_mixed(K, data, res, eps, A_rows)

    return run


def _mixed_cone(small, device, pool, extra):
    from . import mixed_cone as mc  # noqa: PLC0415

    K = mc.MIXED_K
    data, _ = mc.gen_mixed_batch(K, 4 if small else mc.MIXED_B, mc.MIXED_SEED)
    B, m, n = data["A"].shape
    return _mixed_runner(K, data, device, small, extra), dict(
        B=B, m=m, n=n, eps=mc.MIXED_EPS, strategy="direct (batched)")


def _mixed_wide(small, device, pool, extra):
    from . import mixed_cone as mc  # noqa: PLC0415

    K = mc.wide_cone(bounds=40, ep=10, ed=5, powers=5) if small else mc.wide_cone()
    data, _, A_rows = mc.collect_mixed_batch(
        mc.gen_mixed_batch(K, 2 if small else mc.WIDE_B, wl.WIDE_SEED, pool=pool))
    B, m, n = data["A"].shape
    return _mixed_runner(K, data, device, small, extra, A_rows), dict(
        B=B, m=m, n=n, eps=mc.MIXED_EPS, strategy="direct (batched)")


def _hi_acc(eps):
    def make(small, device, pool, extra):
        import scs_tpu_torch as st  # noqa: PLC0415
        from .flagship import gen_batch, kkt_check_batch  # noqa: PLC0415

        B, m, n = (2, 60, 40) if small else (wl.HI_B, wl.HI_M, wl.HI_N)
        A, P, b, c = gen_batch(B, m, n, seed=wl.HI_SEED)
        host = {"A": A, "P": P, "b": b, "c": c}
        max_iters = 200 if small else HI_MAX_ITERS

        def run(dtype):
            res, setup, solve, peak = _timed(
                device,
                lambda: st.BatchedSCS(host, {"l": m}, dtype=dtype, eps_abs=eps, eps_rel=eps,
                                      max_iters=max_iters, device=device, **extra),
                lambda s: s.solve())
            solved = [i for i, r in enumerate(res) if r["info"]["status"] == "solved"]
            kkt = None
            if solved:
                sub = {k: torch.as_tensor(v[solved], device=device) for k, v in host.items()}
                kkt = max(kkt_check_batch(sub, [res[i] for i in solved], eps, margin=INF))
            return res, setup, solve, peak, kkt

        return run, dict(B=B, m=m, n=n, eps=eps, strategy="direct (batched, inverse)",
                         max_iters=max_iters)

    return make


def _dopt(small, device, pool, extra):
    from . import mixed_cone as mc  # noqa: PLC0415

    B, nn, p = (2, 4, 16) if small else (mc.DOPT_B, mc.DOPT_N, mc.DOPT_P)
    K = mc.dopt_cone(nn, p)
    data, _ = mc.gen_dopt_batch(B, nn, p, mc.DOPT_SEED)
    _, m, n = data["A"].shape
    run = _mixed_runner(K, data, device, small, extra, max_iters=DOPT_MAX_ITERS)
    return run, dict(B=B, m=m, n=n, eps=mc.MIXED_EPS, strategy="direct (batched)",
                     max_iters=DOPT_MAX_ITERS)


def _spectral(small, device, pool, extra):
    from . import mixed_cone as mc  # noqa: PLC0415

    K = {"z": 2, "l": 8, "sl_n": [4], "sl_k": [2], "d": [3]} if small else mc.SPECTRAL_K
    data, _, A_rows = mc.collect_mixed_batch(
        mc.gen_mixed_batch(K, 2 if small else mc.SPECTRAL_B, mc.SPECTRAL_SEED, pool=pool))
    B, m, n = data["A"].shape
    return _mixed_runner(K, data, device, small, extra, A_rows), dict(
        B=B, m=m, n=n, eps=mc.MIXED_EPS, strategy="direct (batched)")


def _status(which, strategy):
    def make(small, device, pool, extra):
        import scs_tpu_torch as st  # noqa: PLC0415

        m, n = (120, 80) if small else (wl.STATUS_M, wl.STATUS_N)
        lps = wl.gen_status_lps(m, n, 0.2 if small else wl.STATUS_DENSITY, wl.STATUS_SEED)
        data = lps[1 if which == "infeasible" else 2]
        max_iters = 200 if small else STATUS_MAX_ITERS

        def run(dtype):
            sol, setup, solve, peak = _timed(
                device,
                lambda: st.SCS(data, {"l": m}, dtype=dtype, solver_strategy=strategy,
                               max_iters=max_iters, verbose=False, device=device, **extra),
                lambda s: s.solve())
            return sol, setup, solve, peak, _certificate(data, sol)

        return run, dict(m=m, n=n, strategy=strategy, max_iters=max_iters, expect=which)

    return make


# eps_infeas 1e-5: chip_smoke.py phase 16's, where f32 certifies the status
# LPs; the z / l workloads again there, where f32 could be the faster dtype
# that certifies
LOOSE = {"eps_infeas": 1e-5}
MIXED = {"scale": 1.0}  # chip_smoke.py phases 9-10's
STATUS = {
    f"status_{which}_{strategy}": (_status(which, strategy), {})
    for strategy in ("direct", "indirect", "bell") for which in ("infeasible", "unbounded")
}
ZL = {
    "dense_direct_1e-4": (_dense("direct", 1e-4), {}),
    "dense_indirect_1e-4": (_dense("indirect", 1e-4), {}),
    "flagship": (_flagship, {}),
    "bell": (_bell, {}),
    "bell_batch": (_bell_batch, {}),
    "hi_acc_1e-4": (_hi_acc(1e-4), {}),
}
# name: (make, the settings every solve of it adds)
WORKLOADS = {
    **STATUS,
    **{f"{k}_eps_infeas_1e-5": (make, LOOSE) for k, (make, _) in STATUS.items()},
    **ZL,
    **{f"{k}_eps_infeas_1e-5": (make, LOOSE) for k, (make, _) in ZL.items()},
    "dense_direct_1e-6": (_dense("direct", 1e-6), {}),
    "dense_indirect_1e-6": (_dense("indirect", 1e-6), {}),
    "hi_acc_1e-6": (_hi_acc(1e-6), {}),
    "mixed_cone": (_mixed_cone, MIXED),
    "mixed_wide": (_mixed_wide, MIXED),
    "dopt": (_dopt, {}),
    "spectral": (_spectral, {}),
}


def _order(rounds):
    """The dtypes in turns: f32 f64 | f64 f32 | f32 f64 ..."""
    return [(r, d) for r in range(rounds) for d in (DTYPES if r % 2 == 0 else DTYPES[::-1])]


def measure(name, make, extra, rounds, small, device, pool, card):
    """Every run of one workload, in turns; one line a run."""
    t0 = time.perf_counter()
    run, config = make(small, device, pool, extra)
    config = dict(config, **extra)
    prep = time.perf_counter() - t0
    runs = []
    for r, dtype in _order(rounds):
        res, setup, solve, peak, kkt = run(dtype)
        statuses, it_mean, it_max = _summary(res)
        del res
        rec = dict(round=r, dtype=dtype, statuses=statuses, iter_mean=it_mean, iter_max=it_max,
                   setup_s=setup, solve_s=solve, peak_gb=peak, kkt=kkt)
        runs.append(rec)
        print(f"{name} round {r} {dtype} on {card}: {statuses}, iterations mean {it_mean:.1f} max "
              f"{it_max}, setup {setup:.3f} s, solve {solve:.3f} s, peak "
              f"{'n/a' if peak is None else f'{peak:.2f} GB'}, "
              f"{'certificate' if name.startswith('status') else 'worst KKT/limit'} "
              f"{'n/a' if kkt is None else f'{kkt:.3e}'}", flush=True)
    return dict(workload=name, config=config, prep_s=prep, runs=runs, summary=summarize(runs))


def summarize(runs):
    """Per dtype: the statuses of every round, the median / min / max of
    setup + solve seconds, the largest peak and KKT."""
    out = {}
    for dtype in DTYPES:
        mine = [r for r in runs if r["dtype"] == dtype]
        total = [r["setup_s"] + r["solve_s"] for r in mine]
        kkts = [r["kkt"] for r in mine if r["kkt"] is not None]
        peaks = [r["peak_gb"] for r in mine if r["peak_gb"] is not None]
        out[dtype] = dict(
            statuses=[r["statuses"] for r in mine],
            iter_mean=[r["iter_mean"] for r in mine], iter_max=[r["iter_max"] for r in mine],
            solve_s=[r["solve_s"] for r in mine], setup_s=[r["setup_s"] for r in mine],
            total_median_s=statistics.median(total), total_min_s=min(total),
            total_max_s=max(total), peak_gb=max(peaks) if peaks else None,
            kkt=max(kkts) if kkts else None,
        )
    return out


def main(argv=None):
    import argparse  # noqa: PLC0415
    import multiprocessing  # noqa: PLC0415
    from concurrent.futures import ProcessPoolExecutor  # noqa: PLC0415

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated workload names")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="rehearsal sizes (CPU)")
    ap.add_argument("--workers", type=int, default=8, help="generation processes")
    args = ap.parse_args(argv)
    names = [w for w in args.only.split(",") if w] or list(WORKLOADS)
    unknown = set(names) - set(WORKLOADS)
    if unknown:
        ap.error(f"unknown workloads {sorted(unknown)}; known: {list(WORKLOADS)}")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("dtype_proto: PyTorch sees no CUDA device (pass --device cpu to rehearse)")
        from ..ops import _kernels  # noqa: PLC0415
        from .gemv_proto import card as smi  # noqa: PLC0415

        card = smi()
        _kernels.build_all()
    else:
        card = "cpu (rehearsal: no device metric)"
    print(card, flush=True)
    out = dict(card=card, rounds=args.rounds, small=args.small, workloads=[])
    with ProcessPoolExecutor(args.workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        for name in names:
            out["workloads"].append(
                measure(name, *WORKLOADS[name], args.rounds, args.small, args.device, pool, card))
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(out, f, indent=1)
    for w in out["workloads"]:
        s = w["summary"]
        print(f"[summary] {w['workload']}: " + "; ".join(
            f"{d} {s[d]['statuses'][0]} total median {s[d]['total_median_s']:.3f} s "
            f"({s[d]['total_min_s']:.3f}-{s[d]['total_max_s']:.3f}), iterations "
            f"{s[d]['iter_mean'][0]:.1f}/{s[d]['iter_max'][0]}" for d in DTYPES))
    return out


if __name__ == "__main__":
    main()
