#!/usr/bin/env python
"""North-star benchmark: batched cone-QP throughput on one NVIDIA GPU —
the port of scs_tpu/bench_cli.py, run as

    python -m scs_tpu_torch.bench_cli          (or scs-tpu-torch-bench)

Workload (BASELINE.md / notebooks/scs_qp.ipynb cell 19 family): dense
random QP, n=1000 variables, m=1500 nonnegative-cone rows, solved to the
reference's DEFAULT operating point eps_abs=eps_rel=1e-4 (BASELINE.json:
"solution-gap parity (eps 1e-4)"), float32, as ONE batch of B=512
independent instances (env BENCH_BATCH overrides).

Honest baseline (every factor stated; all favorable to the reference):
  * measured anchor: 13.1 s/solve for this exact problem family —
    SCS v3 direct/QDLDL at eps=1e-6 (225 iters), single process
    (BASELINE.md, scs_qp.ipynb cell 19). The reference publishes no
    eps=1e-4 timing, so we extrapolate by iteration count, crediting the
    reference with terminating at 100/225 iterations for eps=1e-4
    (generous: DR tails are sublinear, so the true fraction is higher):
        t_ref(1e-4) ~= 13.1 * 100/225 = 5.82 s/problem.
  * multicore: the north star compares against *multicore SCS-MKL*
    (BASELINE.md targets). We credit an 8x aggregate speedup from
    Pardiso/BLAS threading (above typical measured MKL scaling on one
    socket for this size):
        baseline ~= 8 / 5.82 = 1.374 problems/s aggregate.
  * vs_baseline = (our problems/s) / 1.374, at MATCHED eps=1e-4.

Also reported (stderr + JSON extras): per-phase timing (lin_sys/cone/
accel, the reference's scsobject.h:1088-1092 breakdown), setup time, and
achieved memory bandwidth against the H100 SXM's data-sheet peak (the
batched DR iteration is matvec-dominated, i.e. bandwidth-bound).

BENCH_BELL=1 switches to the sparse block-ELL workload: one large sparse LP
(n >= 20k, density <= 1%) solved with solver_strategy="bell" (the CUDA
block-ELL SpMV), cross-checked against the direct strategy on a smaller
instance. See bench_bell() below.

BENCH_DEVICE (default "cuda") is the device of every solver and generator
("cpu" runs the bench without a card). BENCH_COMPILE_CACHE is accepted and
ignored: nothing is compiled ahead of a solve. The bench writes no file.

Prints exactly one JSON line on stdout, its summary on stderr:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from .tools.flagship import gen_batch

# Baseline derivation — see module docstring. All three factors explicit.
REF_ANCHOR_EPS6_SECS = 13.1  # measured: BASELINE.md, scs_qp.ipynb cell 19
REF_ITER_FRACTION_EPS4 = 100.0 / 225.0  # credited eps=1e-4 / eps=1e-6 iters
REF_MULTICORE_FACTOR = 8.0  # credited MKL/Pardiso multicore speedup
REF_PPS = REF_MULTICORE_FACTOR / (REF_ANCHOR_EPS6_SECS * REF_ITER_FRACTION_EPS4)

H100_PEAK_HBM_GBPS = 3350.0  # H100 SXM memory bandwidth (NVIDIA data sheet)


def _device():
    """The device every solver and generator of the bench runs on."""
    return torch.device(os.environ.get("BENCH_DEVICE", "cuda"))


def _memory_bytes(dev):
    """The device's memory: the card's total, or the host's physical memory
    when the bench runs on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def gen_batch_device(B, m, n, seed=1234, device=None):
    """Same construction as gen_batch, but on the device, from a seeded
    torch.Generator: at B=512 the host path costs minutes of numpy time,
    none of which is part of the benchmarked solve. These are not
    jax.random's numbers (nor gen_batch's): the same recipe, other draws.
    Returns float32 tensors (A, P, b, c) on `device` (default BENCH_DEVICE);
    b and c are computed in float32 from the stored A and P."""
    from .solver import _no_tf32  # noqa: PLC0415

    dev = torch.device(device) if device is not None else _device()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    k = max(n // 8, 1)
    with _no_tf32():
        A = normal(B, m, n) * float(1.0 / np.sqrt(m))
        G = normal(B, n, k)
        P = (0.1 / k) * (G @ G.mT)
        del G
        P.diagonal(dim1=1, dim2=2).add_(1e-4)
        z = normal(B, m)
        y = z.clamp_min(0.0)
        s = y - z
        x = normal(B, n)
        c = -(A.mT @ y[:, :, None])[:, :, 0] - (P @ x[:, :, None])[:, :, 0]
        b = (A @ x[:, :, None])[:, :, 0] + s
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return A, P, b, c


def _bench_extra_settings():
    """BENCH_* env overrides, applied identically to EVERY BatchedSCS the
    bench constructs (cold, steady-state, and amortized passes measure
    the same configuration)."""
    extra = {}
    if os.environ.get("BENCH_COMPACT_INTERVAL"):
        extra["batch_compact_interval"] = int(
            os.environ["BENCH_COMPACT_INTERVAL"]
        )
    if os.environ.get("BENCH_CHECK_INTERVAL"):
        extra["check_interval"] = int(os.environ["BENCH_CHECK_INTERVAL"])
    if os.environ.get("BENCH_AA_LOOKBACK"):
        extra["acceleration_lookback"] = int(os.environ["BENCH_AA_LOOKBACK"])
    if os.environ.get("BENCH_AA_INTERVAL"):
        extra["acceleration_interval"] = int(os.environ["BENCH_AA_INTERVAL"])
    if os.environ.get("BENCH_SCALE"):
        extra["scale"] = float(os.environ["BENCH_SCALE"])
    return extra


def _is_oom(exc) -> bool:
    return isinstance(exc, torch.cuda.OutOfMemoryError) or "out of memory" in str(exc)


def gen_bell_lp(m, n, density, bs=128, width=6, seed=7):
    """Block-structured sparse LP (network/assignment style) for the bell
    strategy: each bs-row block touches `width` random bs-column tiles —
    the regime where the block-ELL pack is ~width/nbc of dense."""
    from scipy import sparse as sp  # noqa: PLC0415

    rng = np.random.RandomState(seed)
    nbr, nbc = -(-m // bs), -(-n // bs)
    tile_density = min(1.0, density * nbc / width)
    per_tile = max(1, int(tile_density * bs * bs))
    rows_l, cols_l = [], []
    for r in range(nbr):
        tiles = rng.choice(nbc, min(width, nbc), replace=False)
        rr = rng.randint(0, bs, size=per_tile * len(tiles))
        cc = rng.randint(0, bs, size=per_tile * len(tiles))
        tb = np.repeat(tiles, per_tile)
        rows_l.append(r * bs + rr)
        cols_l.append(tb * bs + cc)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keep = (rows < m) & (cols < n)  # ragged edge tiles
    rows, cols = rows[keep], cols[keep]
    vals = rng.randn(len(rows))
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    A = A + sp.eye(m, n, format="csc")  # full row rank
    x0 = rng.randn(n)
    s = np.abs(rng.randn(m))
    b = A @ x0 + s
    y = np.abs(rng.randn(m))
    c = -(A.T @ y)
    return {"A": sp.csc_matrix(A), "b": b, "c": c}


def gen_bell_batch(B, m, n, density, width=6, seed=11):
    """B sparse LPs sharing gen_bell_lp's block pattern, with per-problem
    values, b and c (the generator of the `bell_batch` cell)."""
    from scipy import sparse as sp  # noqa: PLC0415

    rng = np.random.RandomState(seed)
    pat = gen_bell_lp(m, n, density, width=width, seed=seed)["A"]
    As, bs_, cs = [], [], []
    for _ in range(B):
        Ai = pat.copy()
        Ai.data = rng.randn(Ai.nnz)
        Ai = (Ai + sp.eye(m, n, format="csc")).tocsc()
        x0 = rng.randn(n)
        s = np.abs(rng.randn(m))
        y = np.abs(rng.randn(m))
        As.append(Ai)
        bs_.append(Ai @ x0 + s)
        cs.append(-(Ai.T @ y))
    return {"A": As, "b": np.stack(bs_), "c": np.stack(cs)}


def _bell_submetric(m=30000, n=20000, density=0.002, eps=1e-4):
    """One large block-sparse LP under the bell strategy in f32, with a
    per-iteration-cost baseline derived from the reference's measured
    indirect-CG anchor."""
    from .api import SCS  # noqa: PLC0415

    data = gen_bell_lp(m, n, density)
    nnz = data["A"].nnz
    t0 = time.perf_counter()
    solver = SCS(
        data, {"l": m}, solver_strategy="bell", dtype="float32", eps_abs=eps, eps_rel=eps,
        verbose=False, max_iters=50000, device=_device(),
    )
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = solver.solve(warm_start=False)
    elapsed = time.perf_counter() - t0
    it = max(sol["info"]["iter"], 1)
    # Baseline: the reference's measured indirect-CG run (scs_qp.ipynb
    # cell 20) costs 19.1 s / 250 iters = 76.4 ms per DR iteration at
    # 3.0e6 effective nnz. Per-iteration cost scales with nnz for a
    # matvec-bound method; credit the reference the SAME iteration count
    # we measured (iteration counts are an algorithm property, and ours
    # is AA-accelerated like the reference's).
    ref_secs = (19.1 / 250.0) * (nnz / 3.0e6) * it
    return {
        "metric": f"bell_lp_n{n}_m{m}_d{density:g}_eps{eps:g}",
        "status": sol["info"]["status"],
        "iters": int(it),
        "solve_secs": round(elapsed, 3),
        "setup_secs": round(setup, 3),
        "nnz": int(nnz),
        "vs_baseline": round(ref_secs / elapsed, 2),
        "baseline_derivation": (
            "76.4 ms/iter reference indirect-CG anchor (19.1s/250 iters, "
            f"scs_qp.ipynb cell 20, 3.0e6 nnz) x nnz ratio {nnz / 3.0e6:.2f}"
            f" x measured {it} iters"
        ),
    }


def _hi_acc_submetric(B=32, m=1500, n=1000):
    """High accuracy in f32 on the device.

    PRIMARY path (the headline number): solve at the reference's default
    eps=1e-4, then active-set polish — one masked-KKT solve + compensated
    f32 refinement per problem (polish.py). Each polished point is
    verified (multiplier/slack sign conditions + exact original-unit
    compensated residuals); acceptance is part of the metric.

    The iterative path (the f32 DR iterated to eps=1e-6, the compensated
    high-accuracy mode on every iteration) is kept behind
    BENCH_HIACC_ITERATIVE=1: each f32 DR update quantizes the iterate to
    ~eps_f32 * ||u|| per component, so the residual performs a rounding
    random walk below ~1e-5 relative and needs thousands of iterations to
    average its way to 1e-6; polishing sidesteps that floor.

    Problems are feasible by construction with KNOWN f64 optima, so the
    objective check is against f64 ground truth.
    """
    from .batch import BatchedSCS, solve_batch  # noqa: PLC0415

    dev = _device()
    A, P, b, c, p_star = gen_batch(
        B, m, n, seed=4321, dtype=np.float64, return_opt=True
    )

    t0 = time.perf_counter()  # generation excluded, like the main bench
    sp = BatchedSCS(
        {"A": A.astype(np.float32), "P": P.astype(np.float32),
         "b": b, "c": c},
        {"l": m}, dtype="float32", eps_abs=1e-4, eps_rel=1e-4,
        max_iters=20000, verbose=False,
        # scs_tpu's setting (its flagship's compiled segment length): kept,
        # so that the two packages run the same segments
        batch_compact_interval=8, device=dev,
    )
    res = sp.solve()
    res, pmask = sp.polish(res)
    elapsed = time.perf_counter() - t0
    pm = np.asarray(pmask)
    objs = np.array([r["info"]["pobj"] for r in res])
    rel = np.abs(objs - p_star) / (1 + np.abs(p_star))
    iters = np.array([r["info"]["iter"] for r in res])
    rp_max = max(r["info"]["res_pri"] for r in res)
    rd_max = max(r["info"]["res_dual"] for r in res)
    out = {
        "metric": f"qp_n{n}_m{m}_b{B}_f32_hi_accuracy_polish",
        "status": "solved" if pm.sum() == B else "partial",
        "n_certified": int(pm.sum()),
        "batch": B,
        "secs": round(elapsed, 3),
        "mean_iters": round(float(iters.mean()), 1),
        "max_obj_rel_err_vs_f64": float(rel[pm].max()) if pm.any() else None,
        "obj_sig_digits": int(-np.log10(max(float(rel[pm].max()), 1e-300)))
        if pm.any()
        else None,
        "max_res_pri": float(rp_max),
        "max_res_dual": float(rd_max),
        "f32_floor_note": (
            "iterative f32 DR floors at ~1e-6 rel; measured cause is "
            "PER-STEP f32 solve/matvec noise, not iterate accumulation "
            "— double-word iterate storage changes nothing "
            "(tools/df32_iterates_probe.py: rp 7.77e-7 plain vs 7.76e-7 "
            "compensated); polish reaches ~1e-7 rel KKT in one solve"
        ),
    }
    # compat fields of the scs_tpu bench's earlier consumers of this block
    out["max_obj_err_vs_f64"] = float(np.abs(objs - p_star)[pm].max()) if pm.any() else None
    out["obj_decimals"] = (
        int(-np.log10(max(float(np.abs(objs - p_star)[pm].max()), 1e-300)))
        if pm.any()
        else None
    )
    out["n_solved"] = int(pm.sum())

    if os.environ.get("BENCH_HIACC_ITERATIVE") == "1":
        t0 = time.perf_counter()
        res_it = solve_batch(
            {"A": A.astype(np.float32), "P": P.astype(np.float32),
             "b": b, "c": c},
            {"l": m},
            dtype="float32", eps_abs=1e-6, eps_rel=1e-6,
            acceleration_lookback=5, max_iters=50000, verbose=False,
            device=dev,
        )
        t_it = time.perf_counter() - t0
        objs_it = np.array([r["info"]["pobj"] for r in res_it])
        out["iterative_eps1e6"] = {
            "n_solved": sum(
                r["info"]["status"] == "solved" for r in res_it
            ),
            "mean_iters": round(
                float(np.mean([r["info"]["iter"] for r in res_it])), 1
            ),
            "secs": round(t_it, 3),
            "max_obj_rel_err_vs_f64": float(
                (np.abs(objs_it - p_star) / (1 + np.abs(p_star))).max()
            ),
        }
    return out


def _bell_batch_submetric(
    B=8, m=30720, n=20480, density=0.002, width=6, eps=1e-4
):
    """B SPARSE problems solved batched WITHOUT densifying: one shared block
    pattern, per-problem values, the batched block-ELL SpMV on the device.
    scs_tpu sized this cell so that the dense (B, m, n) batch could not
    exist on its device; `dense_vs_hbm` reports the dense batch against
    this device's memory."""
    from .batch import BatchedSCS  # noqa: PLC0415

    dev = _device()
    data = gen_bell_batch(B, m, n, density, width=width, seed=11)
    As = data["A"]
    dense_bytes = B * m * n * 4

    t0 = time.perf_counter()
    solver = BatchedSCS(
        data,
        {"l": m},
        solver_strategy="bell", dtype="float32",
        eps_abs=eps, eps_rel=eps, max_iters=20000, verbose=False,
        device=dev,
    )
    setup = time.perf_counter() - t0
    bell = solver.mats.bell
    pack_bytes = int(sum(
        t.numel() * t.element_size()
        for t in (bell.A_blocks, bell.At_blocks, bell.A_cols, bell.At_cols)
    ))
    t0 = time.perf_counter()
    res = solver.solve()
    elapsed = time.perf_counter() - t0
    n_solved = sum(r["info"]["status"] == "solved" for r in res)
    iters = np.array([r["info"]["iter"] for r in res])
    nnz = int(As[0].nnz)
    dense_vs_mem = dense_bytes / _memory_bytes(dev)
    return {
        "metric": f"bell_batch_b{B}_m{m}_n{n}_sparse_no_densify",
        "status": "solved" if n_solved == B else "partial",
        "n_solved": int(n_solved),
        "batch": B,
        "nnz_per_problem": nnz,
        "solve_secs": round(elapsed, 3),
        "setup_secs": round(setup, 3),
        "solve_pps": round(B / elapsed, 3),
        "mean_iters": round(float(iters.mean()), 1),
        "dense_batch_gb": round(dense_bytes / 1e9, 2),
        "pack_gb": round(pack_bytes / 1e9, 3),
        "dense_vs_hbm": round(dense_vs_mem, 2),
        "note": (
            f"the dense (B,m,n) batch would take {dense_vs_mem:.2f} of this "
            f"device's memory ({dev.type}); the block-ELL pack "
            f"({pack_bytes / 1e9:.3f} GB) is the only operator storage"
        ),
    }


def _mixed_cone_submetric(B=64, eps=1e-4, seed=3000):
    """The reference's flagship mixed-cone K solved on the device: z + l +
    SOC + PSD (incl. a 10-dim block) + exp + dual-exp + power/dual-power
    cones, B problems batched: batched eigh and the exp/power kernels.

    Problems are planted-optimum feasible instances from the independent
    test oracle (tests/oracle.py, the analogue of the reference's
    gen_random_cone_prob.py), with c normalized to unit length so the
    reference's 3-decimal objective check
    (test_solve_random_cone_prob.py:47-56, assert_almost_equal decimal=3)
    is meaningful at f32: scaling c by 1/||c|| scales (y, p*) linearly
    and leaves the cone geometry and optimal x unchanged.
    """
    from .batch import BatchedSCS  # noqa: PLC0415
    from .tools.mixed_cone import _oracle  # noqa: PLC0415

    oracle = _oracle()  # tests/oracle.py, kept outside the package

    K = {
        "z": 10,
        "l": 15,
        "q": [5, 10, 0, 1],
        "s": [3, 4, 0, 0, 1, 10],
        "ep": 10,
        "ed": 10,
        "p": [-0.25, 0.5, 0.75, -0.33],
    }
    m = oracle.cone_dims(K)
    n = m // 3
    rng = np.random.RandomState(seed)
    As, bs, cs, stars = [], [], [], []
    for _ in range(B):
        data, p_star, _sol = oracle.gen_feasible(K, n=n, density=0.1, rng=rng)
        k = np.linalg.norm(data["c"])
        As.append(np.asarray(data["A"].todense()))
        bs.append(data["b"])
        cs.append(data["c"] / k)
        stars.append(p_star / k)
    d = {"A": np.stack(As), "b": np.stack(bs), "c": np.stack(cs)}
    p_star = np.array(stars)

    t0 = time.perf_counter()
    solver = BatchedSCS(
        d, K, dtype="float32", eps_abs=eps, eps_rel=eps,
        max_iters=20000, verbose=False, scale=1.0, device=_device(),
    )
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve()
    elapsed = time.perf_counter() - t0
    n_solved = sum(r["info"]["status"] == "solved" for r in res)
    objs = np.array([r["info"]["pobj"] for r in res])
    err = np.abs(objs - p_star)
    iters = np.array([r["info"]["iter"] for r in res])
    # measured per-call phase split at the initial batch shape -> seconds
    # attribution over the mean iteration count (reference
    # scsobject.h:1088-1092 lin_sys/cone/accel timers)
    pt = solver.phase_times()
    it_mean = float(iters.mean())
    aa_trials = it_mean / max(solver.stg.acceleration_interval, 1)
    w_lin = pt["lin_sys"] * it_mean
    w_cone = pt["cone"] * it_mean
    w_accel = pt["accel_trial"] * aa_trials
    w_tot = max(w_lin + w_cone + w_accel, 1e-12)
    return {
        "metric": f"mixed_cone_K_b{B}_f32_eps{eps:g}",
        "cone": {k: v for k, v in K.items()},
        "status": "solved" if n_solved == B else "partial",
        "n_solved": int(n_solved),
        "batch": B,
        "m": int(m),
        "n": int(n),
        "solve_secs": round(elapsed, 3),
        "setup_secs": round(setup, 3),
        "mean_iters": round(it_mean, 1),
        "max_iters_seen": int(iters.max()),
        "max_obj_err_vs_planted": float(err.max()),
        "obj_3_decimal_parity": bool((err < 1.5e-3).all()),
        "cone_secs": round(elapsed * w_cone / w_tot, 3),
        "lin_sys_secs": round(elapsed * w_lin / w_tot, 3),
        "accel_secs": round(elapsed * w_accel / w_tot, 3),
        "cone_phase_frac": round(w_cone / w_tot, 3),
        "phase_note": (
            "fractions from per-call phase calibration "
            "(BatchedSCS.phase_times at the initial batch shape); the cone "
            "phase here does real work — batched eigh + exp/power Newton "
            "loops — unlike the flagship's clamp"
        ),
    }


def bench_batched_qp():
    from .batch import BatchedSCS, recommend_chunks  # noqa: PLC0415

    dev = _device()
    bench_t0 = time.perf_counter()
    # soft wall budget: sub-metrics are skipped (with a marker) once the
    # run exceeds this, so a caller's timeout can never kill the whole run
    # before the one-line JSON is printed
    budget = float(os.environ.get("BENCH_TIME_BUDGET", "1500"))

    def over_budget():
        return time.perf_counter() - bench_t0 > budget

    B = int(os.environ.get("BENCH_BATCH", "512"))
    m = int(os.environ.get("BENCH_M", "1500"))
    n = int(os.environ.get("BENCH_N", "1000"))
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    eps = float(os.environ.get("BENCH_EPS", "1e-4"))

    host_gen = os.environ.get("BENCH_HOST_GEN") == "1"
    gen_time = 0.0
    A = P = b = c = None
    if host_gen:
        t_gen0 = time.perf_counter()
        A, P, b, c = gen_batch(B, m, n, dtype=np.float32)
        gen_time = time.perf_counter() - t_gen0

    # memory-aware chunking: estimate the peak live bytes through setup
    # against the device's free memory (the host's, on the CPU) and split
    # the batch into however many sequential sub-batches fit.
    itemsize = 4 if dtype == "float32" else 8
    chunks_env = os.environ.get("BENCH_CHUNKS", "auto")
    if chunks_env == "auto":
        budget_bytes = None if dev.type == "cuda" else int(0.75 * _memory_bytes(dev))
        chunks = recommend_chunks(B, m, n, has_P=True, itemsize=itemsize, budget=budget_bytes)
    else:
        chunks = int(chunks_env)

    def build(dt, nchunks):
        nonlocal gen_time
        cb = -(-B // nchunks)
        solvers = []
        for i in range(nchunks):
            bsz = min(cb, B - i * cb)
            if host_gen:
                data = {
                    "A": A[i * cb : i * cb + bsz],
                    "P": P[i * cb : i * cb + bsz],
                    "b": b[i * cb : i * cb + bsz],
                    "c": c[i * cb : i * cb + bsz],
                }
            else:
                # per-chunk generation on the device: never materializes
                # the full batch alongside a chunk's setup transients
                t_g = time.perf_counter()
                Ai, Pi, bi, ci = gen_batch_device(bsz, m, n, seed=1234 + i, device=dev)
                gen_time += time.perf_counter() - t_g
                data = {"A": Ai, "P": Pi, "b": bi, "c": ci}
            extra = _bench_extra_settings()
            solvers.append(
                BatchedSCS(
                    data,
                    {"l": m},
                    dtype=dt,
                    eps_abs=eps,
                    eps_rel=eps,
                    max_iters=20000,
                    verbose=False,
                    device=dev,
                    **extra,
                )
            )
        return solvers

    def build_and_warm(dt, nchunks):
        """Build + first solve, retrying with more chunks on OOM."""
        while True:
            try:
                t0 = time.perf_counter()
                solvers = build(dt, nchunks)
                setup = time.perf_counter() - t0
                t0 = time.perf_counter()
                results = [r for s in solvers for r in s.solve()]
                first_secs = time.perf_counter() - t0
                return solvers, results, setup, first_secs, nchunks
            except Exception as exc:  # noqa: BLE001
                if not (_is_oom(exc) and nchunks < B):
                    raise
            print(
                f"# OOM at chunks={nchunks}; retrying with {nchunks * 2}",
                file=sys.stderr,
            )
            # free the failed attempt's tensors (out of the except block,
            # whose traceback holds them) before retrying
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            nchunks *= 2

    # --- cold pass: construction + first solve, first launches included --
    solvers, results, setup_time, first_secs, chunks = build_and_warm(
        dtype, chunks
    )
    n_solved = sum(r["info"]["status"] == "solved" for r in results)
    if n_solved < B and dtype == "float32":
        # accuracy fallback: float64, which the card and the CPU both run
        # (scs_tpu takes it on CPU-class backends only)
        dtype = "float64"
        itemsize = 8
        del solvers, results
        gc.collect()
        solvers, results, setup_time, first_secs, chunks = build_and_warm(
            dtype, max(chunks * 2, 4)
        )
        n_solved = sum(r["info"]["status"] == "solved" for r in results)
    # end-to-end cold: setup (equilibrate+factorize) + first solve; data
    # generation excluded
    e2e_cold_secs = setup_time + first_secs
    e2e_cold_pps = B / e2e_cold_secs

    setup_parts = {"host_gen": round(gen_time, 3)}
    for k in ("transfer", "equilibrate", "factorize", "compute_g"):
        setup_parts[k] = round(
            sum(s.setup_breakdown[k] for s in solvers), 3
        )

    # --- steady-state solve (cold-started states) -------------------------
    for s in solvers:
        s.reset()
    t0 = time.perf_counter()
    results = [r for s in solvers for r in s.solve()]
    elapsed = time.perf_counter() - t0
    solve_pps = B / elapsed
    iters = np.array([r["info"]["iter"] for r in results])
    n_solved2 = sum(r["info"]["status"] == "solved" for r in results)

    # per-phase breakdown by the memory-traffic model: the loop is
    # bandwidth-bound, so phase seconds are proportional to bytes moved per
    # iteration — lin_sys streams A twice plus S^-1 and P once (2mn +
    # 2n^2), the cone step is ~12 vector passes over (m+n+1), and the AA
    # trial re-runs both every interval iterations.
    max_it = int(iters.max())
    N_tot = m + n + 1
    interval = max(solvers[0].stg.acceleration_interval, 1)
    w_lin = 2.0 * m * n + 2.0 * n * n
    w_cone = 12.0 * N_tot
    w_accel = (w_lin + w_cone) / interval
    w_tot = w_lin + w_cone + w_accel
    lin_t = elapsed * w_lin / w_tot
    cone_t = elapsed * w_cone / w_tot
    accel_t = elapsed * w_accel / w_tot

    # bandwidth model: per device iteration each ACTIVE problem streams A
    # twice (A^T wy and A px), S^-1 once, P once.
    #   * productive view: only each problem's own iterations count
    #     (retired-in-lockstep work is waste) -> achieved_hbm_gbps;
    #   * device view: every (bucket x chunk) actually executed counts
    #     -> device_hbm_gbps. The ratio productive/device is the
    #     lockstep efficiency.
    bytes_per_prob_iter = itemsize * (2 * m * n + n * n + n * n)
    total_bytes = bytes_per_prob_iter * float(iters.sum())
    achieved_gbps = total_bytes / elapsed / 1e9
    hbm_util = achieved_gbps / H100_PEAK_HBM_GBPS
    device_iters = float(sum(s.device_prob_iters for s in solvers))
    device_gbps = bytes_per_prob_iter * device_iters / elapsed / 1e9
    lockstep_eff = float(iters.sum()) / max(device_iters, 1.0)

    # --- amortized pass: a SECOND batch of FRESH problems — construction
    # (equilibrate + factorize) plus solve: "solve many batches".
    del solvers, results
    gc.collect()
    cb = -(-B // chunks)
    amort_secs = 0.0
    amort_solved = 0
    amort_gen = 0.0
    for i in range(chunks):
        bsz = min(cb, B - i * cb)
        t_g = time.perf_counter()
        Ai, Pi, bi, ci = gen_batch_device(bsz, m, n, seed=5678 + i, device=dev)
        amort_gen += time.perf_counter() - t_g
        t0 = time.perf_counter()
        s = BatchedSCS(
            {"A": Ai, "P": Pi, "b": bi, "c": ci},
            {"l": m},
            dtype=dtype,
            eps_abs=eps,
            eps_rel=eps,
            max_iters=20000,
            verbose=False,
            device=dev,
            **_bench_extra_settings(),
        )
        rs = s.solve()
        amort_secs += time.perf_counter() - t0
        amort_solved += sum(r["info"]["status"] == "solved" for r in rs)
        del s, rs, Ai, Pi, bi, ci
        gc.collect()
    amortized_pps = B / amort_secs

    # --- bell sub-benchmark on the same device (skippable) ----------------
    bell = None
    if os.environ.get("BENCH_SKIP_BELL") == "1":
        pass
    elif over_budget():
        bell = {"status": "skipped: over BENCH_TIME_BUDGET"}
    else:
        try:
            bell = _bell_submetric(eps=eps)
        except Exception as exc:  # noqa: BLE001
            bell = {"status": f"error: {exc}"}

    # --- mixed-cone K (skippable) -----------------------------------------
    mixed_cone = None
    if os.environ.get("BENCH_SKIP_MIXED") == "1":
        pass
    elif over_budget():
        mixed_cone = {"status": "skipped: over BENCH_TIME_BUDGET"}
    else:
        try:
            mixed_cone = _mixed_cone_submetric()
        except Exception as exc:  # noqa: BLE001
            mixed_cone = {"status": f"error: {exc}"}

    # --- high-accuracy sub-benchmark (skippable) --------------------------
    hi_acc = None
    if os.environ.get("BENCH_SKIP_HIACC") == "1":
        pass
    elif over_budget():
        hi_acc = {"status": "skipped: over BENCH_TIME_BUDGET"}
    else:
        try:
            hi_acc = _hi_acc_submetric()
        except Exception as exc:  # noqa: BLE001
            hi_acc = {"status": f"error: {exc}"}

    # --- batched sparse (no densify) (skippable) --------------------------
    bell_batch = None
    if os.environ.get("BENCH_SKIP_BELLBATCH") == "1":
        pass
    elif over_budget():
        bell_batch = {"status": "skipped: over BENCH_TIME_BUDGET"}
    else:
        try:
            bell_batch = _bell_batch_submetric()
        except Exception as exc:  # noqa: BLE001
            bell_batch = {"status": f"error: {exc}"}

    out = {
        "metric": f"qp_n{n}_m{m}_b{B}_{dtype}_eps{eps:g}_amortized_throughput",
        "value": round(amortized_pps, 3),
        "unit": "problems/sec",
        "vs_baseline": round(amortized_pps / REF_PPS, 1),
        "baseline_pps": round(REF_PPS, 3),
        "baseline_derivation": (
            f"{REF_ANCHOR_EPS6_SECS}s/problem measured at eps=1e-6 "
            f"(scs_qp.ipynb cell 19) x {REF_ITER_FRACTION_EPS4:.3f} credited "
            f"iteration fraction for eps=1e-4 x {REF_MULTICORE_FACTOR:.0f}x "
            "credited MKL multicore speedup"
        ),
        "matched_eps": eps,
        # amortized pass: fresh problems, setup math INCLUDED (generation
        # excluded: amort_gen_secs)
        "amortized_pps": round(amortized_pps, 3),
        "amortized_secs": round(amort_secs, 3),
        "amortized_n_solved": amort_solved,
        "amort_gen_secs": round(amort_gen, 3),
        # cold end-to-end: first launches included
        "e2e_cold_pps": round(e2e_cold_pps, 3),
        "e2e_cold_secs": round(e2e_cold_secs, 3),
        "first_solve_secs": round(first_secs, 3),
        # steady-state solve-phase only
        "solve_pps": round(solve_pps, 3),
        "solve_secs": round(elapsed, 3),
        "n_solved": n_solved2,
        "batch": B,
        "chunks": chunks,
        "mean_iters": round(float(iters.mean()), 1),
        "max_iters_seen": max_it,
        "setup_secs": round(setup_time, 3),
        "setup_breakdown": setup_parts,
        "lin_sys_secs": round(lin_t, 3),
        "cone_secs": round(cone_t, 3),
        "accel_secs": round(accel_t, 3),
        "achieved_hbm_gbps": round(achieved_gbps, 1),
        "hbm_utilization": round(hbm_util, 3),
        "device_hbm_gbps": round(device_gbps, 1),
        "device_hbm_utilization": round(device_gbps / H100_PEAK_HBM_GBPS, 3),
        "lockstep_efficiency": round(lockstep_eff, 3),
        "bell": bell,
        "hi_acc": hi_acc,
        "mixed_cone": mixed_cone,
        "bell_batch": bell_batch,
    }
    print(json.dumps(out), flush=True)
    print(
        f"# solved {n_solved2}/{B} ({chunks} chunk(s)), mean iters "
        f"{iters.mean():.0f} (max {max_it}), dtype {dtype}, device {dev}\n"
        f"# amortized {amortized_pps:.1f} pps (2nd batch incl. setup math), "
        f"solve-only {solve_pps:.1f} pps, cold e2e {e2e_cold_pps:.2f} pps "
        f"(setup {setup_time:.1f}s + first solve {first_secs:.1f}s)\n"
        f"# phases: lin_sys {lin_t:.2f}s, cone {cone_t:.2f}s, accel "
        f"{accel_t:.2f}s; memory {achieved_gbps:.0f} GB/s productive "
        f"({100 * hbm_util:.0f}% of the H100 SXM's {H100_PEAK_HBM_GBPS:.0f} "
        f"GB/s), {device_gbps:.0f} GB/s device, lockstep eff "
        f"{100 * lockstep_eff:.0f}%"
        + (
            f"\n# bell: {bell['status']} {bell.get('iters', '?')} iters "
            f"{bell.get('solve_secs', '?')}s solve, vs_baseline "
            f"{bell.get('vs_baseline', '?')}"
            if bell
            else ""
        )
        + (
            f"\n# hi-acc f32 polish: {hi_acc['status']} "
            f"{hi_acc.get('n_certified', '?')}/{hi_acc.get('batch', '?')} "
            f"certified in {hi_acc.get('secs', '?')}s, "
            f"{hi_acc.get('mean_iters', '?')} mean iters, obj vs f64 to "
            f"{hi_acc.get('obj_sig_digits', '?')} sig digits"
            if hi_acc
            else ""
        )
        + (
            f"\n# mixed-cone K (SOC+PSD+exp+pow): {mixed_cone['status']} "
            f"{mixed_cone.get('n_solved', '?')}/{mixed_cone.get('batch', '?')}"
            f", {mixed_cone.get('solve_secs', '?')}s solve, cone phase "
            f"{mixed_cone.get('cone_secs', '?')}s "
            f"({mixed_cone.get('cone_phase_frac', '?')}), 3-decimal parity "
            f"{mixed_cone.get('obj_3_decimal_parity', '?')}"
            if mixed_cone
            else ""
        )
        + (
            f"\n# bell-batch (sparse, no densify): {bell_batch['status']} "
            f"{bell_batch.get('n_solved', '?')}/{bell_batch.get('batch', '?')}"
            f", {bell_batch.get('solve_secs', '?')}s solve "
            f"({bell_batch.get('solve_pps', '?')} pps); dense form "
            f"{bell_batch.get('dense_batch_gb', '?')} GB vs "
            f"{bell_batch.get('pack_gb', '?')} GB packed"
            if bell_batch
            else ""
        ),
        file=sys.stderr,
    )


def bench_bell():
    """Sparse path: one large sparse LP via solver_strategy='bell' (the
    block-ELL SpMV kernel), agreement-checked against the direct strategy
    on a smaller instance."""
    from .api import solve  # noqa: PLC0415

    n = int(os.environ.get("BENCH_N", "20000"))
    m = int(os.environ.get("BENCH_M", "30000"))
    density = float(os.environ.get("BENCH_DENSITY", "0.002"))
    eps = float(os.environ.get("BENCH_EPS", "1e-4"))
    dev = _device()

    # agreement check on a small instance: bell vs direct at eps=1e-5; the
    # solve itself runs at the reference's default eps=1e-4
    small = gen_bell_lp(600, 400, 0.01, seed=7)
    sol_bell = solve(
        small, {"l": 600}, solver_strategy="bell", bell_block_size=128,
        eps_abs=1e-5, eps_rel=1e-5, verbose=False, max_iters=30000, device=dev,
    )
    sol_dir = solve(
        small, {"l": 600}, solver_strategy="direct",
        eps_abs=1e-5, eps_rel=1e-5, verbose=False, max_iters=30000, device=dev,
    )
    assert sol_bell["info"]["status"] == "solved", sol_bell["info"]["status"]
    obj_gap = abs(sol_bell["info"]["pobj"] - sol_dir["info"]["pobj"]) / (
        1 + abs(sol_dir["info"]["pobj"])
    )
    assert obj_gap < 1e-3, f"bell/direct objective gap {obj_gap}"

    # large instance, timed
    out = _bell_submetric(m=m, n=n, density=density, eps=eps)
    out["value"] = out["solve_secs"]
    out["unit"] = "seconds"
    out["cross_check_obj_gap"] = float(obj_gap)
    print(json.dumps(out), flush=True)
    print(
        f"# bell: {out['status']} in {out['iters']} iters, "
        f"{out['solve_secs']:.2f}s solve (setup {out['setup_secs']:.2f}s), "
        f"vs_baseline {out['vs_baseline']}",
        file=sys.stderr,
    )


def main():
    if os.environ.get("BENCH_BELL") == "1":
        bench_bell()
    else:
        bench_batched_qp()


if __name__ == "__main__":
    main()
