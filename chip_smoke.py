#!/usr/bin/env python3
"""On-card smoke run of scs_tpu_torch, the PyTorch/CUDA port of scs_tpu.

Run from the repository root on a machine with one NVIDIA GPU (written
for the H100, sm_90a):

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:

  1. the card: nvidia-smi's name and power limit, PyTorch's view, TF32 flags;
  2. build the CUDA kernels from the sources in this checkout (one nvcc
     per source, started together);
  3. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes and a few others, f32 and f64, with CUDA-event times
     beside the bound: the block-ELL SpMV (single and batched; x at its true
     length, unpadded, as the solvers pass it; a repeated launch and a
     launch on the padded x must be bit-equal) and the batched dense GEMVs
     gemv_rows / gemv_cols at every shape the main paths launch them (the
     flagship's, the mixed-cone batches', the single dense QP's; M also one
     element into its buffer, which must give the aligned copy's bits) and
     ragged shapes, one launch per call, a bit-equal repeat, the load width
     and row shifts per shape; device times from CUDA-graph replays beside
     the bound and torch.bmm's (TF32 off), host time per call of each;
     D1, the compensated products of ops/df32.py (gemv_rows_comp /
     gemv_cols_comp), at the shapes the high-accuracy paths launch it, on
     ragged widths, on M one element into its buffer and on rows whose
     products cancel: within 5e-7 of the float64 product per problem, a
     bit-equal repeat, the aligned copy's bits, device ms from graph replays
     beside the bound and beside G1/G2 at the same shape;
     the three cone-projection kernels proj_exp / proj_pow / proj_box
     (rows drawn to hit every regime, at the mixed-cone batches' shapes and
     at 10^6 cones; the box at (1, 1001) and (512, 1001) under shared and
     per-row bounds with infinities; agreement to a stated tolerance, a
     bit-equal repeat, and the geometry of the answer in f64 on the host: p
     in K, p - v in K*, <p, p - v> = 0; the Newton steps and the rows that
     left on a cycle; the same checks run after phase 10 on the rows phases
     9 and 10 handed the three kernels early, in the middle and late in
     their solves); the spectral-cone kernels C4 proj_logdet_vec and C5
     proj_sl_vec (csrc/spectral_proj.cu: the logdet and sum-of-k-largest
     cones' vector parts after eigh, a cluster of two blocks a cone, its
     bisections multisected across warps and lane groups), f32 and f64, on rows in
     every regime (inside, polar, on the v = 0 facet, active, v0 <= 0,
     negative eigenvalues, ties, unsorted), at n = 1, 2, 31, 32, 33 (k = 1
     and n - 1), at each capacity of the kernels' layouts and one past it
     (8, 16, 32, 64, 128, 256 eigenvalues; past 256 the memory path), at
     row counts the launch does not tile, and at the shapes phase 15 hands
     them: the stated tolerance, a bit-equal repeat, the f64 geometry
     against the oracle's projection, the kernel's serial passes a row and
     the plain map's, device ms from graph replays beside the plain
     version, the roofline bound of the plain algorithm's work and the
     kernel's serial floor (the same checks run after phase 15 on the rows
     its solves handed C4 and C5); and every projection left as plain tensor code on the card
     against the CPU in f64, with the library's batched eigh timed per
     shape;
  4. the main path: SCS(...).solve() under solver_strategy="bell" on the
     30000 x 20000 block-sparse LP of the scs_tpu bench's `bell` cell, f32,
     eps 1e-4, on "cuda"; the kernels' launch counts are zeroed just before
     and read just after; KKT residuals are re-checked in f64 on the host;
  5. a QP with a sparse PSD P in f64, on the card and on the CPU: same
     status, iteration counts within one check_interval, pobj to 1e-6;
  6. the batched path: BatchedSCS(...).solve() on the scs_tpu bench's
     `bell_batch` cell, 8 sparse LPs of 30720 x 20480, f32, eps 1e-4, on
     "cuda"; all 8 must solve with host f64 KKT residuals within 5x the
     solver's criterion, the batched kernel must carry every product
     (launch counts zeroed just before, read just after), and problem 0
     solved alone through SCS must agree;
  7. a dense QP through SCS under "direct" and "indirect" in f64, on the
     card and on the CPU: same status, pobj to 10 eps, host KKT; then one
     1500 x 1000 QP of the bench's generator in f32 at eps 1e-6 under
     "direct", which is the high-accuracy mode (compensated residuals and
     refinement through D1): solved, pobj within 1e-5 of the planted optimum
     (relative to 1 + |p*|), f64 KKT within 2e-6 of the data's scale;
  8. the dense main path: BatchedSCS(...).solve() on the scs_tpu bench's
     flagship, 512 dense 1500 x 1000 QPs over the nonnegative cone, f32,
     eps 1e-4, generated on the card from a seed with a planted optimum;
     512/512 must solve with the objective within 1e-3 of the planted one
     (relative to the objective's largest term) and f64 KKT residuals within 5x the solver's criterion, every dense
     matvec must go through gemv_rows / gemv_cols and none through the SpMV
     kernels (launch counts zeroed just before, read just after; the GEMV
     launches also by shape); a torch.profiler window over two chunks (the
     GEMVs' share of busy time); then one full-batch iteration is timed
     under each direct_solver mode;
  9. the scs_tpu bench's `mixed_cone` cell at its full size: 64 problems
     over z + l + SOC + PSD + exp + dual exp + power cones from the numpy
     oracle's planted-optimum generator (tests/oracle.py), f32, eps 1e-4;
     64/64 must solve with every objective within 1.5e-3 of the planted
     one, host f64 residuals within 5x the solver's criterion, s in K and y
     in K* by the oracle's projections, the exp and power projections
     through their kernels and every dense matvec through gemv_rows /
     gemv_cols; then a torch.profiler window over two chunks;
 10. a mixed-cone batch the card notices: 128 problems of about 5300 x 1770
     over z + l + a box of 400 bounds + 20 SOCs of 50 + four 32 x 32 PSD
     blocks + 300 exponential and 100 power cones each (A 4.8 GB in f32;
     51,200 exp/power cones and 512 matrices per projection), generated in
     worker processes; the same gates; then a
     torch.profiler window over two chunks (kernels per iteration, busy and
     idle share, the shares of eigh, of the cone kernels, of the GEMVs).
     Phases 9 and 10 copy the rows their solves hand the exp, power and
     box kernels (phase 3's checks run on them after phase 10);
 11. the scs_tpu bench's `hi_acc` cell at its full size: 32 dense QPs of
     1500 x 1000 from its generator (scs_tpu/bench_cli.py:gen_batch, seed
     4321, planted optima p*), A and P in f32: (a) BatchedSCS at eps 1e-4,
     then polish: 32/32 certified, every polished point's f64 KKT on the raw
     data within 1e-5 of its scale and |pobj - p*| <= 1e-5 (1 + |p*|); (b)
     the bench's iterative path, f32 at eps 1e-6 (the high-accuracy mode, D1
     on every iteration): no status worse than solved_inaccurate, every
     solved problem within 1e-5 of p*; (c) the same batch in plain f64 at
     eps 1e-6, which the card has and the TPU has not: all solved, f64 KKT.
     D1's launches are zeroed just before each of (a) and (b) and read just
     after;
 12. the port's bench (scs_tpu_torch/bench_cli.py) at its defaults, in this
     process with its stdout captured: exactly one JSON line; the flagship
     512/512 solved in the first and the amortized pass, in float32 (the
     f64 accuracy fallback not taken); the bell, mixed_cone, hi_acc and
     bell_batch sub-metrics "solved", hi_acc 32/32 certified, mixed_cone's
     3-decimal objective parity; every kernel of the bench's path (K1, K3,
     G1, G2, C1, C2, D1; the counts zeroed just before and read just after)
     launched; then BENCH_BELL=1: solved, cross-check gap under 1e-3. The
     bench's headline numbers and wall time are printed;
 13. phase_timing="always" on the card: the instrumented loop on phase 7's
     dense QP (f64, "direct") and phase 5's bell QP, each solved with one
     CSV row per iteration (iter stepping by 1) and measured lin_sys / cone
     timers summing under solve_time, its seconds an iteration printed
     beside the pipelined loop's; a batched "always" solve of the mixed_cone
     cell with its timers filled and the iteration counts of "auto"; and
     the auto/instrumented ratio of the timers on
     tests/test_observability.py's 900 x 600 QP, gated as that test gates
     it: 0.8-1.25, or 0.7-1.43 on one retry;
 14. the sharded paths (scs_tpu_torch.parallel), each world spawned from
     this process with a time limit, so a deadlock fails the run: (a) the
     bell LP of phase 4 through ShardedSCS(solver_strategy="bell") at one
     NCCL rank and (b) at two gloo ranks on the one card (solved, host f64
     KKT, pobj within 1e-3 of phase 4's, x bit-equal on both ranks, K1
     carrying every product), then the hi_acc cell's first QP dense at two
     gloo ranks (G1/G2 on each rank's rows); (c) parallel/dryrun.py's four
     legs at one NCCL rank (D1 on leg 3). In every world, after its launch
     counts are read, each rank holds every kernel it launched, at every
     shape it launched it at, against the plain version on the same inputs
     (its own packs and rows of A where it has them), one rank at a time,
     timed beside the plain version and the bound;
 15. spectral-cone solves on the card, eps 1e-4: (a) D-optimal experiment
     design (Boyd & Vandenberghe 7.5), 64 problems of n = 32 parameters and
     p = 256 candidate vectors (787 x 257, one logdet cone of a 32 x 32
     matrix each) through BatchedSCS in f64 (in f32 neither scs_tpu nor the
     port reaches eps 1e-4 on most of them within 20,000 iterations): 64/64
     solved, f64 KKT within 5x, s in K and y in K* by the oracle (on every
     16th problem: ~20 s of the host a problem), |t -
     logdet X(lam)| <= DOPT_LOGDET_TOL (1 + |t|), the Kiefer-Wolfowitz gap
     <= DOPT_DELTA n; then its problem 0
     alone through SCS in f64, the same gates and pobj within 1e-3 of the
     batch's; (b) 64 planted-optimum problems of 840 x 280 over z + l + two
     sum-of-largest cones (32, k 4; 16, k 3) + a logdet cone (16), f32,
     generated in worker processes: phase 9's gates (cone membership on
     every 4th problem). The C4 / C5 / G1 / G2 launch
     counts are zeroed just before each solve and read just after (one
     launch a call of each spectral wrapper), a torch.profiler window over
     two chunks each, and phase 3's checks of C4 and C5 on the rows the two
     solves handed them early, in the middle and late (in the solve's
     type);
 16. the status surface, f32 on the card (the default path): an
     infeasible and an unbounded LP of STATUS_M x STATUS_N under "direct",
     "indirect" and "bell" (G1/G2, and K1/K2 under "bell", launched),
     each "infeasible" / "unbounded" with its certificate held in f64 on
     the host (infeasible: ||A'y|| small, b'y < 0 as the solver normalizes
     it to -1, y in K*; unbounded: ||Ax + s|| small, c'x < 0, s in K); a QP
     over z + l + SOCs solved, then update(b, c) and a warm re-solve:
     solved in fewer iterations than a cold solve of the updated data, with
     no factorization; a solve stopped by time_limit_secs, which returns
     "solved_inaccurate" with finite iterates; a BatchedSCS of 8 LPs, one
     of them infeasible, each status at its original position. One line:
     statuses, iterations and wall time, at most STATUS_WALL_S.

Then the whole run's wall time, one JSON line describing the kernels (each
with its launches on the main path and in phase 12's bench run), and last
the contract line
{"ok": true, "device": {...}}. With no CUDA device the script exits
nonzero before printing any result.

    python3 chip_smoke.py --bell-profile

runs phases 1 and 2 and then, instead of the rest, a torch.profiler window
over two chunks of the bell LP's solve (kernels per CG iteration, busy and
idle share of the device, kernels by device time) and one whole solve; it
prints no contract line.
"""

import contextlib
import csv
import io
import json
import os
import statistics
from collections import Counter
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from scipy import sparse

import scs_tpu_torch
from scs_tpu_torch import bench_cli
from scs_tpu_torch.bench_cli import gen_bell_batch, gen_bell_lp
from scs_tpu_torch.ops import _kernels, df32
from scs_tpu_torch.ops.dense import gemv_cols, gemv_rows
from scs_tpu_torch.ops.sparse import (
    bell_spmv,
    bell_spmv_batched,
    bell_spmv_batched_ref,
    bell_spmv_ref,
    pack_bell_host,
    pack_bell_sym_host,
    stack_bell_host,
)
from scs_tpu_torch.ops import projections as cone_ops
from scs_tpu_torch.parallel import dryrun
from scs_tpu_torch.parallel.comm import gather_list
from scs_tpu_torch.parallel.dryrun import spawn_world
from scs_tpu_torch.tools import gemv_proto, mixed_cone, timer_proto
from scs_tpu_torch.tools.flagship import (
    FLAGSHIP,
    gen_batch,
    gen_qp_batch,
    kkt_check_batch,
    profile_window,
)

# The scs_tpu bench's `bell` cell (scs_tpu/bench_cli.py:_bell_submetric).
BELL_M, BELL_N, BELL_DENSITY, BELL_BS, BELL_EPS = 30000, 20000, 0.002, 128, 1e-4
BELL_TPU_ITERS = 625  # BENCH_r05.json, TPU v5e, f32 — for reference only
QP_M, QP_N, QP_EPS = 3000, 2000, 1e-6
# The scs_tpu bench's `bell_batch` cell (scs_tpu/bench_cli.py:341-409).
BATCH_B, BATCH_M, BATCH_N, BATCH_DENSITY, BATCH_WIDTH = 8, 30720, 20480, 0.002, 6
BATCH_SEED, BATCH_EPS = 11, 1e-4
BATCH_TPU_MEAN_ITERS = 712.5  # BENCH_r05.json, TPU v5e, f32 — for reference only
# The scs_tpu bench's flagship (scs_tpu/bench_cli.py:512-586): B dense QPs.
FLAG_B, FLAG_M, FLAG_N = FLAGSHIP
FLAG_EPS, FLAG_SEED = 1e-4, 1234
FLAG_TPU_ITERS = (204, 600)  # mean, max: BENCH_r05.json, TPU v5e — reference only
DENSE_QP_M, DENSE_QP_N, DENSE_QP_EPS = 300, 200, 1e-6
# The scs_tpu bench's `hi_acc` cell (scs_tpu/bench_cli.py:235-338); its A
# width is also the single high-accuracy QP's of phase 7
HI_B, HI_M, HI_N, HI_SEED = 32, 1500, 1000, 4321
HI_TPU_MEAN_ITERS = 242.2  # BENCH_r05.json, TPU v5e, (a) — a count, not a target
# The scs_tpu bench's `mixed_cone` cell (scs_tpu/bench_cli.py:412-509) and the
# wide mixed-cone batch (scs_tpu_torch/tools/mixed_cone.py).
MIXED_TPU_ITERS = (351.6, 1200)  # mean, max: BENCH_r05.json, TPU v5e — reference only
MIXED_OBJ_TOL = 1.5e-3  # the bench's 3-decimal objective check
WIDE_SEED, WIDE_WORKERS = 4000, 8
CONE_KERNELS = (cone_ops._proj_exp_batch, cone_ops._proj_pow_batch, cone_ops._proj_box)
SPECTRAL_KERNELS = (cone_ops._proj_logdet_vec_batch, cone_ops._proj_sl_vec_batch)  # C4, C5
# Phase 15: the spectral-cone batches (scs_tpu_torch/tools/mixed_cone.py).
# DOPT_DELTA: the Kiefer-Wolfowitz gate, gap <= DOPT_DELTA * n, fixed
# before any run on the card from the port's CPU solves of the same
# generator at (n = 8, p = 64), f32, eps 1e-4: gap / n 6.5e-5 to 4.8e-4 over
# seeds 5150-5157 (PERF.md), with a tenfold margin. DOPT_LOGDET_TOL: |t -
# logdet X(lam)| over 1 + |t|. At eps 1e-4 the primal residual of the X
# rows moves logdet X(lam) by up to ~1e-2 of it: scs_tpu's own f64
# solutions of problems 0-3 read 2.9e-4 to 5.5e-3 (on the CPU), the port's
# up to 7.2e-3 over the 64 (PERF.md). The batch runs in f64: in f32
# neither scs_tpu nor the port reaches eps 1e-4 on most of these problems
# within 20,000 iterations (PERF.md)
DOPT_EPS, DOPT_DELTA, DOPT_LOGDET_TOL, DOPT_POBJ_TOL = 1e-4, 5e-3, 1e-2, 1e-3
DOPT_DTYPE, SPECTRAL_DTYPE = "float64", "float32"
# Cone membership by the oracle on every DOPT_CONE_EVERY-th problem of (a)
# and every SPECTRAL_CONE_EVERY-th of (b), the residuals on all of them: the
# oracle's SLSQP projections took 185 s of eight workers for all 64 of (a)
# (~20 s a problem at n = 32) and 38.7 s for (b)'s (PERF.md), past
# the script's time limit
DOPT_CONE_EVERY, SPECTRAL_CONE_EVERY = 16, 4
SPECTRAL_WORKERS = 8
# Phase 16: the status surface. The LPs' size (sparse, density
# STATUS_DENSITY, so that "bell" packs them); the QP's cone; the time limit
# and the eps it stops short of; the phase's wall budget on the card.
STATUS_M, STATUS_N, STATUS_DENSITY, STATUS_SEED = 1200, 800, 0.05, 1600
STATUS_QP_K = {"z": 40, "l": 600, "q": [10] * 20}
# the QP's solves check every STATUS_QP_CHECK iterations: at the default
# 25 a warm and a cold solve of ~50 iterations often end at the same check
STATUS_QP_N, STATUS_QP_CHECK, STATUS_LIMIT_S, STATUS_WALL_S = 500, 5, 0.5, 40.0
# The LPs' eps_infeas: in f32 the unbounded LP's certificate residual
# stalls at ~3e-6, in scs_tpu too (on the CPU), short of the default 1e-7.
# The certificate gates in f64 on the host, the certificate normalized as
# the solver returns it (b'y = -1, c'x = -1)
STATUS_EPS_INFEAS, STATUS_CERT_TOL = 1e-5, 1e-4
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the non-tensor-core rates of the kernels' element types
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# |y_kernel - y_plain| <= TOL * (|A| |x|) elementwise: the two sum in
# different orders, each within ~sqrt(width*bs) roundings of |A||x|
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def gen_bell_qp(m, n, density, seed=11):
    """gen_bell_lp's constraints plus a sparse PSD P = 0.1 B'B + 0.5 I
    (B with ~3 random entries per row) and a random c; P is passed as
    its upper triangle, as the API expects."""
    data = gen_bell_lp(m, n, density, seed=seed)
    rng = np.random.RandomState(seed + 1)
    B = sparse.random(n, n, density=3.0 / n, random_state=rng, format="csc")
    P = (0.1 * (B.T @ B) + 0.5 * sparse.eye(n)).tocsc()
    data["P"] = sparse.triu(P, format="csc")
    data["c"] = rng.randn(n)
    return data


def time_ms(fn, reps=20, inner=1):
    """Median over `reps` CUDA-event pairs of the time per call of `inner`
    calls in a row, after one warm-up call. For a kernel of tens of
    microseconds, several calls per pair keep the device's queue ahead of
    the host, so that the time is the device's and not the host's gap
    between an event and a launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


SPMV_INNER = 10  # launches per event pair when timing the SpMV (see time_ms)


def time_graph_ms(fn, reps=20, inner=SPMV_INNER):
    """Device time per call of fn: `inner` calls are captured into a CUDA
    graph and the graph's replays are timed with events (median of `reps`),
    so the host's cost of a call (tens of microseconds through a Python
    wrapper, more than a small kernel runs) is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, reps) / inner


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: PyTorch sees no CUDA device; this runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(
        f"[1] device: {name} (count {torch.cuda.device_count()}, capability "
        f"{torch.cuda.get_device_capability(0)}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}"
    )
    return name, smi


def bound_ms(n_bytes, n_flops, dtype):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type. Returns
    (ms, "bytes" or "operations")."""
    by, op = n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_FLOPS[dtype]
    return max(by, op) * 1e3, "bytes" if by >= op else "operations"


def phase_build():
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    for name in libs:
        _kernels.load(name)
    secs = time.perf_counter() - t0
    for name, so in libs.items():
        ptxas = " | ".join(
            ln.strip() for ln in _kernels.build_log.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln
        )
        print(f"[2] built {so}; ptxas: {ptxas or '(cached build)'}")
    print(f"[2] {len(libs)} kernel sources built in parallel in {secs:.2f} s")


def _check_case(label, blocks_np, cols_np, x_len, dtype, rng, timed=False):
    """Kernel vs plain version on the card for one pack, on x of its true
    length x_len (unpadded, as the main path passes it) and on the same x
    zero-padded to whole tiles; a repeated launch must be bit-equal.
    Returns (max_abs_err, kernel_ms, plain_ms)."""
    dev = torch.device("cuda")
    blocks = torch.as_tensor(blocks_np, dtype=dtype, device=dev)
    cols = torch.as_tensor(cols_np, device=dev)
    nbr, width, bs, _ = blocks_np.shape
    n_pad = max(int(cols_np.max()) + 1, -(-x_len // bs)) * bs
    x_pad = torch.zeros(n_pad, dtype=dtype, device=dev)
    x_pad[:x_len] = torch.as_tensor(rng.randn(x_len), dtype=dtype, device=dev)
    x = x_pad[:x_len]
    y_k = bell_spmv(blocks, cols, x)
    y_again = bell_spmv(blocks, cols, x)
    y_padded = bell_spmv(blocks, cols, x_pad)
    y_p = bell_spmv_ref(blocks, cols, x_pad)
    bound = TOL[dtype] * bell_spmv_ref(blocks.abs(), cols, x_pad.abs())
    torch.cuda.synchronize()
    err = (y_k - y_p).abs()
    if not bool(torch.all(err <= bound)):
        worst = float((err - bound).max())
        raise AssertionError(f"{label}: kernel disagrees with plain version (excess {worst:.3e})")
    if not torch.equal(y_k, y_again):
        raise AssertionError(f"{label} {dtype}: a repeated bell_spmv launch differs")
    if not torch.equal(y_k, y_padded):
        raise AssertionError(f"{label} {dtype}: unpadded and padded x give different results")
    k_ms = p_ms = None
    t = ""
    if timed:
        k_ms = time_graph_ms(lambda: bell_spmv(blocks, cols, x))
        p_ms = time_ms(lambda: bell_spmv_ref(blocks, cols, x_pad), inner=SPMV_INNER)
        b_ms = _spmv_bound(blocks_np.shape, x_len, dtype)[0]
        t = (f", kernel {k_ms:.4f} ms, bound {b_ms:.4f} ms ({100 * b_ms / k_ms:.0f}%), "
             f"plain {p_ms:.4f} ms")
    print(
        f"[3] {label} {str(dtype)[6:]}: pack ({nbr}, {width}, {bs}, {bs}), x {x_len} of {n_pad} "
        f"unpadded, max |err| {float(err.max()):.3e} within {TOL[dtype]:g}*|A||x|, repeat and "
        f"padded x bit-equal{t}"
    )
    return float(err.max()), k_ms, p_ms


def phase_kernels(bench, qp):
    rng = np.random.RandomState(0)
    A_blocks, A_cols, At_blocks, At_cols, _, _ = pack_bell_host(
        bench["A"], BELL_BS, np.float64
    )
    P_full = qp["P"] + sparse.triu(qp["P"], k=1).T
    P_blocks, P_cols, _ = pack_bell_sym_host(P_full, BELL_BS, np.float64)
    wide = sparse.random(2000, 1500, density=0.05, random_state=rng, format="csc")
    # (label, blocks, cols, true length of x, timed)
    cases = [
        ("bench A", A_blocks, A_cols, BELL_N, True),
        ("bench A^T", At_blocks, At_cols, BELL_M, True),
        ("QP P", P_blocks, P_cols, QP_N, False),
        ("wide (w ~ nbc) A", *pack_bell_host(wide, 32, np.float64)[:2], 1500, True),
        ("ragged bs=16 A", *pack_bell_host(
            sparse.random(1000, 777, density=0.03, random_state=rng, format="csc"),
            16, np.float64)[:2], 777, False),
        ("ragged bs=32 A^T", *pack_bell_host(
            sparse.random(1234, 999, density=0.03, random_state=rng, format="csc"),
            32, np.float64)[2:4], 1234, False),
    ]
    max_err, times = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for label, blocks_np, cols_np, x_len, timed in cases:
            err, k_ms, p_ms = _check_case(label, blocks_np, cols_np, x_len, dtype, rng, timed)
            max_err = max(max_err, err)
            if timed:
                times[(label, dtype)] = (k_ms, p_ms)
    # (pack shape, x length) per case, for the bounds
    shapes = {c[0]: (c[1].shape, c[3]) for c in cases}
    return max_err, times, (A_blocks, A_cols), shapes


def _check_batched_case(label, blocks_np, cols_np, x_len, dtype, rng, timed=False):
    """The batched kernel vs its plain version on the card for one stacked
    pack, on x of its true length x_len passed as a column slice of the
    padded tensor (strided rows, no copy); a repeated launch must be
    bit-equal. Returns (max_abs_err, kernel_ms, plain_ms)."""
    dev = torch.device("cuda")
    blocks = torch.as_tensor(blocks_np, dtype=dtype, device=dev)
    cols = torch.as_tensor(cols_np, device=dev)
    B, nbr, width, bs, _ = blocks_np.shape
    n_pad = max(int(cols_np.max()) + 1, -(-x_len // bs)) * bs
    x_pad = torch.zeros((B, n_pad), dtype=dtype, device=dev)
    x_pad[:, :x_len] = torch.as_tensor(rng.randn(B, x_len), dtype=dtype, device=dev)
    x = x_pad[:, :x_len]
    y_k = bell_spmv_batched(blocks, cols, x)
    y_again = bell_spmv_batched(blocks, cols, x)
    y_p = bell_spmv_batched_ref(blocks, cols, x_pad)
    bound = TOL[dtype] * bell_spmv_batched_ref(blocks.abs(), cols, x_pad.abs())
    torch.cuda.synchronize()
    err = (y_k - y_p).abs()
    if not bool(torch.all(err <= bound)):
        worst = float((err - bound).max())
        raise AssertionError(f"{label}: batched kernel disagrees with plain version (excess {worst:.3e})")
    if not torch.equal(y_k, y_again):
        raise AssertionError(f"{label} {dtype}: a repeated bell_spmv_batched launch differs")
    del bound, y_again
    k_ms = p_ms = None
    gb = blocks.numel() * blocks.element_size() / 1e9
    t = ""
    if timed:
        k_ms = time_graph_ms(lambda: bell_spmv_batched(blocks, cols, x))
        p_ms = time_ms(lambda: bell_spmv_batched_ref(blocks, cols, x_pad), inner=SPMV_INNER)
        b_ms = _spmv_bound(blocks_np.shape, x_len, dtype)[0]
        t = (f", kernel {k_ms:.4f} ms ({gb / k_ms * 1e3:.0f} GB/s), bound {b_ms:.4f} ms "
             f"({100 * b_ms / k_ms:.0f}%), plain {p_ms:.4f} ms")
    print(
        f"[3] batched {label} {str(dtype)[6:]}: pack ({B}, {nbr}, {width}, {bs}, {bs}), "
        f"{gb:.3f} GB, x {x_len} of {n_pad} unpadded, max |err| {float(err.max()):.3e} within "
        f"{TOL[dtype]:g}*|A||x|, repeat bit-equal{t}"
    )
    return float(err.max()), k_ms, p_ms


def phase_kernels_batched(batch, single_pack):
    """K3 (bell_spmv_batched) against bell_spmv_batched_ref: the
    bell_batch cell's stacked A and A^T packs (timed), ragged packs of
    mixed widths (padded), and a B = 1 launch that must equal bell_spmv
    bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.RandomState(1)
    with ThreadPoolExecutor(max_workers=BATCH_B) as ex:
        packs = list(ex.map(lambda A: pack_bell_host(A, BELL_BS, np.float64)[:4], batch["A"]))
    bench_A = stack_bell_host([p[0] for p in packs], [p[1] for p in packs])
    bench_At = stack_bell_host([p[2] for p in packs], [p[3] for p in packs])
    del packs

    def ragged(shape, bs, densities, transpose):
        ps = [
            pack_bell_host(
                sparse.random(*shape, density=d, random_state=rng, format="csc"),
                bs, np.float64,
            )
            for d in densities
        ]
        k = 2 if transpose else 0
        return stack_bell_host([p[k] for p in ps], [p[k + 1] for p in ps])

    # (label, blocks, cols, true length of x, timed)
    cases = [
        ("bench A", *bench_A, BATCH_N, True),
        ("bench A^T", *bench_At, BATCH_M, True),
        ("ragged bs=16 A, mixed widths", *ragged((1000, 777), 16, (0.0005, 0.001, 0.003, 0.01, 0.002), False), 777, False),
        ("ragged bs=32 A^T, mixed widths", *ragged((1234, 999), 32, (0.003, 0.0005, 0.001), True), 1234, False),
    ]
    widths = [c[1].shape[2] for c in cases]
    max_err, times = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for label, blocks_np, cols_np, x_len, timed in cases:
            err, k_ms, p_ms = _check_batched_case(label, blocks_np, cols_np, x_len, dtype, rng, timed)
            max_err = max(max_err, err)
            if timed:
                times[(label, dtype)] = (k_ms, p_ms)
            torch.cuda.empty_cache()
    # B = 1: the batched entry point must reproduce bell_spmv exactly
    dev = torch.device("cuda")
    blocks_np, cols_np = single_pack
    for dtype in (torch.float32, torch.float64):
        blocks = torch.as_tensor(blocks_np, dtype=dtype, device=dev)
        cols = torch.as_tensor(cols_np, device=dev)
        x = torch.as_tensor(rng.randn(BELL_N), dtype=dtype, device=dev)  # unpadded
        y1 = bell_spmv(blocks, cols, x)
        yb = bell_spmv_batched(blocks[None], cols[None], x[None])[0]
        if not torch.equal(y1, yb):
            raise AssertionError(f"B=1 batched launch differs from bell_spmv ({dtype})")
    print(f"[3] batched B=1 launch equals bell_spmv bit for bit (f32, f64); padded widths {widths}")
    return max_err, times, (bench_A[0].shape, BATCH_N)


def _spmv_bound(pack_shape, x_len, dtype):
    """Bound of one block-ELL SpMV over a pack (..., nbr, w, bs, bs): the
    pack and its int32 cols read once, x (x_len per problem) read once, y
    written once; 2 flops per stored element."""
    *lead, nbr, w, bs, _ = pack_shape
    batch = int(np.prod(lead)) if lead else 1
    item = torch.empty((), dtype=dtype).element_size()
    elems = batch * nbr * w * bs * bs
    n_bytes = elems * item + batch * nbr * w * 4 + batch * (x_len + nbr * bs) * item
    return bound_ms(n_bytes, 2 * elems, dtype)


def _gemv_bound(shape, out_len, dtype):
    """Bound of one batched dense GEMV over M (B, r, c): M and the input
    vectors read once, the (B, out_len) output written once; 2 flops per
    element of M."""
    B, r, c = shape
    item = torch.empty((), dtype=dtype).element_size()
    n_bytes = (B * r * c + B * (r + c - out_len) + B * out_len) * item
    return bound_ms(n_bytes, 2 * B * r * c, dtype)


# ragged shapes, checked but not timed: no multiple of 32 or of the vector
# width, rows of <= 8 and <= 16 groups, a tiny matrix, rows too long to
# stage x for
GEMV_RAGGED = [(1, 1501, 999), (3, 77, 53), (5, 33, 1027), (7, 130, 66), (2, 4, 8), (4, 9, 29),
               (3, 20, 4099)]


def phase_kernels_dense(tag):
    """G1 (gemv_rows) and G2 (gemv_cols) against their plain versions at
    every shape a main path launches them (gemv_proto.MAIN_SHAPES: the
    flagship's A and P/S^-1, the wide batch's A and S^-1, mixed_cone's A
    and S^-1, the single dense QP's A in f64 and at the flagship's width)
    and with M one element into its buffer, f32 and f64: within TOL, one
    launch per call, a bit-equal repeat, the 2-D call equal to B = 1, the
    misaligned M equal to its aligned copy; in the shape's own dtype the
    device time from CUDA-graph replays beside the bound, torch.bmm's (TF32
    off), and the host time per call of each; then ragged shapes, checked
    only. Returns (max |err| per kernel, the flagship A f32 records, every
    record)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {}
    for label, shape, dtype, kernels in [*gemv_proto.MAIN_SHAPES, gemv_proto.MISALIGNED]:
        offset = 1 if label == gemv_proto.MISALIGNED[0] else 0
        for dt in (torch.float32, torch.float64):
            timed = dt == dtype
            rec = gemv_proto.check_shape(shape, dt, kernels, gen, timed=timed, offset=offset,
                                         plain=timed and label == "flagship A")
            for which, r in rec.items():
                if offset and not r["equals_aligned_copy"]:
                    raise AssertionError(f"gemv_{which} {shape} {dt}: misaligned M differs from its aligned copy")
                print("[3] " + gemv_proto.fmt(label, shape, dt, which, r, tag))
            records[(label, dt)] = rec
            torch.cuda.empty_cache()
    for shape in GEMV_RAGGED:
        for dt in (torch.float32, torch.float64):
            rec = gemv_proto.check_shape(shape, dt, ("rows", "cols"), gen, timed=False)
            records[("ragged", shape, dt)] = rec
        print(f"[3] gemv ragged {shape} f32 and f64: within TOL, one launch per call, repeat "
              f"bit-equal, 2-D call equal to B = 1 where B = 1")
    max_err = {
        w: max(r[w]["max_abs_err"] for r in records.values() if w in r) for w in ("rows", "cols")
    }
    return max_err, records[("flagship A", torch.float32)], records


def phase_kernels_comp(tag):
    """D1 (df32.mv / df32.tv) on the card (gemv_proto.comp_shapes): every
    shape the high-accuracy paths launch it at, ragged widths, M one element
    into its buffer and rows whose products cancel, each against the float64
    product; timed at the hi_acc cell's A and P and at the single QP's A.
    Returns (max |kernel - plain| per kernel where both meet the bound, the
    records)."""
    recs = gemv_proto.comp_shapes(
        tag, timed_labels={"hi_acc A", "hi_acc P", "single dense A"}, prefix="[3] "
    )
    max_err = {
        w: max(r["max_abs_err"] for (label, k), r in recs.items()
               if k == w and label not in ("hi_acc dots", gemv_proto.COMP_CANCEL[0]))
        for w in ("rows", "cols")
    }
    return max_err, recs


def _gemv_counts():
    """The GEMV launches since the last reset, by (B, r, c)."""
    return (f"gemv_rows by shape {dict(sorted(gemv_rows.shapes.items(), key=lambda kv: -kv[1]))}, "
            f"gemv_cols by shape {dict(sorted(gemv_cols.shapes.items(), key=lambda kv: -kv[1]))}")


def _zero_counts(*kernels):
    for f in kernels:
        f.launches = 0
        if hasattr(f, "shapes"):
            f.shapes.clear()


def kkt_check(data, sol, eps, margin=5.0):
    """Host f64 KKT residuals of an LP/QP over the nonnegative cone against
    the raw data, each within margin x the solver's own criterion."""
    A, b, c = data["A"], data["b"], data["c"]
    x, y, s = (np.asarray(sol[k], np.float64) for k in ("x", "y", "s"))
    P = data.get("P")
    Px = np.zeros_like(x)
    if P is not None:
        Px = P @ x + P.T @ x - P.diagonal() * x  # P holds the upper triangle
    Ax, Aty = A @ x, A.T @ y
    pri = np.linalg.norm(Ax + s - b)
    dual = np.linalg.norm(Px + Aty + c)
    gap = abs(x @ Px + c @ x + b @ y)
    lim_p = eps + eps * max(np.linalg.norm(Ax), np.linalg.norm(s), np.linalg.norm(b))
    lim_d = eps + eps * max(np.linalg.norm(Px), np.linalg.norm(Aty), np.linalg.norm(c))
    lim_g = eps + eps * max(abs(x @ Px), abs(c @ x), abs(b @ y))
    cone = min(s.min(), y.min()) / max(np.linalg.norm(s), np.linalg.norm(y), 1.0)
    ok = (
        pri <= margin * lim_p and dual <= margin * lim_d
        and gap <= margin * lim_g and cone >= -margin * eps
    )
    if not ok:
        raise AssertionError(
            f"KKT check failed: pri {pri:.3e} (lim {lim_p:.3e}), dual {dual:.3e} "
            f"(lim {lim_d:.3e}), gap {gap:.3e} (lim {lim_g:.3e}), cone {cone:.3e}"
        )
    return pri / lim_p, dual / lim_d, gap / lim_g


def phase_main(bench):
    bell_spmv.launches = 0
    bell_spmv_batched.launches = 0
    t0 = time.perf_counter()
    solver = scs_tpu_torch.SCS(
        bench, {"l": BELL_M}, solver_strategy="bell", eps_abs=BELL_EPS,
        eps_rel=BELL_EPS, max_iters=50000, verbose=False, device="cuda",
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    sol = solver.solve()
    torch.cuda.synchronize()
    launches = bell_spmv.launches
    info = sol["info"]
    if solver.stg.dtype != "float32":
        raise AssertionError(f"expected an f32 solve on cuda, got {solver.stg.dtype}")
    if info["status"] != "solved":
        raise AssertionError(f"bell LP status {info['status']!r} after {info['iter']} iterations")
    if launches <= 0:
        raise AssertionError("the main path launched no bell_spmv kernel")
    rp, rd, rg = kkt_check(bench, sol, BELL_EPS)
    print(
        f"[4] bell LP {BELL_M}x{BELL_N} nnz {bench['A'].nnz} f32 on cuda: "
        f"{info['status']} in {info['iter']} iterations, "
        f"{solver._last_state.cg_iters} CG iterations, {launches} bell_spmv "
        f"launches; setup {setup:.3f} s, solve {info['solve_time']:.3f} s; "
        f"pobj {info['pobj']:.6e}; host f64 KKT / limit: pri {rp:.3f}, "
        f"dual {rd:.3f}, gap {rg:.3f} (BENCH_r05 TPU v5e run, reference "
        f"only: {BELL_TPU_ITERS} iterations)"
    )
    return launches, info["pobj"]


def bell_profile(bench, chunks=2, warmup=2):
    """`python3 chip_smoke.py --bell-profile`: a torch.profiler window over
    `chunks` chunks (check_interval iterations each) of the bell LP's solve
    after `warmup` chunks, with the same chunks timed unprofiled just
    before: kernels and CG iterations in the window, the device's busy and
    idle share, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    solver = scs_tpu_torch.SCS(
        bench, {"l": BELL_M}, solver_strategy="bell", eps_abs=BELL_EPS,
        eps_rel=BELL_EPS, max_iters=50000, verbose=False, device="cuda",
    )
    core, mats = solver.core, solver.mats

    def run(state, k):
        for _ in range(k):
            state = core._chunk(state, mats)
        torch.cuda.synchronize()
        return state

    state = run(solver._state0, warmup)
    cg0, l0 = state.cg_iters, bell_spmv.launches
    t0 = time.perf_counter()
    state = run(state, chunks)
    plain_ms = (time.perf_counter() - t0) * 1e3
    cg_plain, launches = state.cg_iters - cg0, bell_spmv.launches - l0
    cg0 = state.cg_iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, chunks)
        prof_ms = (time.perf_counter() - t0) * 1e3
    cg_prof = state.cg_iters - cg0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy, n_kernels = sum(r[1] for r in rows), sum(r[2] for r in rows)
    iters = chunks * int(solver.stg.check_interval)
    print(
        f"[bell profile] {iters} iterations unprofiled: {plain_ms:.1f} ms, {int(cg_plain)} CG "
        f"iterations, {launches} bell_spmv launches; the next {iters} profiled: {prof_ms:.1f} ms, "
        f"{int(cg_prof)} CG iterations, {n_kernels} kernels ({n_kernels / max(int(cg_prof), 1):.1f} "
        f"per CG iteration), busy {busy:.1f} ms = {100 * busy / prof_ms:.1f}% of the profiled "
        f"wall (idle {100 - 100 * busy / prof_ms:.1f}%) and {100 * busy / plain_ms:.1f}% of the "
        f"unprofiled one"
    )
    for name, ms, count in rows[:10]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<6d} {name[:90]}")
    spmv = [(ms, count) for name, ms, count in rows if "bell_spmv" in name]
    print(
        f"[bell profile] bell_spmv kernels: {sum(m for m, _ in spmv):.1f} ms in "
        f"{sum(c for _, c in spmv)} launches"
    )
    bell_spmv.launches = 0
    sol = solver.solve()
    torch.cuda.synchronize()
    info = sol["info"]
    print(
        f"[bell profile] then the whole solve: {info['status']} in {info['iter']} iterations, "
        f"{solver._last_state.cg_iters} CG iterations, {bell_spmv.launches} bell_spmv launches, "
        f"{info['solve_time']:.3f} s"
    )


def phase_qp(qp):
    kw = dict(
        solver_strategy="bell", eps_abs=QP_EPS, eps_rel=QP_EPS,
        max_iters=20000, verbose=False, dtype="float64",
    )
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = scs_tpu_torch.solve(qp, {"l": QP_M}, device=dev, **kw)
        res[dev]["secs"] = time.perf_counter() - t0
    g, c = res["cuda"]["info"], res["cpu"]["info"]
    if g["status"] != c["status"] or g["status"] != "solved":
        raise AssertionError(f"QP status cuda {g['status']!r} vs cpu {c['status']!r}")
    if abs(g["iter"] - c["iter"]) > 25:  # one check_interval
        raise AssertionError(f"QP iterations cuda {g['iter']} vs cpu {c['iter']}")
    rel = abs(g["pobj"] - c["pobj"]) / max(abs(c["pobj"]), 1e-12)
    if rel > 1e-6:
        raise AssertionError(f"QP pobj cuda {g['pobj']!r} vs cpu {c['pobj']!r}")
    kkt_check(qp, res["cuda"], QP_EPS)
    print(
        f"[5] QP {QP_M}x{QP_N} f64: cuda {g['status']} in {g['iter']} it "
        f"({res['cuda']['secs']:.2f} s), cpu {c['status']} in {c['iter']} it "
        f"({res['cpu']['secs']:.2f} s); pobj {g['pobj']:.12e} vs "
        f"{c['pobj']:.12e} (rel {rel:.2e})"
    )


def phase_batch(batch):
    bell_spmv.launches = 0
    bell_spmv_batched.launches = 0
    t0 = time.perf_counter()
    solver = scs_tpu_torch.BatchedSCS(
        batch, {"l": BATCH_M}, solver_strategy="bell", dtype="float32",
        eps_abs=BATCH_EPS, eps_rel=BATCH_EPS, max_iters=20000, verbose=False,
        device="cuda",
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    solver.core.cg_steps = 0
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    launches, single_launches = bell_spmv_batched.launches, bell_spmv.launches
    if launches <= 0:
        raise AssertionError("the batched path launched no bell_spmv_batched kernel")
    if single_launches != 0:
        raise AssertionError(f"the batched path launched bell_spmv {single_launches} times")
    statuses = [r["info"]["status"] for r in res]
    if statuses != ["solved"] * BATCH_B:
        raise AssertionError(f"bell_batch statuses {statuses}")
    worst = [0.0, 0.0, 0.0]
    for i, r in enumerate(res):
        one = {"A": batch["A"][i], "b": batch["b"][i], "c": batch["c"][i]}
        worst = [max(a, b) for a, b in zip(worst, kkt_check(one, r, BATCH_EPS))]
    bell = solver.mats.bell
    pack_gb = sum(
        t.numel() * t.element_size()
        for t in (bell.A_blocks, bell.A_cols, bell.At_blocks, bell.At_cols)
    ) / 1e9
    iters = np.array([r["info"]["iter"] for r in res])
    print(
        f"[6] bell_batch {BATCH_B} x {BATCH_M}x{BATCH_N} nnz {batch['A'][0].nnz} each, "
        f"f32 on cuda: {BATCH_B}/{BATCH_B} solved; setup {setup:.3f} s, solve "
        f"{solve:.3f} s; iterations mean {iters.mean():.1f}, max {iters.max()} "
        f"(BENCH_r05 TPU v5e run, reference only: mean {BATCH_TPU_MEAN_ITERS}); "
        f"{solver.core.cg_steps} batched CG iterations; device_prob_iters "
        f"{solver.device_prob_iters}; {launches} bell_spmv_batched launches, "
        f"{single_launches} bell_spmv; pack {pack_gb:.3f} GB; worst host f64 "
        f"KKT / limit: pri {worst[0]:.3f}, dual {worst[1]:.3f}, gap {worst[2]:.3f}"
    )
    del solver
    torch.cuda.empty_cache()
    # cross-check: problem 0 alone through the single-problem path
    one = {"A": batch["A"][0], "b": batch["b"][0], "c": batch["c"][0]}
    sol = scs_tpu_torch.solve(
        one, {"l": BATCH_M}, solver_strategy="bell", dtype="float32",
        eps_abs=BATCH_EPS, eps_rel=BATCH_EPS, max_iters=20000, verbose=False,
        device="cuda",
    )
    a, b = res[0]["info"], sol["info"]
    rel = abs(a["pobj"] - b["pobj"]) / max(abs(b["pobj"]), 1e-12)
    if a["status"] != b["status"] or rel > 1e-3:
        raise AssertionError(
            f"problem 0 batched {a['status']!r} pobj {a['pobj']!r} vs alone "
            f"{b['status']!r} pobj {b['pobj']!r}"
        )
    print(
        f"[6] problem 0 alone through SCS: {b['status']} in {b['iter']} iterations "
        f"(batched: {a['iter']}), pobj {b['pobj']:.6e} vs {a['pobj']:.6e} (rel {rel:.2e})"
    )
    return launches


def gen_dense_qp(m, n, seed=5):
    """One dense QP over the nonnegative cone by the flagship's
    construction (scs_tpu.bench_cli.gen_batch with B = 1), in numpy; P is
    passed as its upper triangle, as the API expects."""
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    G = rng.standard_normal((n, n // 8))
    P = (0.1 / (n // 8)) * (G @ G.T) + 1e-4 * np.eye(n)
    z = rng.standard_normal(m)
    y = np.maximum(z, 0)
    x = rng.standard_normal(n)
    c = -(A.T @ y) - P @ x
    b = A @ x + (y - z)
    return {
        "A": sparse.csc_matrix(A), "P": sparse.csc_matrix(np.triu(P)), "b": b, "c": c,
    }, float(0.5 * x @ P @ x + c @ x)


def phase_dense_single():
    """A dense QP through SCS under both dense strategies and both direct
    modes, f64, on the card against the CPU."""
    data, p_star = gen_dense_qp(DENSE_QP_M, DENSE_QP_N)
    # the CG path reads the device once per CG iteration: it runs at a
    # looser eps to keep the phase short
    for eps, kw in (
        (DENSE_QP_EPS, dict(solver_strategy="direct", direct_solver="cholesky")),
        (DENSE_QP_EPS, dict(solver_strategy="direct", direct_solver="inverse")),
        (1e-4, dict(solver_strategy="indirect")),
    ):
        res = {}
        for dev in ("cuda", "cpu"):
            _zero_counts(gemv_rows, gemv_cols)
            t0 = time.perf_counter()
            res[dev] = scs_tpu_torch.solve(
                data, {"l": DENSE_QP_M}, device=dev, dtype="float64",
                eps_abs=eps, eps_rel=eps, max_iters=20000, verbose=False, **kw,
            )
            res[dev]["secs"] = time.perf_counter() - t0
            res[dev]["launches"] = (gemv_rows.launches, gemv_cols.launches)
            res[dev]["by_shape"] = _gemv_counts()
        g, c = res["cuda"]["info"], res["cpu"]["info"]
        if g["status"] != c["status"] or g["status"] != "solved":
            raise AssertionError(f"dense QP {kw}: cuda {g['status']!r} vs cpu {c['status']!r}")
        rel = abs(g["pobj"] - c["pobj"]) / max(abs(c["pobj"]), 1e-12)
        rel_star = abs(g["pobj"] - p_star) / max(abs(p_star), 1e-12)
        if rel > 10 * eps or rel_star > 100 * eps:
            raise AssertionError(
                f"dense QP {kw}: pobj cuda {g['pobj']!r}, cpu {c['pobj']!r}, planted {p_star!r}"
            )
        if min(res["cuda"]["launches"]) <= 0 or res["cpu"]["launches"] != (0, 0):
            raise AssertionError(f"dense QP {kw}: gemv launches {res['cuda']['launches']} on cuda, "
                                 f"{res['cpu']['launches']} on cpu")
        kkt_check(data, res["cuda"], eps)
        print(
            f"[7] dense QP {DENSE_QP_M}x{DENSE_QP_N} f64 eps {eps:g} {kw}: cuda {g['status']} in "
            f"{g['iter']} it ({res['cuda']['secs']:.2f} s; gemv_rows/gemv_cols launches "
            f"{res['cuda']['launches']}: {res['cuda']['by_shape']}), cpu {c['status']} in {c['iter']} it "
            f"({res['cpu']['secs']:.2f} s); pobj {g['pobj']:.10e} vs {c['pobj']:.10e} "
            f"(rel {rel:.2e}; vs planted {rel_star:.2e})"
        )


def _d1_counts():
    """D1's launches since the last reset, by (B, r, c)."""
    return (f"df32.mv {df32.mv.launches} {dict(df32.mv.shapes)}, "
            f"df32.tv {df32.tv.launches} {dict(df32.tv.shapes)}")


def phase_hi_acc_single():
    """One QP of the bench's generator (gen_batch(1, 1500, 1000)[0]) in f32 at
    eps 1e-6 under "direct": the high-accuracy mode, held to the rules of
    tests/test_hi_accuracy.py::test_qp_eps6_f32_matches_f64. Returns D1's
    launches (mv, tv)."""
    A, P, b, c, p_star = gen_batch(1, HI_M, HI_N, return_opt=True)
    A, P, b, c, p_star = A[0], P[0], b[0], c[0], float(p_star[0])
    data = {"A": sparse.csc_matrix(A), "P": sparse.csc_matrix(np.triu(P)), "b": b, "c": c}
    _zero_counts(df32.mv, df32.tv, gemv_rows, gemv_cols)
    t0 = time.perf_counter()
    solver = scs_tpu_torch.SCS(
        data, {"l": HI_M}, device="cuda", dtype="float32", solver_strategy="direct",
        eps_abs=1e-6, eps_rel=1e-6, max_iters=50000, verbose=False,
    )
    sol = solver.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (df32.mv.launches, df32.tv.launches)
    counts = _d1_counts()
    info = sol["info"]
    if not (solver.core.hi_acc and solver.core.refine_steps == 2):
        raise AssertionError("f32 at eps 1e-6 on cuda did not resolve to the high-accuracy mode")
    if min(launches) <= 0:
        raise AssertionError(f"the high-accuracy solve launched D1 {launches} times")
    x, y, s = (np.asarray(sol[k], np.float64) for k in ("x", "y", "s"))
    rp = np.linalg.norm(A @ x + s - b)
    rd = np.linalg.norm(P @ x + A.T @ y + c)
    scale_p = 1 + max(np.linalg.norm(A @ x), np.linalg.norm(b))
    scale_d = 1 + max(np.linalg.norm(P @ x), np.linalg.norm(c))
    obj = abs(info["pobj"] - p_star) / (1 + abs(p_star))
    if info["status"] != "solved" or obj > 1e-5 or rp >= 2e-6 * scale_p or rd >= 2e-6 * scale_d:
        raise AssertionError(
            f"high-accuracy QP: {info['status']} in {info['iter']} it, pobj {info['pobj']!r} vs "
            f"p* {p_star!r} ({obj:.2e}), pri {rp:.3e} (lim {2e-6 * scale_p:.3e}), dual {rd:.3e} "
            f"(lim {2e-6 * scale_d:.3e})"
        )
    print(
        f"[7] high-accuracy QP {HI_M}x{HI_N} (gen_batch(1, {HI_M}, {HI_N})[0]) f32 eps 1e-6 "
        f"direct on cuda: {info['status']} in {info['iter']} iterations, {secs:.2f} s; "
        f"|pobj - p*| / (1 + |p*|) {obj:.2e}; f64 KKT / (2e-6 x scale): pri "
        f"{rp / (2e-6 * scale_p):.3f}, dual {rd / (2e-6 * scale_d):.3f}; D1 launches {counts}; "
        f"G1/G2 launches {gemv_rows.launches}, {gemv_cols.launches}"
    )
    return launches


def _time_iteration(solver, reps=5):
    """Seconds per full-batch lockstep iteration (no AA trial, no check) of
    a freshly set-up BatchedSCS, after one warm-up iteration."""
    core, mats, state = solver.core, solver.mats, solver._states
    state = core._iter_plain(state, mats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = core._iter_plain(state, mats)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_flagship():
    """The dense main path: the flagship QP batch through BatchedSCS."""
    t0 = time.perf_counter()
    data, p_star, obj_scale = gen_qp_batch(
        FLAG_B, FLAG_M, FLAG_N, seed=FLAG_SEED, device="cuda"
    )
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    kw = dict(
        dtype="float32", eps_abs=FLAG_EPS, eps_rel=FLAG_EPS, max_iters=20000,
        device="cuda",
    )
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(gemv_rows, gemv_cols, bell_spmv, bell_spmv_batched)
    solver = scs_tpu_torch.BatchedSCS(data, {"l": FLAG_M}, **kw)
    torch.cuda.synchronize()
    setup_launches = (gemv_rows.launches, gemv_cols.launches)
    gemv_rows.shapes.clear()
    gemv_cols.shapes.clear()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    solve = time.perf_counter() - t0
    g1, g2 = gemv_rows.launches, gemv_cols.launches
    by_shape = _gemv_counts()
    spmv = bell_spmv.launches + bell_spmv_batched.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if g1 <= setup_launches[0] or g2 <= setup_launches[1]:
        raise AssertionError(f"the dense path launched gemv_rows {g1}, gemv_cols {g2} times")
    if spmv != 0:
        raise AssertionError(f"the dense path launched {spmv} block-ELL SpMV kernels")
    statuses = [r["info"]["status"] for r in res]
    n_solved = sum(st == "solved" for st in statuses)
    if n_solved != FLAG_B:
        raise AssertionError(
            f"flagship: {n_solved}/{FLAG_B} solved; others: "
            f"{sorted(set(statuses) - {'solved'})}"
        )
    pobj = torch.as_tensor([r["info"]["pobj"] for r in res], dtype=torch.float64)
    # p* = 0.5 x'Px + c'x cancels to near 0 for some problems (terms of
    # ~100), so the error is held against the larger term, which is what a
    # solve at eps bounds; the bench's own measure, over 1 + |p*|, is printed
    err = (pobj - p_star.cpu()).abs()
    rel = (err / obj_scale.cpu()).max()
    rel_bench = (err / (1 + p_star.cpu().abs())).max()
    if float(rel) > 1e-3:
        raise AssertionError(
            f"flagship: objective off the planted optimum by {float(rel):.3e} of its largest term"
        )
    worst = kkt_check_batch(data, res, FLAG_EPS)
    iters = np.array([r["info"]["iter"] for r in res])
    sb = solver.setup_breakdown
    print(
        f"[8] flagship {FLAG_B} x {FLAG_M}x{FLAG_N} dense QPs, f32 on cuda "
        f"(generated on the card in {t_gen:.2f} s): {n_solved}/{FLAG_B} solved; "
        f"setup {sum(sb.values()):.3f} s (transfer {sb['transfer']:.3f}, equilibrate "
        f"{sb['equilibrate']:.3f}, factorize {sb['factorize']:.3f}, compute_g "
        f"{sb['compute_g']:.3f}), solve {solve:.3f} s; iterations mean {iters.mean():.1f}, "
        f"max {iters.max()} (BENCH_r05 TPU v5e run, reference only: mean "
        f"{FLAG_TPU_ITERS[0]}, max {FLAG_TPU_ITERS[1]}); device_prob_iters "
        f"{solver.device_prob_iters} (sum of iterations {iters.sum()}); bucket ladder "
        f"{solver.bucket_ladder}; launches gemv_rows {g1}, gemv_cols {g2} (of them "
        f"{setup_launches[0]} and {setup_launches[1]} in setup; the solve's {by_shape}), SpMV {spmv}; max "
        f"|pobj - p*| {float(err.max()):.2e}, over the objective's largest term "
        f"{float(rel):.2e}, over 1 + |p*| {float(rel_bench):.2e}; worst f64 KKT / limit: pri {worst[0]:.3f}, "
        f"dual {worst[1]:.3f}, gap {worst[2]:.3f}; peak device memory {peak_gb:.1f} GB"
    )
    _profile_report(8, solver)
    # one full-batch iteration under each direct_solver mode
    solver.reset()
    t_inv = _time_iteration(solver)
    del solver
    torch.cuda.empty_cache()
    chol = scs_tpu_torch.BatchedSCS(data, {"l": FLAG_M}, direct_solver="cholesky", **kw)
    t_chol = _time_iteration(chol)
    print(
        f"[8] one lockstep iteration at B = {FLAG_B}: direct_solver='inverse' "
        f"{t_inv * 1e3:.2f} ms, 'cholesky' {t_chol * 1e3:.2f} ms (factorize "
        f"{chol.setup_breakdown['factorize']:.3f} s vs {sb['factorize']:.3f} s)"
    )
    return g1, g2


def phase_kernels_cones():
    """The cone-projection kernels (proj_exp, proj_pow, proj_box) against
    their plain versions, and the projections left as plain tensor code on
    the card against the CPU. Sizes: the exp and power rows one projection
    of the mixed_cone cell stacks (64 x 20 and 64 x 4), of the wide batch
    (128 x 300 and 128 x 100), and 10^6."""
    report = mixed_cone.check_cone_kernels(HBM_BYTES_PER_S, PEAK_FLOPS)
    eigh_ms = mixed_cone.check_plain_on_card()
    return report, eigh_ms


def phase_kernels_spectral():
    """C4 and C5 (proj_logdet_vec, proj_sl_vec) against their plain
    versions (mixed_cone.check_spectral_kernels: rows in every regime, n in
    1, 2, 31, 32, 33, the edges of the kernels' layouts and past 256, the
    shapes phase 15 hands them; the stated tolerance, a bit-equal repeat,
    the f64 geometry against the oracle's projection in worker processes;
    the serial passes, the roofline bound and the serial floor)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    with ProcessPoolExecutor(
        SPECTRAL_WORKERS, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        report = mixed_cone.check_spectral_kernels(
            HBM_BYTES_PER_S, PEAK_FLOPS, mixed_cone.sm_clock_hz(), pool=pool)
    print(f"[3] C4 and C5 checked in {time.perf_counter() - t0:.1f} s")
    return report


def phase_kernels_captured(*captures):
    """Phase 3's checks of proj_exp, proj_pow and proj_box
    (check_cone_kernels: the stated tolerance, a bit-equal repeat, the f64
    geometry), on the rows phases 9 and 10 handed them early, in the middle
    and late in their solves; run after phase 10, which captures them."""
    exp_in, box_in, pow_in = [], [], []
    for tag, cap in captures:
        e, b, p = cap.inputs(tag)
        exp_in += e
        box_in += b
        pow_in += p
    t0 = time.perf_counter()
    mixed_cone.check_cone_kernels(
        HBM_BYTES_PER_S, PEAK_FLOPS, exp_sizes=(), pow_sizes=(), box_cases=(),
        exp_inputs=exp_in, box_inputs=box_in, pow_inputs=pow_in, geometry_rows=700, plain_reps=1,
    )
    print(f"[3] the captured rows: {len(exp_in)} exponential, {len(pow_in)} power and "
          f"{len(box_in)} box cases, f32 and f64, checked in {time.perf_counter() - t0:.1f} s")


def _mixed_gates(label, K, data, p_star, solver, res, pool=None, A_rows=None, cone_every=1):
    """The gates of a mixed-cone batch: all solved, objectives against the
    planted ones, host f64 residuals and cone membership, the projections
    through their kernels and the matvecs through the GEMV kernels. Returns
    the worst (pri, dual, gap, dist s, dist y)."""
    B = len(res)
    statuses = [r["info"]["status"] for r in res]
    n_solved = sum(st == "solved" for st in statuses)
    if n_solved != B:
        raise AssertionError(
            f"{label}: {n_solved}/{B} solved; others: {sorted(set(statuses) - {'solved'})}"
        )
    err = np.abs(np.array([r["info"]["pobj"] for r in res]) - p_star)
    if not err.max() < MIXED_OBJ_TOL:
        raise AssertionError(
            f"{label}: objective off the planted optimum by {err.max():.3e} (problem {err.argmax()})"
        )
    spec = solver.spec
    for fn, needed in zip(CONE_KERNELS, (spec.ep + spec.ed, len(spec.p), spec.bsize)):
        if needed and fn.launches <= 0:
            raise AssertionError(f"{label}: {fn.__name__} launched no kernel")
    if min(gemv_rows.launches, gemv_cols.launches) <= 0:
        raise AssertionError(f"{label}: gemv launches {gemv_rows.launches}, {gemv_cols.launches}")
    if bell_spmv.launches + bell_spmv_batched.launches != 0:
        raise AssertionError(f"{label}: the dense path launched a block-ELL SpMV kernel")
    return mixed_cone.check_solutions(
        K, data, res, mixed_cone.MIXED_EPS, pool=pool, A_rows=A_rows, cone_every=cone_every
    )


def _time_phases(solver, reps=5):
    """Milliseconds of one linear step, one cone step and the projector
    alone at the full batch, from the solver's state after two warm-up
    iterations."""
    core, mats, state = solver.core, solver.mats, solver._states
    for _ in range(2):
        state = core._iter_plain(state, mats)
    n, m = core.n, core.m

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    t_lin, (ut, px, cg_k) = timed(lambda: core._step_lin(state, mats))
    t_cone, _ = timed(lambda: core._step_cone(state, ut, px, cg_k, mats))
    z = -(2.0 * ut - state.w)[:, n : n + m]
    t_proj, _ = timed(lambda: core._proj(z, mats.bl, mats.bu))
    return t_lin, t_cone, t_proj


def _solve_mixed(label, K, data):
    """Set up and solve one mixed-cone batch on the card; the launch counts
    are zeroed just before the solve. The solve copies the rows of every
    50th call of proj_exp, proj_pow and proj_box (mixed_cone.CaptureRows,
    for phase 3's checks on them: a clone on the device, no kernel launch).
    Returns (solver, results, setup s, solve s, per-phase ms, capture)."""
    t0 = time.perf_counter()
    solver = scs_tpu_torch.BatchedSCS(
        data, K, dtype="float32", eps_abs=mixed_cone.MIXED_EPS, eps_rel=mixed_cone.MIXED_EPS,
        max_iters=20000, scale=1.0, device="cuda",
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    phases = _time_phases(solver)
    solver.reset()
    _zero_counts(*CONE_KERNELS, gemv_rows, gemv_cols, bell_spmv, bell_spmv_batched)
    with mixed_cone.CaptureRows() as cap:
        t0 = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
    return solver, res, setup, solve, phases, cap


def _mixed_report(tag, label, solver, res, p_star, setup, solve, phases, worst, extra=""):
    iters = np.array([r["info"]["iter"] for r in res])
    err = np.abs(np.array([r["info"]["pobj"] for r in res]) - p_star)
    exp_l, pow_l, box_l = (f.launches for f in CONE_KERNELS)
    print(
        f"[{tag}] {label}, f32 on cuda: {len(res)}/{len(res)} solved; setup {setup:.3f} s, solve "
        f"{solve:.3f} s; iterations mean {iters.mean():.1f}, max {iters.max()}{extra}; "
        f"device_prob_iters {solver.device_prob_iters} (sum of iterations {iters.sum()}); bucket "
        f"ladder {solver.bucket_ladder}; launches proj_exp {exp_l}, proj_pow {pow_l}, proj_box "
        f"{box_l}, gemv_rows {gemv_rows.launches}, gemv_cols {gemv_cols.launches} ({_gemv_counts()}), "
        f"SpMV 0; max "
        f"|pobj - p*| {err.max():.2e} (limit {MIXED_OBJ_TOL:g}); worst host f64 residual / limit: pri "
        f"{worst[0]:.3f}, dual {worst[1]:.3f}, gap {worst[2]:.3f}; distance of s from K "
        f"{worst[3]:.2e}, of y from K* {worst[4]:.2e} (relative; the oracle's projections); one "
        f"full-batch iteration: linear step {phases[0]:.3f} ms, cone step {phases[1]:.3f} ms, of "
        f"it the projector {phases[2]:.3f} ms"
    )
    return exp_l, pow_l, box_l


def _profile_report(tag, solver):
    """A torch.profiler window over two chunks of a solved BatchedSCS, reset
    first: kernels per iteration, busy and idle share, the shares of the
    GEMV kernels, of the three cone kernels and of eigh's kernels."""
    solver.reset()
    plain_ms, prof_ms, busy, n_kernels, rows = profile_window(solver)
    iters = 2 * int(solver.stg.check_interval)

    def share(*pats):
        return sum(ms for name, ms, _ in rows if any(p in name.lower() for p in pats))

    cones = share("proj_exp", "proj_pow", "proj_box")
    c4, c5 = share("proj_logdet"), share("proj_sl_")
    gemv = share("gemv_")
    # the library's symmetric eigensolver: tridiagonalization, divide and
    # conquer or Jacobi sweeps, back-transformation
    eigh = share("syev", "heev", "jacobi", "sytrd", "ormtr", "ormqr", "orgtr", "stedc", "steqr",
                 "laed", "larf", "latrd", "lasr")
    print(
        f"[{tag}] window: 2 chunks = {iters} lockstep iterations at B = {solver.B}: {plain_ms:.1f} "
        f"ms unprofiled, {prof_ms:.1f} ms profiled; {n_kernels} kernels ({n_kernels / iters:.1f} "
        f"per iteration), busy {busy:.1f} ms = {100 * busy / plain_ms:.1f}% of the unprofiled wall "
        f"(idle {100 - 100 * busy / plain_ms:.1f}%); of busy: gemv kernels "
        f"{100 * gemv / busy:.1f}%, the three cone kernels {100 * cones / busy:.1f}%, C4 "
        f"{100 * c4 / busy:.1f}%, C5 {100 * c5 / busy:.1f}%, eigh (by kernel name) "
        f"{100 * eigh / busy:.1f}%"
    )
    for name, ms, count in rows[:12]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<6d} {name[:90]}")


def phase_mixed_cone():
    """The scs_tpu bench's mixed_cone cell at its full size."""
    K = mixed_cone.MIXED_K
    data, p_star = mixed_cone.gen_mixed_batch(K, mixed_cone.MIXED_B, mixed_cone.MIXED_SEED)
    solver, res, setup, solve, phases, cap = _solve_mixed("mixed_cone", K, data)
    worst = _mixed_gates("mixed_cone", K, data, p_star, solver, res)
    B, m, n = data["A"].shape
    launches = _mixed_report(
        9, f"mixed_cone {B} x {m}x{n} over {K}", solver, res, p_star, setup, solve, phases, worst,
        extra=f" (BENCH_r05 TPU v5e run, reference only: mean {MIXED_TPU_ITERS[0]}, max "
              f"{MIXED_TPU_ITERS[1]})",
    )
    _profile_report(9, solver)
    return launches, cap


def phase_mixed_wide():
    """The wide mixed-cone batch: problems planted by the numpy oracle (a
    second a problem) in worker processes, solved as one batch and checked
    on the host by the same workers; then a profiler window over two
    chunks."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    K = mixed_cone.wide_cone()
    with ProcessPoolExecutor(
        WIDE_WORKERS, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        return _mixed_wide(K, pool)


def _mixed_wide(K, pool):
    t0 = time.perf_counter()
    data, p_star, A_rows = mixed_cone.collect_mixed_batch(
        mixed_cone.gen_mixed_batch(K, mixed_cone.WIDE_B, WIDE_SEED, pool=pool)
    )
    B, m, n = data["A"].shape
    n_exp, n_pow = K["ep"] + K["ed"], len(K["p"])
    print(
        f"[10] mixed_cone_wide: {B} problems of {m}x{n} generated in {WIDE_WORKERS} worker "
        f"processes in {time.perf_counter() - t0:.1f} s; nothing cut: A "
        f"{data['A'].nbytes / 1e9:.2f} GB "
        f"in f32, {B * n_exp} exponential and {B * n_pow} power cones, {B * len(K['s'])} "
        f"matrices of {K['s'][0]} x {K['s'][0]} and {B} boxes of {len(K['bu'])} bounds per projection"
    )
    solver, res, setup, solve, phases, cap = _solve_mixed("mixed_cone_wide", K, data)
    worst = _mixed_gates("mixed_cone_wide", K, data, p_star, solver, res, pool, A_rows)
    launches = _mixed_report(
        10, f"mixed_cone_wide {B} x {m}x{n}", solver, res, p_star, setup, solve, phases, worst
    )
    _profile_report(10, solver)
    return launches, cap


def _solve_spectral(K, data, dtype):
    """Set up and solve one spectral-cone batch on the card, eps DOPT_EPS:
    the launch counts zeroed just before the solve and read just
    after, the rows of every 50th call of C4 / C5 of each width copied
    (mixed_cone.CaptureRows; a clone on the device, no kernel launch).
    Returns (solver, results, setup s, solve s, launches, capture)."""
    t0 = time.perf_counter()
    solver = scs_tpu_torch.BatchedSCS(
        data, K, dtype=dtype, eps_abs=DOPT_EPS, eps_rel=DOPT_EPS, max_iters=20000, device="cuda",
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    kernels = (*SPECTRAL_KERNELS, *CONE_KERNELS, gemv_rows, gemv_cols, bell_spmv,
               bell_spmv_batched)
    _zero_counts(*kernels)
    with mixed_cone.CaptureRows() as cap:
        t0 = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels}
    return solver, res, setup, solve, launches, cap


def _spectral_launch_gates(label, launches, cap, need_logdet, need_sl):
    """Every spectral projection through its kernel (one launch a call of
    the wrapper), the dense matvecs through G1/G2, no SpMV."""
    faults = []
    for kind, name, needed in (("logdet", "_proj_logdet_vec_batch", need_logdet),
                               ("sl", "_proj_sl_vec_batch", need_sl)):
        if launches[name] != cap.calls[kind] or bool(needed) != (launches[name] > 0):
            faults.append(f"{name}: {launches[name]} launches for {cap.calls[kind]} calls")
    if min(launches["gemv_rows"], launches["gemv_cols"]) <= 0:
        faults.append(f"gemv launches {launches['gemv_rows']}, {launches['gemv_cols']}")
    if launches["bell_spmv"] + launches["bell_spmv_batched"] + sum(
            launches[f.__name__] for f in CONE_KERNELS):
        faults.append(f"a kernel off this path launched: {launches}")
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))


def _spectral_report(label, dtype, res, setup, solve, launches, worst, extra=""):
    iters = np.array([r["info"]["iter"] for r in res])
    print(
        f"[15] {label}, {dtype} on cuda: {len(res)}/{len(res)} solved; setup {setup:.3f} s, solve "
        f"{solve:.3f} s; iterations mean {iters.mean():.1f}, max {iters.max()}; launches C4 "
        f"{launches['_proj_logdet_vec_batch']}, C5 {launches['_proj_sl_vec_batch']}, gemv_rows "
        f"{launches['gemv_rows']}, gemv_cols {launches['gemv_cols']} ({_gemv_counts()}), SpMV 0; "
        f"worst host f64 residual / limit: pri {worst[0]:.3f}, dual {worst[1]:.3f}, gap "
        f"{worst[2]:.3f}; distance of s from K {worst[3]:.2e}, of y from K* {worst[4]:.2e} "
        f"(relative; the oracle's projections){extra}"
    )


def _dopt_gates(label, V, results):
    """The design gates on each solution: |t - logdet X(lam)| and the
    Kiefer-Wolfowitz gap. Returns the worst of each, and how many are over
    1e-3 (1 + |t|)."""
    worst = [0.0, 0.0, 0]
    for i, r in enumerate(results):
        rel, gap = mixed_cone.dopt_check(V[i], r["x"])
        if not (rel <= DOPT_LOGDET_TOL and gap <= DOPT_DELTA):
            raise AssertionError(
                f"{label} problem {i}: |t - logdet X| / (1 + |t|) {rel:.3e} (limit "
                f"{DOPT_LOGDET_TOL:g}), Kiefer-Wolfowitz gap / n {gap:.3e} (limit {DOPT_DELTA:g})")
        worst = [max(worst[0], rel), max(worst[1], gap), worst[2] + (rel > 1e-3)]
    return worst


def _phase_dopt(pool):
    """Phase 15 (a): the D-optimal design batch through BatchedSCS, then its
    problem 0 alone through SCS in f64; the host's checks of both in the
    pool's workers at once (problem 0 alone last, with its cone membership:
    DOPT_B is a multiple of DOPT_CONE_EVERY). Returns (launches,
    capture)."""
    B, n, p = mixed_cone.DOPT_B, mixed_cone.DOPT_N, mixed_cone.DOPT_P
    K = mixed_cone.dopt_cone(n, p)
    t0 = time.perf_counter()
    data, V = mixed_cone.gen_dopt_batch(B, n, p, mixed_cone.DOPT_SEED)
    gen = time.perf_counter() - t0
    label = f"(a) D-optimal design {B} x {data['A'].shape[1]}x{data['A'].shape[2]} over {K}"
    solver, res, setup, solve, launches, cap = _solve_spectral(K, data, DOPT_DTYPE)
    statuses = [r["info"]["status"] for r in res]
    if statuses.count("solved") != B:
        raise AssertionError(f"{label}: {statuses.count('solved')}/{B} solved: {set(statuses)}")
    _spectral_launch_gates(label, launches, cap, True, False)
    rel, gap, over = _dopt_gates(label, V, res)
    pobj0 = res[0]["info"]["pobj"]

    # problem 0 alone, f64, through SCS
    data0 = {"A": sparse.csc_matrix(data["A"][0].astype(np.float64)), "b": data["b"][0],
             "c": data["c"][0]}
    _zero_counts(*SPECTRAL_KERNELS)
    t0 = time.perf_counter()
    one = scs_tpu_torch.solve(data0, K, device="cuda", dtype="float64", eps_abs=DOPT_EPS,
                              eps_rel=DOPT_EPS, max_iters=20000, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    info = one["info"]
    c4_one = cone_ops._proj_logdet_vec_batch.launches
    if info["status"] != "solved" or c4_one <= 0:
        raise AssertionError(f"{label} problem 0 in f64: {info['status']}, C4 launches {c4_one}")
    rel1, gap1, _ = _dopt_gates(f"{label} problem 0 in f64", V[:1], [one])
    diff = abs(info["pobj"] - pobj0)
    if not diff <= DOPT_POBJ_TOL * (1 + abs(info["pobj"])):
        raise AssertionError(f"{label} problem 0: pobj f64 {info['pobj']!r} against the batch's "
                             f"{pobj0!r}")

    # the host's checks of the batch and of problem 0 alone (last) at once
    t0 = time.perf_counter()
    both = {k: np.concatenate([v, v[:1]]) for k, v in data.items()}
    worst = mixed_cone.check_solutions(K, both, res + [one], DOPT_EPS, pool=pool,
                                       cone_every=DOPT_CONE_EVERY)
    _spectral_report(
        label, DOPT_DTYPE, res, setup, solve, launches, worst,
        f"; generated in {gen:.2f} s; worst |t - logdet X(lam)| / (1 + |t|) {rel:.3e} (limit "
        f"{DOPT_LOGDET_TOL:g}; {over} of {B} over 1e-3); Kiefer-Wolfowitz gap / n {gap:.3e} (limit "
        f"{DOPT_DELTA:g}); cone membership on every {DOPT_CONE_EVERY}th problem; the host's checks "
        f"{time.perf_counter() - t0:.1f} s")
    print(f"[15] (a) problem 0 alone through SCS, f64 on cuda: solved in {info['iter']} iterations, "
          f"{secs:.3f} s, C4 launches {c4_one}; pobj {info['pobj']:.8f} against the batch's "
          f"{pobj0:.8f} (|diff| {diff:.2e}); its residuals and cone distances checked with the "
          f"batch's (above); |t - logdet| {rel1:.2e}, Kiefer-Wolfowitz gap / n {gap1:.3e}")
    _profile_report(15, solver)
    return launches, cap


def _phase_spectral_planted(futures, pool):
    """Phase 15 (b): planted optima over both spectral cones, generated in
    the pool since the phase began; phase 9's gates. Returns as
    _phase_dopt."""
    K, B = mixed_cone.SPECTRAL_K, mixed_cone.SPECTRAL_B
    t0 = time.perf_counter()
    data, p_star, A_rows = mixed_cone.collect_mixed_batch(futures)
    wait = time.perf_counter() - t0
    _, m, n = data["A"].shape
    label = f"(b) planted spectral batch {B} x {m}x{n} over {K}"
    solver, res, setup, solve, launches, cap = _solve_spectral(K, data, SPECTRAL_DTYPE)
    _spectral_launch_gates(label, launches, cap, True, True)
    t0 = time.perf_counter()
    worst = _mixed_gates(label, K, data, p_star, solver, res, pool, A_rows,
                         cone_every=SPECTRAL_CONE_EVERY)
    err = np.abs(np.array([r["info"]["pobj"] for r in res]) - p_star)
    _spectral_report(label, SPECTRAL_DTYPE, res, setup, solve, launches, worst,
                     f"; max |pobj - p*| {err.max():.2e} (limit {MIXED_OBJ_TOL:g}); cone "
                     f"membership on every {SPECTRAL_CONE_EVERY}th problem; the "
                     f"generation's wait after (a) {wait:.2f} s; the host's checks "
                     f"{time.perf_counter() - t0:.1f} s")
    _profile_report(15, solver)
    return launches, cap


def phase_spectral():
    """Phase 15: spectral-cone solves on the card, (a) and (b); then phase
    3's checks of C4 and C5 (check_spectral_kernels) on the rows the two
    solves handed them early, in the middle and late, each in its solve's
    type. Returns the kernels' launches in (a) + (b)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    with ProcessPoolExecutor(
        SPECTRAL_WORKERS, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        futures = mixed_cone.gen_mixed_batch(
            mixed_cone.SPECTRAL_K, mixed_cone.SPECTRAL_B, mixed_cone.SPECTRAL_SEED, pool=pool)
        la, cap_a = _phase_dopt(pool)
        lb, cap_b = _phase_spectral_planted(futures, pool)
        print(f"[15] phase 15: {time.perf_counter() - t0:.1f} s, generation, solves, gates and "
              f"profiler windows")
        t0 = time.perf_counter()
        n_cases = 0
        for tag, cap, dtype in (("(a)", cap_a, DOPT_DTYPE), ("(b)", cap_b, SPECTRAL_DTYPE)):
            ld_in, sl_in = cap.spectral_inputs(tag)
            n_cases += len(ld_in) + len(sl_in)
            mixed_cone.check_spectral_kernels(
                HBM_BYTES_PER_S, PEAK_FLOPS, mixed_cone.sm_clock_hz(), logdet_cases=(),
                sl_cases=(), logdet_inputs=ld_in, sl_inputs=sl_in, pool=pool,
                dtypes=(getattr(torch, dtype),))
    print(f"[3] C4 and C5 on {n_cases} cases of rows phase 15 captured, each in its solve's "
          f"type, checked in {time.perf_counter() - t0:.1f} s")
    return {name: la[name] + lb[name] for name in la}


def _hi_kkt(A, P, b, c, res, tol):
    """Worst f64 KKT ratios (pri, dual) of a batch's points on the raw
    data, each residual over tol x (1 + the largest norm of its terms)."""
    worst = [0.0, 0.0]
    for i, r in enumerate(res):
        x, y, s = (np.asarray(r[k], np.float64) for k in ("x", "y", "s"))
        Ax, Px, Aty = A[i] @ x, P[i] @ x, A[i].T @ y
        pri = np.linalg.norm(Ax + s - b[i]) / (
            tol * (1 + max(np.linalg.norm(Ax), np.linalg.norm(b[i]))))
        dual = np.linalg.norm(Px + Aty + c[i]) / (
            tol * (1 + max(np.linalg.norm(Px), np.linalg.norm(Aty), np.linalg.norm(c[i]))))
        worst = [max(worst[0], pri), max(worst[1], dual)]
    return worst


def _hi_report(tag, res, p_star, secs):
    """(statuses, mean iterations, objective errors over 1 + |p*|) and the
    line's text."""
    statuses = [r["info"]["status"] for r in res]
    iters = np.array([r["info"]["iter"] for r in res])
    objs = np.array([r["info"]["pobj"] for r in res])
    rel = np.abs(objs - p_star) / (1 + np.abs(p_star))
    text = (f"{tag}: statuses {dict(Counter(statuses))}, "
            f"iterations mean {iters.mean():.1f} max {iters.max()}, solve {secs:.3f} s, "
            f"max |pobj - p*| / (1 + |p*|) {rel.max():.3e}")
    return statuses, rel, text


def phase_hi_acc():
    """The scs_tpu bench's hi_acc cell at its full size (see the module
    docstring, phase 11). Returns D1's launches {kernel: (a), ...} and the
    figures of the three parts."""
    t0 = time.perf_counter()
    A, P, b, c, p_star = gen_batch(HI_B, HI_M, HI_N, seed=HI_SEED, return_opt=True)
    data32 = {"A": A.astype(np.float32), "P": P.astype(np.float32), "b": b, "c": c}
    print(f"[11] hi_acc: {HI_B} QPs of {HI_M}x{HI_N} generated on the host in "
          f"{time.perf_counter() - t0:.1f} s (seed {HI_SEED}); nothing cut")
    cell = dict(device="cuda", verbose=False)
    out = {}

    # (a) eps 1e-4, then polish
    _zero_counts(df32.mv, df32.tv, gemv_rows, gemv_cols)
    t0 = time.perf_counter()
    sp = scs_tpu_torch.BatchedSCS(
        data32, {"l": HI_M}, dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iters=20000,
        batch_compact_interval=8, **cell,
    )
    res = sp.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    iters = np.array([r["info"]["iter"] for r in res])
    t0 = time.perf_counter()
    res, pmask = sp.polish(res)
    torch.cuda.synchronize()
    t_polish = time.perf_counter() - t0
    out["a"] = {"mv": df32.mv.launches, "tv": df32.tv.launches}
    counts = _d1_counts()
    setup = sum(sp.setup_breakdown.values())
    del sp
    pm = np.asarray(pmask)
    objs = np.array([r["info"]["pobj"] for r in res])
    rel = np.abs(objs - p_star) / (1 + np.abs(p_star))
    worst = _hi_kkt(A, P, b, c, res, 1e-5)
    rp_max = max(r["info"]["res_pri"] for r in res)
    rd_max = max(r["info"]["res_dual"] for r in res)
    print(
        f"[11] (a) f32 eps 1e-4 + polish: {int(pm.sum())}/{HI_B} certified; iterations mean "
        f"{iters.mean():.1f} max {iters.max()} (BENCH_r05 TPU v5e run, a count only: mean "
        f"{HI_TPU_MEAN_ITERS}); solve {t_solve:.3f} s (setup {setup:.3f} s of it, as the "
        f"bench counts), polish {t_polish:.3f} s (generation excluded); max |pobj - p*| / (1 + |p*|) {rel.max():.3e} "
        f"({int(-np.log10(max(rel.max(), 1e-300)))} significant digits); max res_pri {rp_max:.3e}, "
        f"res_dual {rd_max:.3e}; f64 KKT / (1e-5 x scale) worst pri {worst[0]:.3f}, dual "
        f"{worst[1]:.3f}; D1 launches {counts}"
    )
    if pm.sum() != HI_B or max(worst) > 1.0 or rel.max() > 1e-5:
        raise AssertionError(f"hi_acc (a): {int(pm.sum())}/{HI_B} certified, KKT {worst}, "
                             f"objective {rel.max():.3e}")
    if out["a"]["mv"] <= 0 or out["a"]["tv"] <= 0:
        raise AssertionError(f"hi_acc (a): polish launched D1 {out['a']}")
    out["a_secs"] = (t_solve, t_polish)

    # (b) the bench's iterative path: f32 at eps 1e-6, D1 on every iteration
    _zero_counts(df32.mv, df32.tv, gemv_rows, gemv_cols)
    t0 = time.perf_counter()
    sb = scs_tpu_torch.BatchedSCS(
        data32, {"l": HI_M}, dtype="float32", eps_abs=1e-6, eps_rel=1e-6,
        acceleration_lookback=5, max_iters=50000, **cell,
    )
    res_b = sb.solve()
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    out["b"] = {"mv": df32.mv.launches, "tv": df32.tv.launches}
    statuses, rel_b, text = _hi_report("[11] (b) f32 eps 1e-6 iterative", res_b, p_star, t_b)
    print(f"{text}; D1 launches {_d1_counts()}; G1/G2 launches {gemv_rows.launches}, "
          f"{gemv_cols.launches}")
    solved = np.array([st == "solved" for st in statuses])
    if not set(statuses) <= {"solved", "solved_inaccurate"} or (rel_b[solved] > 1e-5).any():
        raise AssertionError(f"hi_acc (b): statuses {statuses}, objective errors {rel_b}")
    if out["b"]["mv"] <= 0 or out["b"]["tv"] <= 0:
        raise AssertionError(f"hi_acc (b): the high-accuracy solve launched D1 {out['b']}")
    _profile_report(11, sb)
    del res_b, sb

    # (c) the same batch in plain f64 at eps 1e-6
    t0 = time.perf_counter()
    res_c = scs_tpu_torch.solve_batch(
        {"A": A, "P": P, "b": b, "c": c}, {"l": HI_M}, dtype="float64", eps_abs=1e-6,
        eps_rel=1e-6, max_iters=50000, **cell,
    )
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    statuses_c, _, text = _hi_report("[11] (c) f64 eps 1e-6", res_c, p_star, t_c)
    data_c = {k: torch.as_tensor(v, device="cuda") for k, v in (("A", A), ("P", P), ("b", b), ("c", c))}
    worst_c = kkt_check_batch(data_c, res_c, 1e-6)
    print(f"{text}; worst f64 KKT / limit: pri {worst_c[0]:.3f}, dual {worst_c[1]:.3f}, gap "
          f"{worst_c[2]:.3f}")
    if any(st != "solved" for st in statuses_c):
        raise AssertionError(f"hi_acc (c): statuses {statuses_c}")
    print(f"[11] (c) beside (a): f64 at eps 1e-6 {t_c:.3f} s to {HI_B}/{HI_B} solved; f32 at eps "
          f"1e-4 + polish {t_solve + t_polish:.3f} s to {int(pm.sum())}/{HI_B} certified")
    del data_c, res_c
    torch.cuda.empty_cache()
    return out


# Phase 12's kernels: every kernel the bench's path launches (C3, the box
# projection, is not on it: no cell has a box cone)
BENCH_KERNELS = {
    "bell_spmv": bell_spmv, "bell_spmv_batched": bell_spmv_batched,
    "gemv_rows": gemv_rows, "gemv_cols": gemv_cols,
    "proj_exp": cone_ops._proj_exp_batch, "proj_pow": cone_ops._proj_pow_batch,
    "df32.mv": df32.mv, "df32.tv": df32.tv,
}
BENCH_SUBMETRICS = ("bell", "mixed_cone", "hi_acc", "bell_batch")


def _run_bench(env):
    """bench_cli.main() in this process under `env` (every other BENCH_*
    variable unset), stdout and stderr captured. Returns (the one JSON
    line's object, stderr text, wall s); raises unless stdout is exactly
    one parseable line."""

    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            bench_cli.main()
    finally:
        for k in env:
            del os.environ[k]
        os.environ.update(saved)
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} stdout lines: {lines[:3]}")
    return json.loads(lines[0]), err.getvalue(), wall


def phase_bench(name_and_limit):
    """Phase 12: the port's bench CLI at its defaults on the card, then
    BENCH_BELL=1. Returns each bench kernel's launches in the default run."""
    _zero_counts(*BENCH_KERNELS.values(), cone_ops._proj_box)
    out, err, wall = _run_bench({"BENCH_DEVICE": "cuda"})
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in BENCH_KERNELS.items()}
    for ln in err.strip().splitlines():
        print(f"[12] stderr: {ln}")
    B = FLAG_B
    problems = []
    if not (out["n_solved"] == out["batch"] == B and out["amortized_n_solved"] == B):
        problems.append(f"flagship n_solved {out['n_solved']} / amortized "
                        f"{out['amortized_n_solved']} of batch {out['batch']}")
    if "float32" not in out["metric"]:
        problems.append(f"metric {out['metric']!r}: the f64 accuracy fallback was taken")
    for k in BENCH_SUBMETRICS:
        st = (out.get(k) or {}).get("status")
        if st != "solved":
            problems.append(f"{k} status {st!r}")
    if (out.get("hi_acc") or {}).get("n_certified") != HI_B:
        problems.append(f"hi_acc n_certified {(out.get('hi_acc') or {}).get('n_certified')}")
    if (out.get("mixed_cone") or {}).get("obj_3_decimal_parity") is not True:
        problems.append("mixed_cone obj_3_decimal_parity is not true")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        problems.append(f"kernels never launched by the bench: {idle}")
    if problems:
        raise AssertionError("phase 12: " + "; ".join(problems))
    sub = {k: out[k] for k in BENCH_SUBMETRICS}
    print(f"[12] bench (python -m scs_tpu_torch.bench_cli, defaults) on {name_and_limit}: "
          f"wall {wall:.1f} s; {out['metric']}: value {out['value']} {out['unit']}, "
          f"vs_baseline {out['vs_baseline']}, amortized {out['amortized_secs']} s, "
          f"e2e cold {out['e2e_cold_secs']} s (setup {out['setup_secs']} s + first solve "
          f"{out['first_solve_secs']} s), solve {out['solve_secs']} s ({out['solve_pps']} pps), "
          f"n_solved {out['n_solved']}/{out['batch']}, chunks {out['chunks']}, iterations mean "
          f"{out['mean_iters']} max {out['max_iters_seen']}, lockstep {out['lockstep_efficiency']}, "
          f"achieved {out['achieved_hbm_gbps']} GB/s ({out['hbm_utilization']}), device "
          f"{out['device_hbm_gbps']} GB/s ({out['device_hbm_utilization']}); setup_breakdown "
          f"{out['setup_breakdown']}")
    print(f"[12] sub-metrics: {json.dumps(sub)}")
    print(f"[12] bench kernel launches: {launches}; proj_box {cone_ops._proj_box.launches} "
          f"(no box cone on the bench's path)")

    bell, err, wall_b = _run_bench({"BENCH_DEVICE": "cuda", "BENCH_BELL": "1"})
    if bell["status"] != "solved" or not bell["cross_check_obj_gap"] < 1e-3:
        raise AssertionError(f"phase 12 BENCH_BELL=1: {bell}")
    print(f"[12] BENCH_BELL=1: wall {wall_b:.1f} s; {bell['metric']}: {bell['status']} in "
          f"{bell['iters']} iterations, solve {bell['solve_secs']} s, setup {bell['setup_secs']} s, "
          f"cross_check_obj_gap {bell['cross_check_obj_gap']:.3e}, vs_baseline "
          f"{bell['vs_baseline']}")
    return launches


def _instrumented_gates(label, info, path):
    """Phase 13's gates on one instrumented solve: solved, one CSV row per
    iteration with iter stepping by 1, measured timers under solve_time."""

    with open(path) as f:
        iters = [int(r["iter"]) for r in csv.DictReader(f)]
    total = info["lin_sys_time"] + info["cone_time"] + info["accel_time"]
    if info["status"] != "solved":
        raise AssertionError(f"[13] {label}: status {info['status']!r}")
    if iters != list(range(1, info["iter"] + 1)):
        raise AssertionError(f"[13] {label}: {len(iters)} CSV rows for {info['iter']} iterations")
    if not (info["lin_sys_time"] > 0 and info["cone_time"] > 0 and total < info["solve_time"]):
        raise AssertionError(f"[13] {label}: timers lin {info['lin_sys_time']}, cone "
                             f"{info['cone_time']}, accel {info['accel_time']}, solve "
                             f"{info['solve_time']}")
    return total


def phase_instrumented(name_and_limit):
    """Phase 13: phase_timing="always" on the card — the instrumented loop
    on phase 7's dense QP and phase 5's bell QP, the batched timers on the
    mixed_cone cell, and the auto/instrumented ratio of the timers."""

    dense, _ = gen_dense_qp(DENSE_QP_M, DENSE_QP_N)
    cases = (
        ("dense QP 300x200 f64 direct", dense, DENSE_QP_M, DENSE_QP_EPS,
         dict(solver_strategy="direct")),
        ("bell QP 3000x2000 f64", gen_bell_qp(QP_M, QP_N, 0.02), QP_M, QP_EPS,
         dict(solver_strategy="bell")),
    )
    with tempfile.TemporaryDirectory() as tmp:
        for label, data, m, eps, kw in cases:
            kw = dict(kw, dtype="float64", eps_abs=eps, eps_rel=eps, max_iters=20000,
                      verbose=False, device="cuda")
            path = os.path.join(tmp, "trace.csv")
            info = scs_tpu_torch.solve(data, {"l": m}, phase_timing="always",
                                       log_csv_filename=path, **kw)["info"]
            total = _instrumented_gates(label, info, path)
            auto = scs_tpu_torch.solve(data, {"l": m}, **kw)["info"]
            print(f"[13] {label} eps {eps:g}, phase_timing='always' on {name_and_limit}: "
                  f"{info['status']} in {info['iter']} iterations, {info['iter']} CSV rows; "
                  f"lin_sys {info['lin_sys_time']:.4f} s, cone {info['cone_time']:.4f} s, accel "
                  f"{info['accel_time']:.4f} s = {total / info['solve_time']:.3f} of solve "
                  f"{info['solve_time']:.3f} s; {1e3 * info['solve_time'] / info['iter']:.3f} ms "
                  f"an iteration instrumented against {1e3 * auto['solve_time'] / auto['iter']:.3f} "
                  f"pipelined ({auto['status']} in {auto['iter']} iterations)")

    K = mixed_cone.MIXED_K
    data, _ = mixed_cone.gen_mixed_batch(K, mixed_cone.MIXED_B, mixed_cone.MIXED_SEED)
    kw = dict(dtype="float32", eps_abs=mixed_cone.MIXED_EPS, eps_rel=mixed_cone.MIXED_EPS,
              max_iters=20000, scale=1.0, device="cuda")
    res_a = scs_tpu_torch.BatchedSCS(data, K, **kw).solve()
    solver = scs_tpu_torch.BatchedSCS(data, K, phase_timing="always", **kw)
    t0 = time.perf_counter()
    res = solver.solve()
    wall = time.perf_counter() - t0
    pt = solver.phase_times()
    it_a = [r["info"]["iter"] for r in res_a]
    it_w = [r["info"]["iter"] for r in res]
    if it_a != it_w:
        raise AssertionError(f"[13] mixed_cone 'always' iterations differ from 'auto': "
                             f"{sum(a != w for a, w in zip(it_a, it_w))} problems")
    if any(r["info"]["status"] != "solved" or not (r["info"]["lin_sys_time"] > 0
           and r["info"]["cone_time"] > 0 and r["info"]["accel_time"] > 0) for r in res):
        raise AssertionError("[13] mixed_cone 'always': a problem unsolved or with empty timers")
    B = len(res)
    print(f"[13] mixed_cone {B} problems, phase_timing='always': {B}/{B} solved with the "
          f"iteration counts of 'auto' (mean {np.mean(it_w):.1f}, max {max(it_w)}); phase_times "
          f"per batched call lin_sys {1e3 * pt['lin_sys']:.3f} ms, cone {1e3 * pt['cone']:.3f} ms, "
          f"accel_trial {1e3 * pt['accel_trial']:.3f} ms; solve {wall:.2f} s incl. phase_times; "
          f"summed per-problem timers {sum(r['info']['lin_sys_time'] + r['info']['cone_time'] + r['info']['accel_time'] for r in res):.3f} s")

    # tests/test_observability.py:159's QP (900 x 600, default dtype: f32 on
    # the card, eps 1e-5, so the high-accuracy mode): per-iteration lin_sys +
    # cone from the "auto" estimate against the instrumented measurement,
    # gated with the reference test's bands and its one retry
    data, m = timer_proto.qp_900x600()
    kw = dict(timer_proto.QP_KW, time_limit_secs=60, device="cuda")
    tries = []
    for lo, hi in ((0.8, 1.25), (0.7, 1.43)):
        r, inst, auto = timer_proto.ratio(data, m, **kw)
        tries.append(r)
        (li, ci), (la, ca) = timer_proto.per_iteration(inst), timer_proto.per_iteration(auto)
        print(f"[13] QP 900x600 (tests/test_observability.py:159) f32 eps 1e-5 on {name_and_limit}: "
              f"instrumented {inst['status']} in {inst['iter']} it, lin_sys {li:.4f} + cone "
              f"{ci:.4f} ms an iteration ({1e3 * inst['solve_time'] / max(inst['iter'], 1):.3f} ms "
              f"of wall); auto {auto['status']} in {auto['iter']} it, lin_sys {la:.4f} + cone "
              f"{ca:.4f} ms an iteration estimated "
              f"({1e3 * auto['solve_time'] / max(auto['iter'], 1):.3f} ms of wall)")
        if lo < r < hi:
            break
    print(f"[13] auto/instrumented {' then '.join(f'{r:.3f}' for r in tries)} (gate: 0.8-1.25, one "
          f"retry at 0.7-1.43)")
    if not (0.8 < tries[0] < 1.25 or (len(tries) == 2 and 0.7 < tries[1] < 1.43)):
        raise AssertionError(f"[13] the auto timers disagree with the instrumented loop: "
                             f"auto/instrumented {tries}")


# Phase 14: the sharded paths (scs_tpu_torch.parallel), each world spawned
# from this process with a time limit, so a deadlock fails the run
SHARDED_TIMEOUT = 600.0  # seconds a world may take, its spawn included


def _in_turns(fn):
    """fn() on every rank of the default group, one rank at a time: ranks
    that share a card must not time their kernels together."""
    dist = torch.distributed
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
        dist.barrier()
    return out


def _check_spmv_shape(shape, pack, gen):
    """K1 at one (nbr, w, bs, len(x)) shape, on `pack` (blocks, cols: a
    rank's own) or on a random pack of the shape, x random of its true
    length: within TOL * |A||x| of bell_spmv_ref on the same x, a bit-equal
    repeat; device ms from CUDA-graph replays beside the plain version's
    and the bound. No library call computes a block-ELL product."""
    nbr, w, bs, x_len = shape
    nbc = -(-x_len // bs)
    if pack is None:
        blocks = torch.randn((nbr, w, bs, bs), generator=gen, device="cuda") / (w * bs) ** 0.5
        cols = torch.randint(0, nbc, (nbr, w), generator=gen, device="cuda", dtype=torch.int32)
    else:
        blocks, cols = pack
    dtype = blocks.dtype
    x = torch.randn(x_len, generator=gen, device=blocks.device, dtype=dtype)
    x_pad = torch.nn.functional.pad(x, (0, max(int(cols.max()) + 1, nbc) * bs - x_len))
    y = bell_spmv(blocks, cols, x)
    y_again = bell_spmv(blocks, cols, x)
    err = (y - bell_spmv_ref(blocks, cols, x_pad)).abs()
    lim = TOL[dtype] * bell_spmv_ref(blocks.abs(), cols, x_pad.abs())
    if not bool(torch.all(err <= lim)):
        raise AssertionError(f"bell_spmv {shape}: kernel disagrees with plain version "
                             f"(excess {float((err - lim).max()):.3e})")
    if not torch.equal(y, y_again):
        raise AssertionError(f"bell_spmv {shape}: a repeated launch differs")
    bound = _spmv_bound((nbr, w, bs, bs), x_len, dtype)
    return dict(max_abs_err=float(err.max()), tol=f"{TOL[dtype]:g}*|A||x|",
                ms=time_graph_ms(lambda: bell_spmv(blocks, cols, x)),
                plain_ms=time_ms(lambda: bell_spmv_ref(blocks, cols, x_pad), inner=SPMV_INNER),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def _sharded_checks(own=None):
    """Phase 14's kernel checks, on a rank after its run's launch counts
    were read: every kernel the run launched, at every shape it launched it
    at (the wrappers' `.shapes`, listed before anything else launches),
    against its plain version on the same inputs — K1 and G1/G2 within
    TOL, D1 within COMP_REL of the f64 product — with a bit-equal repeat,
    device ms from CUDA-graph replays beside the plain version's, the bound
    and, for G1/G2, torch.bmm's. `own` maps (kernel, shape) to the rank's
    own operands there (its packs, its rows of A, P); other shapes get
    random ones. Every phase-14 path runs f32. Returns one record per
    (kernel, shape)."""
    f32, own = torch.float32, own or {}
    todo = [(name, shape, n)
            for name, f in (("bell_spmv", bell_spmv), ("gemv_rows", gemv_rows),
                            ("gemv_cols", gemv_cols), ("df32.mv", df32.mv), ("df32.tv", df32.tv))
            for shape, n in sorted(f.shapes.items())]
    gen = torch.Generator(device="cuda").manual_seed(14) if todo else None
    recs = []
    for name, shape, n in todo:
        mine = own.get((name, shape))
        if name == "bell_spmv":
            rec = _check_spmv_shape(shape, mine, gen)
        elif name.startswith("gemv_"):
            which = name[5:]
            r = gemv_proto.check_shape(shape, f32, (which,), gen, plain=True, M=mine)[which]
            bound = _gemv_bound(shape, shape[1] if which == "rows" else shape[2], f32)
            rec = dict(max_abs_err=r["max_abs_err"], tol=f"{gemv_proto.TOL[f32]:g}*|M||v|",
                       ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bound[0], bound_by=bound[1],
                       library_ms=r["bmm_ms"])
        else:
            which = "rows" if name == "df32.mv" else "cols"
            r = gemv_proto.check_comp(shape, (which,), gen)[which]
            rec = dict(max_abs_err=r["max_abs_err"], rel_err_vs_f64=r["rel_err"],
                       tol=f"{gemv_proto.COMP_REL:g} of the f64 product", ms=r["ms"],
                       plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                       library_ms=None)
        recs.append(dict(kernel=name, shape=list(shape), launches=n,
                         operands="the rank's own" if mine is not None else "random", **rec))
    return recs


def _print_checks(tag, checks_by_rank):
    """One line per rank, kernel and shape of _sharded_checks' records;
    returns them flat, each with its world and rank."""
    flat = []
    for rank, recs in enumerate(checks_by_rank):
        for c in recs:
            lib = "" if c["library_ms"] is None else f", torch.bmm {c['library_ms']:.4f} ms"
            print(f"{tag} rank {rank}: {c['kernel']} at {tuple(c['shape'])} ({c['operands']} "
                  f"operands, {c['launches']} launches in the run): max |err| "
                  f"{c['max_abs_err']:.3e} within {c['tol']}, repeat bit-equal; device "
                  f"{c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
                  f"{100 * c['bound_ms'] / c['ms']:.0f}%), plain {c['plain_ms']:.4f} ms{lib}")
            flat.append(dict(c, where=f"{tag[5:]} rank {rank}"))
    return flat


def _sharded_bell_rank(device):
    """One rank of phase 14 (a)/(b): ShardedSCS under "bell" on the bench's
    bell LP, K1's launches zeroed just before the solver is built and read
    just after the solve; the host f64 KKT check on this rank's answer."""
    from scs_tpu_torch.parallel import ShardedSCS, make_mesh  # noqa: PLC0415
    from scs_tpu_torch.parallel.mesh import rank_device  # noqa: PLC0415

    bench = gen_bell_lp(BELL_M, BELL_N, BELL_DENSITY)
    rank_device(device, torch.distributed.group.WORLD)  # this rank's card, before the mesh
    mesh = make_mesh(axis_name="rows")
    _zero_counts(bell_spmv, bell_spmv_batched, gemv_rows, gemv_cols)
    gather_list.calls = 0
    t0 = time.perf_counter()
    solver = ShardedSCS(
        bench, {"l": BELL_M}, mesh=mesh, solver_strategy="bell", bell_block_size=BELL_BS,
        eps_abs=BELL_EPS, eps_rel=BELL_EPS, max_iters=50000, verbose=False, device=device,
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    sol = solver.solve()
    torch.cuda.synchronize()
    info = sol["info"]
    out = dict(
        status=info["status"], iter=info["iter"], cg_iters=solver._last_state.cg_iters,
        pobj=info["pobj"], x=sol["x"], setup=setup, solve=info["solve_time"],
        launches=bell_spmv.launches, collectives=gather_list.calls,
        other=bell_spmv_batched.launches + gemv_rows.launches
        + gemv_cols.launches, dtype=solver.stg.dtype, device=str(solver.mats.bn.device),
        pack=tuple(solver.mats.bell.A_blocks.shape), pack_t=tuple(solver.mats.bell.At_blocks.shape),
        m_pad=solver.m,
    )
    if info["status"] == "solved":
        out["kkt"] = kkt_check(bench, sol, BELL_EPS)
    bell = solver.mats.bell
    m_loc = bell.A_blocks.shape[0] * bell.A_blocks.shape[-1]
    out["checks"] = _in_turns(lambda: _sharded_checks({
        ("bell_spmv", (*bell.A_blocks.shape[:3], solver.n)): (bell.A_blocks, bell.A_cols),
        ("bell_spmv", (*bell.At_blocks.shape[:3], m_loc)): (bell.At_blocks, bell.At_cols),
    }))
    return out


def phase_sharded_bell(world, backend, pobj_ref):
    """Phase 14 (a) (world 1, NCCL) and (b) (world 2, gloo, both ranks on
    cuda:0): solved on every rank in f32 with host f64 KKT within 5x the
    criterion, K1 carrying every product, pobj within 1e-3 of `pobj_ref`
    (relative), and at world 2 every rank's x bit-equal. Returns rank 0's
    record with every rank's launches."""
    device = "cuda" if backend == "nccl" else "cuda:0"
    t0 = time.perf_counter()
    res = spawn_world(world, _sharded_bell_rank, (device,), backend=backend,
                      timeout=SHARDED_TIMEOUT)
    wall = time.perf_counter() - t0
    tag = f"[14] sharded bell LP {BELL_M}x{BELL_N}, world {world} ({backend})"
    for r, rec in enumerate(res):
        if rec["status"] != "solved" or rec["dtype"] != "float32":
            raise AssertionError(f"{tag}: rank {r} {rec['status']} ({rec['dtype']}) after "
                                 f"{rec['iter']} iterations")
        if rec["launches"] <= 0 or rec["other"]:
            raise AssertionError(f"{tag}: rank {r} K1 launches {rec['launches']}, other "
                                 f"matvec kernels {rec['other']}")
        if pobj_ref is not None and abs(rec["pobj"] - pobj_ref) > 1e-3 * abs(pobj_ref):
            raise AssertionError(f"{tag}: rank {r} pobj {rec['pobj']} against {pobj_ref}")
        if not np.array_equal(rec["x"], res[0]["x"]):
            raise AssertionError(f"{tag}: rank {r}'s x differs from rank 0's")
    r0 = res[0]
    checks = _print_checks(tag, [r["checks"] for r in res])
    print(f"{tag} on {r0['device']}: {r0['status']} in {r0['iter']} iterations, "
          f"{r0['cg_iters']} CG iterations; K1 launches by rank {[r['launches'] for r in res]}, "
          f"{r0['collectives']} all_gathers a rank (setup and solve); "
          f"setup {r0['setup']:.3f} s, solve {r0['solve']:.3f} s, world wall {wall:.1f} s "
          f"(spawn included); rows padded to {r0['m_pad']}, local packs A {r0['pack']} A' "
          f"{r0['pack_t']}; pobj {r0['pobj']:.6e}"
          + ("" if pobj_ref is None else f" (against {pobj_ref:.6e}: "
             f"{abs(r0['pobj'] - pobj_ref) / abs(pobj_ref):.2e} relative)")
          + f"; host f64 KKT / limit: pri {r0['kkt'][0]:.3f}, dual {r0['kkt'][1]:.3f}, "
          f"gap {r0['kkt'][2]:.3f}" + ("; x bit-equal on every rank" if world > 1 else ""))
    return dict(r0, launches_by_rank=[r["launches"] for r in res], checks=checks)


def _sharded_dense_rank(A, P, b, c, device):
    """One rank of phase 14 (b)'s dense QP: ShardedSCS under "indirect",
    G1/G2 counted from just before the solver is built."""
    from scs_tpu_torch.parallel import ShardedSCS  # noqa: PLC0415

    _zero_counts(gemv_rows, gemv_cols, df32.mv, df32.tv, bell_spmv)
    gather_list.calls = 0
    t0 = time.perf_counter()
    solver = ShardedSCS(
        {"A": A, "P": P, "b": b, "c": c}, {"l": A.shape[0]}, allow_dense_input=True,
        eps_abs=1e-4, eps_rel=1e-4, dtype="float32", max_iters=50000, verbose=False,
        device=device,
    )
    sol = solver.solve()
    torch.cuda.synchronize()
    out = dict(status=sol["info"]["status"], iter=sol["info"]["iter"], pobj=sol["info"]["pobj"],
               x=sol["x"], secs=time.perf_counter() - t0, rows=tuple(solver.mats.A.shape),
               g1=gemv_rows.launches, g2=gemv_cols.launches, spmv=bell_spmv.launches,
               g1_shapes=dict(gemv_rows.shapes), collectives=gather_list.calls)
    A3, P3 = solver.mats.A[None], solver.mats.P[None]
    out["checks"] = _in_turns(lambda: _sharded_checks({
        ("gemv_rows", tuple(A3.shape)): A3, ("gemv_cols", tuple(A3.shape)): A3,
        ("gemv_rows", tuple(P3.shape)): P3,
    }))
    return out


def phase_sharded_dense(world):
    """Phase 14 (b), dense: the hi_acc cell's first QP (1500 x 1000, seed
    4321) over `world` gloo ranks on cuda:0, f32 eps 1e-4: solved, pobj
    within 1e-3 of the planted optimum (relative to 1 + |p*|), each rank
    holding its rows of A and launching G1 and G2."""
    A, P, b, c, p_star = gen_batch(HI_B, HI_M, HI_N, seed=HI_SEED, return_opt=True)
    args = (A[0], P[0], b[0], c[0], "cuda:0")
    del A, P, b, c
    t0 = time.perf_counter()
    res = spawn_world(world, _sharded_dense_rank, args, backend="gloo", timeout=SHARDED_TIMEOUT)
    wall = time.perf_counter() - t0
    tag = f"[14] sharded dense QP {HI_M}x{HI_N} (hi_acc cell's first), world {world} (gloo)"
    p0 = float(p_star[0])
    for r, rec in enumerate(res):
        if rec["status"] != "solved" or abs(rec["pobj"] - p0) > 1e-3 * (1 + abs(p0)):
            raise AssertionError(f"{tag}: rank {r} {rec['status']} pobj {rec['pobj']} (p* {p0})")
        if rec["g1"] <= 0 or rec["g2"] <= 0 or rec["spmv"] or rec["rows"][0] != HI_M // world:
            raise AssertionError(f"{tag}: rank {r} G1 {rec['g1']}, G2 {rec['g2']}, SpMV "
                                 f"{rec['spmv']}, local A {rec['rows']}")
        if not np.array_equal(rec["x"], res[0]["x"]):
            raise AssertionError(f"{tag}: rank {r}'s x differs from rank 0's")
    r0 = res[0]
    checks = _print_checks(tag, [r["checks"] for r in res])
    print(f"{tag}: {r0['status']} in {r0['iter']} iterations on every rank, pobj "
          f"{r0['pobj']:.6e} against p* {p0:.6e} ({abs(r0['pobj'] - p0) / (1 + abs(p0)):.2e}); "
          f"local A {r0['rows']}; G1 / G2 launches by rank {[(r['g1'], r['g2']) for r in res]}, "
          f"G1 by shape {r0['g1_shapes']}, {r0['collectives']} all_gathers a rank; setup + "
          f"solve {r0['secs']:.2f} s, world wall "
          f"{wall:.1f} s; x bit-equal on every rank")
    return dict(g1=[r["g1"] for r in res], g2=[r["g2"] for r in res], checks=checks)


def _dryrun_rank(device):
    """One rank of phase 14 (c): the dryrun's four legs, then the kernel
    checks at every shape the legs launched (random operands)."""
    res = dryrun.legs(device)
    res["checks"] = _in_turns(_sharded_checks)
    return res


def phase_sharded_dryrun():
    """Phase 14 (c): parallel/dryrun.py's four legs on the card, one NCCL
    rank: every leg terminal, D1 counted on leg 3 (f32 at eps 1e-5)."""
    t0 = time.perf_counter()
    (res,) = spawn_world(1, _dryrun_rank, ("cuda",), backend="nccl", timeout=SHARDED_TIMEOUT)
    wall = time.perf_counter() - t0
    d1 = res["dense"]["launches"]
    if not (d1.get("df32.mv", 0) > 0 and d1.get("df32.tv", 0) > 0):
        raise AssertionError(f"[14] dryrun leg 3: no D1 launch ({d1})")
    for leg in ("batch", "cg", "dense", "bell"):
        rec = res[leg]
        what = (f"statuses {rec['statuses']}" if leg == "batch" else
                f"{rec['iters']} CG iterations" if leg == "cg" else
                f"{rec['status']} in {rec['iters']} iterations")
        print(f"[14] dryrun leg {leg} on {res['device']} (one NCCL rank): {what}, "
              f"{rec['secs']:.2f} s, launches {rec['launches']}")
    print(f"[14] {dryrun.summary(res, 1)}; world wall {wall:.1f} s")
    res["checks"] = _print_checks("[14] dryrun legs, world 1 (nccl)", [res["checks"]])
    return res


def gen_status_lps(m, n, density, seed):
    """A solvable, an infeasible and an unbounded LP over the nonnegative
    cone, m x n, sparse, in numpy. Solvable: b = A x0 + s0 with s0 >= 0,
    c = -A'y0 with y0 >= 0 and y0 = 0 on the last two rows. Infeasible: its
    last two rows replaced by x_0 <= -1 and -x_0 <= -1 (y = e_m-2 + e_m-1
    certifies it: A'y = 0, b'y = -2); y0 still keeps its dual feasible, so
    that no certificate of unboundedness exists too. Unbounded: its last
    column made <= 0, b refitted to stay feasible, c random with c_n-1 =
    -1, so that x_n-1 -> inf stays feasible and c'x -> -inf."""
    rng = np.random.RandomState(seed)
    A = sparse.random(m, n, density, random_state=rng, data_rvs=rng.standard_normal).tocsc()
    x0, s0 = rng.standard_normal(n), np.abs(rng.standard_normal(m))
    c = -(A[: m - 2].T @ np.abs(rng.standard_normal(m - 2)))
    solvable = {"A": A, "b": A @ x0 + s0, "c": c}
    pair = sparse.csr_matrix(([1.0, -1.0], ([0, 1], [0, 0])), shape=(2, n))
    infeasible = {"A": sparse.vstack([A[: m - 2], pair]).tocsc(),
                  "b": np.r_[solvable["b"][: m - 2], -1.0, -1.0], "c": c}
    Au = A.tolil()
    Au[:, n - 1] = -np.abs(rng.standard_normal((m, 1))) / np.sqrt(m)
    Au = Au.tocsc()
    unbounded = {"A": Au, "b": Au @ x0 + s0, "c": np.r_[rng.standard_normal(n - 1), -1.0]}
    return solvable, infeasible, unbounded


def gen_status_qp(K, n, seed):
    """A QP over K (z + l + SOCs) with a planted feasible point: b = A x0 + s0
    with s0 in K, P positive definite (upper triangle; its 0.1 I makes the
    default scale fit it, so that its solves in f32 need no rescale), dense
    A. Returns the data and the generator, for the update's draws."""
    rng = np.random.RandomState(seed)
    m = K["z"] + K["l"] + sum(K["q"])
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    s0 = [np.zeros(K["z"]), np.abs(rng.standard_normal(K["l"]))]
    for q in K["q"]:
        v = rng.standard_normal(q - 1)
        s0.append(np.r_[np.linalg.norm(v) + abs(rng.standard_normal()), v])
    G = rng.standard_normal((n, n // 10))
    P = (0.1 / (n // 10)) * (G @ G.T) + 0.1 * np.eye(n)
    data = {"A": sparse.csc_matrix(A), "P": sparse.csc_matrix(np.triu(P)),
            "b": A @ rng.standard_normal(n) + np.concatenate(s0), "c": rng.standard_normal(n)}
    return data, rng


def _certificate(label, data, sol):
    """The certificate of an infeasible / unbounded LP over the nonnegative
    cone, in f64 on the host against the raw data; returns its residual."""
    A, b, c = data["A"], data["b"], data["c"]
    status = sol["info"]["status"]
    if status == "infeasible":
        y = np.asarray(sol["y"], np.float64)
        res, obj, cone, scale = np.linalg.norm(A.T @ y), b @ y, y.min(), np.linalg.norm(y)
    elif status == "unbounded":
        x, s = (np.asarray(sol[k], np.float64) for k in ("x", "s"))
        res, obj, cone, scale = np.linalg.norm(A @ x + s), c @ x, s.min(), np.linalg.norm(s)
    else:
        raise AssertionError(f"[16] {label}: status {status!r} after {sol['info']['iter']} it")
    lim = STATUS_CERT_TOL * max(scale, 1.0)
    if not (res <= STATUS_CERT_TOL and obj < 0 and cone >= -lim):
        raise AssertionError(f"[16] {label}: certificate residual {res:.3e}, objective {obj:.3e}, "
                             f"cone {cone:.3e} (limits {STATUS_CERT_TOL:g}, < 0, >= {-lim:.3e})")
    return res


def phase_status():
    """Phase 16: the status surface on the card, f32 (the default dtype on
    CUDA): certificates under each strategy, update and warm start, the
    time limit, a mixed batch (module docstring). Each gate raises; one
    line is printed."""
    t0 = time.perf_counter()
    words = []
    _, infeasible, unbounded = gen_status_lps(STATUS_M, STATUS_N, STATUS_DENSITY, STATUS_SEED)
    for strategy in ("direct", "indirect", "bell"):
        for label, data in (("infeasible", infeasible), ("unbounded", unbounded)):
            _zero_counts(gemv_rows, gemv_cols, bell_spmv)
            sol = scs_tpu_torch.solve(data, {"l": STATUS_M}, solver_strategy=strategy,
                                      eps_infeas=STATUS_EPS_INFEAS, verbose=False)
            if sol["info"]["status"] != label:
                raise AssertionError(f"[16] {label} LP under {strategy!r}: status "
                                     f"{sol['info']['status']!r}")
            res = _certificate(f"{label} LP under {strategy!r}", data, sol)
            need = (bell_spmv,) if strategy == "bell" else (gemv_rows, gemv_cols)
            if min(f.launches for f in need) <= 0:
                raise AssertionError(f"[16] {label} LP under {strategy!r} launched no "
                                     f"{[f.__name__ for f in need]}")
            words.append(f"{label}/{strategy} {sol['info']['iter']} it (cert {res:.1e})")

    data, rng = gen_status_qp(STATUS_QP_K, STATUS_QP_N, STATUS_SEED)
    kw = dict(verbose=False, check_interval=STATUS_QP_CHECK)
    solver = scs_tpu_torch.SCS(data, STATUS_QP_K, **kw)
    if solver.stg.dtype != "float32":
        raise AssertionError(f"[16] expected an f32 solve, got {solver.stg.dtype}")
    first = solver.solve()
    b2 = data["b"] + 0.01 * np.abs(rng.standard_normal(len(data["b"])))
    c2 = data["c"] + 0.01 * rng.standard_normal(len(data["c"]))
    fac = solver.core.factorizations
    solver.update(b=b2, c=c2)
    warm = solver.solve()
    cold = scs_tpu_torch.solve(dict(data, b=b2, c=c2), STATUS_QP_K, **kw)
    its = [r["info"]["iter"] for r in (first, warm, cold)]
    if [r["info"]["status"] for r in (first, warm, cold)] != ["solved"] * 3:
        raise AssertionError(f"[16] QP: first / warm / cold {first['info']['status']!r} / "
                             f"{warm['info']['status']!r} / {cold['info']['status']!r}")
    if not its[1] < its[2] or solver.core.factorizations != fac:
        raise AssertionError(f"[16] QP: the warm re-solve took {its[1]} it against a cold "
                             f"{its[2]}, factorizing {solver.core.factorizations - fac} times")
    words.append(f"QP solved in {its[0]} it, updated and warm {its[1]} it (cold {its[2]}), "
                 f"no factorization")

    t1 = time.perf_counter()
    part = scs_tpu_torch.solve(data, STATUS_QP_K, eps_abs=1e-9, eps_rel=1e-9, max_iters=10**8,
                               time_limit_secs=STATUS_LIMIT_S, verbose=False)
    secs = time.perf_counter() - t1
    m = data["A"].shape[0]
    shaped = all(part[k].shape == (n,) and np.isfinite(part[k]).all()
                 for k, n in (("x", STATUS_QP_N), ("y", m), ("s", m)))
    if part["info"]["status"] != "solved_inaccurate" or not shaped or not (
            0 < part["info"]["iter"] < 10**8 and secs < STATUS_LIMIT_S + 10):
        raise AssertionError(f"[16] time limit {STATUS_LIMIT_S} s: {part['info']['status']!r} "
                             f"after {part['info']['iter']} it in {secs:.2f} s, iterates finite "
                             f"and shaped {shaped}")
    words.append(f"time limit {STATUS_LIMIT_S} s: {part['info']['status']} after "
                 f"{part['info']['iter']} it in {secs:.2f} s")

    B, bad, mb, nb = 8, 3, STATUS_M // 4, STATUS_N // 4
    batch = [gen_status_lps(mb, nb, 4 * STATUS_DENSITY, STATUS_SEED + i)[1 if i == bad else 0]
             for i in range(B)]
    res = scs_tpu_torch.BatchedSCS(
        {"A": np.stack([p["A"].toarray() for p in batch]),
         "b": np.stack([p["b"] for p in batch]), "c": np.stack([p["c"] for p in batch])},
        {"l": mb}, eps_infeas=STATUS_EPS_INFEAS, verbose=False).solve()
    statuses = [r["info"]["status"] for r in res]
    want = ["infeasible" if i == bad else "solved" for i in range(B)]
    if statuses != want:
        raise AssertionError(f"[16] mixed batch: statuses {statuses}, want {want}")
    _certificate(f"mixed batch problem {bad}", batch[bad], res[bad])
    for i in range(B):
        if i != bad:
            kkt_check(batch[i], res[i], 1e-4)
    wall = time.perf_counter() - t0
    words.append(f"mixed batch of {B}: {statuses} in {[r['info']['iter'] for r in res]} it")
    print("[16] status surface, f32 on cuda: " + "; ".join(words) + f"; wall {wall:.1f} s")
    if wall > STATUS_WALL_S:
        raise AssertionError(f"[16] the phase took {wall:.1f} s, past its {STATUS_WALL_S} s")


def phase_sharded(pobj_ref):
    """Phase 14: (a) the bell LP at world 1 (NCCL), (b) at world 2 (gloo, one
    card) and the dense QP at world 2, (c) the dryrun's legs at world 1."""
    torch.cuda.empty_cache()
    a = phase_sharded_bell(1, "nccl", pobj_ref)
    b = phase_sharded_bell(2, "gloo", a["pobj"])
    dense = phase_sharded_dense(2)
    c = phase_sharded_dryrun()
    checks = a["checks"] + b["checks"] + dense["checks"] + c["checks"]
    return checks, {
        "bell_spmv": {"a_world1_nccl": a["launches_by_rank"], "b_world2_gloo": b["launches_by_rank"],
                      "c_dryrun_bell_qp": c["bell"]["launches"].get("bell_spmv", 0)},
        "gemv_rows": {"b_world2_dense": dense["g1"],
                      "c_dryrun": sum(c[k]["launches"].get("gemv_rows", 0) for k in ("batch", "cg", "dense"))},
        "gemv_cols": {"b_world2_dense": dense["g2"],
                      "c_dryrun": sum(c[k]["launches"].get("gemv_cols", 0) for k in ("batch", "cg", "dense"))},
        "df32.mv": {"c_dryrun_dense_lp": c["dense"]["launches"].get("df32.mv", 0)},
        "df32.tv": {"c_dryrun_dense_lp": c["dense"]["launches"].get("df32.tv", 0)},
    }


def nccl_same_card():
    """Two NCCL ranks asking for one card: rank_device must raise (or NCCL
    itself refuses them)."""
    from scs_tpu_torch.parallel.mesh import rank_device  # noqa: PLC0415

    rank_device("cuda:0", torch.distributed.group.WORLD)
    torch.distributed.barrier()


def main():
    t_start = time.perf_counter()
    name, name_and_limit = phase_device()
    if sys.argv[1:] == ["--bell-profile"]:
        phase_build()
        bell_profile(gen_bell_lp(BELL_M, BELL_N, BELL_DENSITY))
        return
    phase_build()
    bench = gen_bell_lp(BELL_M, BELL_N, BELL_DENSITY)
    qp = gen_bell_qp(QP_M, QP_N, 0.02)
    batch = gen_bell_batch(BATCH_B, BATCH_M, BATCH_N, BATCH_DENSITY, BATCH_WIDTH, BATCH_SEED)
    max_err, times, single_pack, shapes = phase_kernels(bench, qp)
    max_err_b, times_b, batch_shape = phase_kernels_batched(batch, single_pack)
    max_err_g, gemv_flag, _ = phase_kernels_dense(name_and_limit)
    max_err_d1, d1_recs = phase_kernels_comp(name_and_limit)
    cone_report, eigh_ms = phase_kernels_cones()
    spectral_report = phase_kernels_spectral()
    launches, pobj4 = phase_main(bench)
    phase_qp(qp)
    launches_b = phase_batch(batch)
    del bench, qp, batch
    phase_dense_single()
    d1_single = phase_hi_acc_single()
    launches_g1, launches_g2 = phase_flagship()
    cone_launches_9, cap_9 = phase_mixed_cone()
    cone_launches_10, cap_10 = phase_mixed_wide()
    phase_kernels_captured(("mixed_cone", cap_9), ("mixed_cone_wide", cap_10))
    d1_cell = phase_hi_acc()
    bench_launches = phase_bench(name_and_limit)
    phase_instrumented(name_and_limit)
    sharded_checks, sharded = phase_sharded(pobj4)
    spectral_launches = phase_spectral()
    phase_status()

    f32 = torch.float32
    spmv_src = "scs_tpu_torch/ops/csrc/bell_spmv.cu"
    gemv_src = "scs_tpu_torch/ops/csrc/gemv.cu"
    flag_A = (FLAG_B, FLAG_M, FLAG_N)
    hi_A = (HI_B, HI_M, HI_N)

    def entry(name, source, replaces, n_launches, err, ms, plain, bound, library, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library, **extra,
        }

    k1, k2 = times[("bench A", f32)], times[("wide (w ~ nbc) A", f32)]
    k3 = times_b[("bench A", f32)]
    # the block-ELL product has no single library call; its plain version
    # (one gather and one einsum, run as a library batched product) stands in
    kernels = [
        entry("bell_spmv", spmv_src, "scs_tpu/ops/sparse.py:79", launches, max_err,
              k1[0], k1[1], _spmv_bound(*shapes["bench A"], f32), k1[1],
              shape="bench A pack"),
        entry("bell_spmv (wide packs)", spmv_src, "scs_tpu/ops/sparse.py:59", launches,
              max_err, k2[0], k2[1], _spmv_bound(*shapes["wide (w ~ nbc) A"], f32), k2[1],
              shape="wide pack (w ~ nbc)",
              note="one CUDA kernel and one wrapper replace both TPU kernels: "
                   "the launches are the same count as bell_spmv's"),
        entry("bell_spmv_batched", spmv_src,
              "scs_tpu/ops/sparse.py:79 under jax.vmap (scs_tpu/batch.py:190)",
              launches_b, max_err_b, k3[0], k3[1], _spmv_bound(*batch_shape, f32), k3[1],
              shape="bell_batch A packs"),
        *(
            entry(f"gemv_{w}", gemv_src, replaces, n, max_err_g[w], gemv_flag[w]["ms"],
                  gemv_flag[w]["plain_ms"], _gemv_bound(flag_A, out_len, f32),
                  gemv_flag[w]["bmm_ms"], shape=f"A {flag_A} f32",
                  host_us=gemv_flag[w]["host_us"], library_host_us=gemv_flag[w]["bmm_host_us"],
                  note="device ms from CUDA-graph replays; launches: the flagship's solve; "
                       "library: torch.bmm, TF32 off")
            for w, replaces, n, out_len in (
                ("rows", "tools/gemv_proto.py:13", launches_g1, FLAG_M),
                ("cols", "tools/gemv_proto.py:100", launches_g2, FLAG_N),
            )
        ),
        *(
            entry(kname, "scs_tpu_torch/ops/csrc/cone_proj.cu", replaces, n10,
                  cone_report[kname]["max_abs_err"], cone_report[kname]["ms"],
                  cone_report[kname]["plain_ms"],
                  (cone_report[kname]["bound_ms"], cone_report[kname]["bound_by"]), None,
                  shape=cone_report[kname]["shape"] + " f32", launches_mixed_cone=n9,
                  bound_steps_ms=cone_report[kname]["bound_steps_ms"],
                  **{key: cone_report[kname][key]
                     for key in ("bound_fixed_ms", "cycles", "repeat_steps", "newton_steps")
                     if key in cone_report[kname]},
                  note="launches: the wide mixed-cone batch's solve (launches_mixed_cone: the "
                       "mixed_cone cell's). bound_ms: the plain algorithm's passes (proj_exp: "
                       "its solves at 40 Newton steps each; proj_pow: each row's steps to its "
                       "first repeat on the plain map, repeat_steps in all, cycles the rows "
                       "that end on a cycle; bound_fixed_ms at 40 steps a row); bound_steps_ms: "
                       "the Newton steps the kernel ran, its exits taken. No Pallas kernel "
                       "existed: XLA fused this fori_loop "
                       "into the solver's program; in eager PyTorch it would be one launch per "
                       "arithmetic line of every loop pass. No single PyTorch call computes it.")
            for kname, replaces, n9, n10 in zip(
                ("proj_exp", "proj_pow", "proj_box"),
                ("scs_tpu/ops/projections.py:289", "scs_tpu/ops/projections.py:403",
                 "scs_tpu/ops/projections.py:67"),
                cone_launches_9, cone_launches_10,
            )
        ),
        *(
            entry(f"df32.{fn} (D1 {w})", gemv_src, replaces,
                  d1_cell["a"][fn] + d1_cell["b"][fn], max_err_d1[w], rec["ms"], rec["plain_ms"],
                  (rec["bound_ms"], rec["bound_by"]), None, shape=f"hi_acc A {hi_A} f32",
                  rel_err_vs_f64=rec["rel_err"], gemv_ms_same_shape=rec["gemv_ms"],
                  launches_polish=d1_cell["a"][fn], launches_iterative=d1_cell["b"][fn],
                  launches_single_qp=single,
                  note="compensated f32 product (Dot2: p-stream by TwoSum, err = fma(a, b, -p)); "
                       "no Pallas kernel existed: XLA computed it from materialized split "
                       "temporaries. launches: phase 11 (a) polish + (b) iterative eps 1e-6; "
                       "max_abs_err: against the plain version, both within 5e-7 of the f64 "
                       "product per problem; no single PyTorch call computes a compensated "
                       "product")
            for fn, w, replaces, single in (
                ("mv", "rows", "scs_tpu/ops/df32.py:45", d1_single[0]),
                ("tv", "cols", "scs_tpu/ops/df32.py:51", d1_single[1]),
            )
            for rec in (d1_recs[("hi_acc A", w)],)
        ),
        *(
            entry(kname, "scs_tpu_torch/ops/csrc/spectral_proj.cu", replaces,
                  spectral_launches[wrapper], spectral_report[kname]["max_abs_err"],
                  spectral_report[kname]["ms"], spectral_report[kname]["plain_ms"],
                  (spectral_report[kname]["bound_ms"], spectral_report[kname]["bound_by"]), None,
                  shape=spectral_report[kname]["shape"] + " f32",
                  chain_ms=spectral_report[kname]["chain_ms"],
                  **{f"passes_{key}": spectral_report[kname][key]
                     for key in ("inner", "outer", "inner_max", "outer_max", "plain_inner",
                                 "plain_outer", "plain_inner_max", "plain_outer_max")},
                  note="launches: phase 15's two solves, (a) + (b). ms: device time from "
                       "CUDA-graph replays; plain_ms: one call of the plain version, CUDA events. "
                       "bound_ms: the roofline of the plain algorithm's work on these rows, the "
                       "larger of the bytes and the operations of the passes the rows need on "
                       "the plain map (passes_plain_*). chain_ms: the kernel's serial floor, its "
                       "longest row's inner passes (passes_inner_max) at its pass's dependent "
                       "operations. passes_*: the kernel's serial passes, in all and at most a "
                       "row. No Pallas kernel existed: XLA fused these fori_loops "
                       "into the solver's program. No single PyTorch call computes it.")
            for kname, wrapper, replaces in (
                ("proj_logdet_vec", "_proj_logdet_vec_batch", "scs_tpu/ops/projections.py:580"),
                ("proj_sl_vec", "_proj_sl_vec_batch", "scs_tpu/ops/projections.py:530"),
            )
        ),
    ]
    # each kernel's launches in phase 12's bench run, and on phase 14's
    # sharded paths (per world; 0 where the sharded paths do not run it)
    # with its checks there, at every shape it was launched at
    for k in kernels:
        base = k["name"].split(" (")[0]
        k["launches_bench"] = bench_launches.get(base, 0)
        k["launches_sharded"] = sharded.get(base, 0)
        k["sharded_checks"] = [
            {key: c[key] for key in ("where", "shape", "operands", "launches", "max_abs_err",
                                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for c in sharded_checks if c["kernel"] == base
        ]
    print(f"[end] whole run {time.perf_counter() - t_start:.1f} s of wall on {name_and_limit}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
