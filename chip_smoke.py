#!/usr/bin/env python3
"""On-card smoke run of scs_tpu_torch, the PyTorch/CUDA port of scs_tpu.

Run from the repository root on a machine with one NVIDIA GPU (written
for the H100, sm_90a):

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:

  1. the card: nvidia-smi's name and power limit, PyTorch's view, TF32 flags;
  2. build the CUDA kernels from the sources in this checkout (nvcc);
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and a few others, f32 and f64, with CUDA-event times;
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
     solved alone through SCS must agree.

Then one JSON line describing the kernels, and last the contract line
{"ok": true, "device": {...}}. With no CUDA device the script exits
nonzero before printing any result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from scipy import sparse

import scs_tpu_torch
from scs_tpu_torch.ops import _kernels
from scs_tpu_torch.ops.sparse import (
    bell_spmv,
    bell_spmv_batched,
    bell_spmv_batched_ref,
    bell_spmv_ref,
    pack_bell_host,
    pack_bell_sym_host,
    stack_bell_host,
)

# The scs_tpu bench's `bell` cell (scs_tpu/bench_cli.py:_bell_submetric).
BELL_M, BELL_N, BELL_DENSITY, BELL_BS, BELL_EPS = 30000, 20000, 0.002, 128, 1e-4
BELL_TPU_ITERS = 625  # BENCH_r05.json, TPU v5e, f32 — for reference only
QP_M, QP_N, QP_EPS = 3000, 2000, 1e-6
# The scs_tpu bench's `bell_batch` cell (scs_tpu/bench_cli.py:341-409).
BATCH_B, BATCH_M, BATCH_N, BATCH_DENSITY, BATCH_WIDTH = 8, 30720, 20480, 0.002, 6
BATCH_SEED, BATCH_EPS = 11, 1e-4
BATCH_TPU_MEAN_ITERS = 712.5  # BENCH_r05.json, TPU v5e, f32 — for reference only
# |y_kernel - y_plain| <= TOL * (|A| |x|) elementwise: the two sum in
# different orders, each within ~sqrt(width*bs) roundings of |A||x|
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def gen_bell_lp(m, n, density, bs=128, width=6, seed=7):
    """Block-structured sparse LP (network/assignment style): each bs-row
    block touches `width` random bs-column tiles. A copy of
    scs_tpu.bench_cli.gen_bell_lp (that module imports jax); a test
    keeps the two equal."""
    from scipy import sparse as sp

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


def gen_bell_batch(B, m, n, density, width=6, seed=11):
    """B sparse LPs sharing gen_bell_lp's block pattern, with per-problem
    values, b and c. A copy of the generator inside
    scs_tpu.bench_cli._bell_batch_submetric (which fixes seed=11; that
    module imports jax); a test keeps the two equal."""
    rng = np.random.RandomState(seed)
    pat = gen_bell_lp(m, n, density, width=width, seed=seed)["A"]
    As, bs_, cs = [], [], []
    for _ in range(B):
        Ai = pat.copy()
        Ai.data = rng.randn(Ai.nnz)
        Ai = (Ai + sparse.eye(m, n, format="csc")).tocsc()
        x0 = rng.randn(n)
        s = np.abs(rng.randn(m))
        y = np.abs(rng.randn(m))
        As.append(Ai)
        bs_.append(Ai @ x0 + s)
        cs.append(-(Ai.T @ y))
    return {"A": As, "b": np.stack(bs_), "c": np.stack(cs)}


def time_ms(fn, reps=20):
    """Median CUDA-event time of `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    return name


def phase_build():
    t0 = time.perf_counter()
    so = _kernels.build("bell_spmv")
    _kernels.load("bell_spmv")
    secs = time.perf_counter() - t0
    ptxas = " | ".join(
        ln.strip() for ln in _kernels.build_log.get("bell_spmv", "").splitlines()
        if "registers" in ln or "spill" in ln
    )
    print(f"[2] built {so} in {secs:.2f} s; ptxas: {ptxas or '(cached build)'}")


def _check_case(label, blocks_np, cols_np, dtype, rng, timed=False):
    """Kernel vs plain version on the card for one pack; returns
    (max_abs_err, kernel_ms, plain_ms)."""
    dev = torch.device("cuda")
    blocks = torch.as_tensor(blocks_np, dtype=dtype, device=dev)
    cols = torch.as_tensor(cols_np, device=dev)
    n_pad = (int(cols_np.max()) + 1) * blocks_np.shape[-1]
    n_pad = max(n_pad, blocks_np.shape[-1])
    x = torch.as_tensor(rng.randn(n_pad), dtype=dtype, device=dev)
    y_k = bell_spmv(blocks, cols, x)
    y_p = bell_spmv_ref(blocks, cols, x)
    bound = TOL[dtype] * bell_spmv_ref(blocks.abs(), cols, x.abs())
    torch.cuda.synchronize()
    err = (y_k - y_p).abs()
    if not bool(torch.all(err <= bound)):
        worst = float((err - bound).max())
        raise AssertionError(f"{label}: kernel disagrees with plain version (excess {worst:.3e})")
    k_ms = p_ms = None
    if timed:
        k_ms = time_ms(lambda: bell_spmv(blocks, cols, x))
        p_ms = time_ms(lambda: bell_spmv_ref(blocks, cols, x))
    nbr, width, bs, _ = blocks_np.shape
    t = f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms" if timed else ""
    print(
        f"[3] {label} {str(dtype)[6:]}: pack ({nbr}, {width}, {bs}, {bs}), "
        f"max |err| {float(err.max()):.3e} within {TOL[dtype]:g}*|A||x|{t}"
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
    cases = [
        ("bench A", A_blocks, A_cols, True),
        ("bench A^T", At_blocks, At_cols, True),
        ("QP P", P_blocks, P_cols, False),
        ("wide (w ~ nbc) A", *pack_bell_host(wide, 32, np.float64)[:2], False),
        ("ragged bs=16 A", *pack_bell_host(
            sparse.random(1000, 777, density=0.03, random_state=rng, format="csc"),
            16, np.float64)[:2], False),
        ("ragged bs=32 A^T", *pack_bell_host(
            sparse.random(1234, 999, density=0.03, random_state=rng, format="csc"),
            32, np.float64)[2:4], False),
    ]
    max_err, times = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for label, blocks_np, cols_np, timed in cases:
            err, k_ms, p_ms = _check_case(label, blocks_np, cols_np, dtype, rng, timed)
            max_err = max(max_err, err)
            if timed:
                times[(label, dtype)] = (k_ms, p_ms)
    return max_err, times, (A_blocks, A_cols)


def _check_batched_case(label, blocks_np, cols_np, dtype, rng, timed=False):
    """The batched kernel vs its plain version on the card for one stacked
    pack; returns (max_abs_err, kernel_ms, plain_ms)."""
    dev = torch.device("cuda")
    blocks = torch.as_tensor(blocks_np, dtype=dtype, device=dev)
    cols = torch.as_tensor(cols_np, device=dev)
    B, nbr, width, bs, _ = blocks_np.shape
    n_pad = max(int(cols_np.max()) + 1, 1) * bs
    x = torch.as_tensor(rng.randn(B, n_pad), dtype=dtype, device=dev)
    y_k = bell_spmv_batched(blocks, cols, x)
    y_p = bell_spmv_batched_ref(blocks, cols, x)
    bound = TOL[dtype] * bell_spmv_batched_ref(blocks.abs(), cols, x.abs())
    torch.cuda.synchronize()
    err = (y_k - y_p).abs()
    if not bool(torch.all(err <= bound)):
        worst = float((err - bound).max())
        raise AssertionError(f"{label}: batched kernel disagrees with plain version (excess {worst:.3e})")
    del bound
    k_ms = p_ms = None
    if timed:
        k_ms = time_ms(lambda: bell_spmv_batched(blocks, cols, x))
        p_ms = time_ms(lambda: bell_spmv_batched_ref(blocks, cols, x))
    gb = blocks.numel() * blocks.element_size() / 1e9
    t = f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({gb / k_ms * 1e3:.0f} GB/s)" if timed else ""
    print(
        f"[3] batched {label} {str(dtype)[6:]}: pack ({B}, {nbr}, {width}, {bs}, {bs}), "
        f"{gb:.3f} GB, max |err| {float(err.max()):.3e} within {TOL[dtype]:g}*|A||x|{t}"
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

    cases = [
        ("bench A", *bench_A, True),
        ("bench A^T", *bench_At, True),
        ("ragged bs=16 A, mixed widths", *ragged((1000, 777), 16, (0.0005, 0.001, 0.003, 0.01, 0.002), False), False),
        ("ragged bs=32 A^T, mixed widths", *ragged((1234, 999), 32, (0.003, 0.0005, 0.001), True), False),
    ]
    widths = [c[1].shape[2] for c in cases]
    max_err, times = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for label, blocks_np, cols_np, timed in cases:
            err, k_ms, p_ms = _check_batched_case(label, blocks_np, cols_np, dtype, rng, timed)
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
        x = torch.as_tensor(
            rng.randn((int(cols_np.max()) + 1) * blocks_np.shape[-1]), dtype=dtype, device=dev
        )
        y1 = bell_spmv(blocks, cols, x)
        yb = bell_spmv_batched(blocks[None], cols[None], x[None])[0]
        if not torch.equal(y1, yb):
            raise AssertionError(f"B=1 batched launch differs from bell_spmv ({dtype})")
    print(f"[3] batched B=1 launch equals bell_spmv bit for bit (f32, f64); padded widths {widths}")
    return max_err, times


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
    return launches


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


def main():
    name = phase_device()
    phase_build()
    bench = gen_bell_lp(BELL_M, BELL_N, BELL_DENSITY)
    qp = gen_bell_qp(QP_M, QP_N, 0.02)
    batch = gen_bell_batch(BATCH_B, BATCH_M, BATCH_N, BATCH_DENSITY, BATCH_WIDTH, BATCH_SEED)
    max_err, times, single_pack = phase_kernels(bench, qp)
    max_err_b, times_b = phase_kernels_batched(batch, single_pack)
    launches = phase_main(bench)
    phase_qp(qp)
    launches_b = phase_batch(batch)
    k_ms, p_ms = times[("bench A", torch.float32)]
    kb_ms, pb_ms = times_b[("bench A", torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "bell_spmv",
        "route": "cuda",
        "source": "scs_tpu_torch/ops/csrc/bell_spmv.cu",
        "replaces": "scs_tpu/ops/sparse.py:79",
        "also_replaces": "scs_tpu/ops/sparse.py:59",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "bell_spmv_batched",
        "route": "cuda",
        "source": "scs_tpu_torch/ops/csrc/bell_spmv.cu",
        "replaces": "scs_tpu/ops/sparse.py:79 under jax.vmap (scs_tpu/batch.py:190)",
        "launches": launches_b,
        "max_abs_err": max_err_b,
        "ms": kb_ms,
        "plain_ms": pb_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
