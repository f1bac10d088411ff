"""The flagship dense workload of the scs_tpu bench on the card: B dense
m x n QPs over the nonnegative cone (B 512, m 1500, n 1000, f32, eps 1e-4).

  * gen_batch         — scs_tpu.bench_cli.gen_batch itself, on the host in
                        numpy, bit for bit (the bench's `hi_acc` cell and the
                        polish tests run on it; minutes at B = 512);
  * gen_qp_batch      — the batch, generated on the solver's device from a
                        seeded torch.Generator by the construction of
                        scs_tpu.bench_cli.gen_batch (well-conditioned A, PSD
                        P, a planted primal-dual optimum and its objective
                        p*): the host recipe costs minutes at B = 512;
  * kkt_check_batch   — f64 KKT residuals of every problem against the raw
                        data, on the device, in sub-batches;
  * main              — solves the batch through BatchedSCS and prints where
                        the time goes from a torch.profiler window over a few
                        full-batch chunks (busy and idle share, time by
                        kernel):

    python -m scs_tpu_torch.tools.flagship [B m n]

Nothing runs on import.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = (512, 1500, 1000)


def gen_batch(B, m, n, seed=1234, dtype=np.float64, return_opt=False):
    """Dense random QP batch, feasible by construction (the scs_tpu bench's
    generator, scs_tpu/bench_cli.py:56-80, the same numbers from the same
    seed): A (B, m, n) = N(0, 1)/sqrt(m), P = 0.1/(n//8) G G' + 1e-4 I full,
    y = max(z, 0), s = y - z, c = -A'y - Px, b = Ax + s. Returns (A, P, b, c),
    and with return_opt=True also p* (B,), the planted optimal objectives
    (exact by the KKT construction, in f64)."""
    rng = np.random.RandomState(seed)
    A = (rng.standard_normal((B, m, n)) / np.sqrt(m)).astype(dtype)
    G = rng.standard_normal((B, n, n // 8)).astype(dtype)
    P = (0.1 / (n // 8)) * (G @ G.transpose(0, 2, 1))
    P += 1e-4 * np.eye(n, dtype=dtype)
    z = rng.standard_normal((B, m)).astype(dtype)
    y = np.maximum(z, 0)
    s = y - z
    x = rng.standard_normal((B, n)).astype(dtype)
    c = -(A.transpose(0, 2, 1) @ y[..., None])[..., 0] - (P @ x[..., None])[..., 0]
    b = (A @ x[..., None])[..., 0] + s
    if return_opt:
        Px = (P @ x[..., None])[..., 0]
        p_star = 0.5 * np.einsum("bn,bn->b", x, Px) + np.einsum("bn,bn->b", c, x)
        return A, P, b, c, p_star
    return A, P, b, c


def gen_qp_batch(B, m, n, seed=1234, device="cuda", dtype=torch.float32, sub=64):
    """(data, p_star, obj_scale): data = {"A": (B, m, n), "P": (B, n, n),
    "b": (B, m), "c": (B, n)} tensors on `device`; p_star (B,) float64 the
    planted optimal objectives 0.5 x'Px + c'x; obj_scale (B,) float64 the
    larger of |0.5 x'Px| and |c'x|, the size of the terms that cancel in p*
    (a solve at eps is accurate relative to these, not to their sum, which
    comes close to 0 for some problems). A = N(0, 1)/sqrt(m); P = 0.1/(n//8) G G' + 1e-4 I
    with G (n, n//8); y = max(z, 0), s = y - z for a normal z, a normal x;
    c = -A'y - Px, b = Ax + s, so (x, y, s) satisfies the KKT conditions.
    b, c and p* are computed in f64 from the stored A and P, `sub`
    problems at a time."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    A = normal(B, m, n) / m**0.5
    k = max(n // 8, 1)
    P = torch.empty((B, n, n), device=dev, dtype=dtype)
    b = torch.empty((B, m), device=dev, dtype=dtype)
    c = torch.empty((B, n), device=dev, dtype=dtype)
    p_star = torch.empty(B, device=dev, dtype=torch.float64)
    obj_scale = torch.empty(B, device=dev, dtype=torch.float64)
    for lo in range(0, B, sub):
        sl = slice(lo, min(lo + sub, B))
        nb = sl.stop - lo
        G = normal(nb, n, k).double()
        Pd = (0.1 / k) * (G @ G.mT)
        Pd.diagonal(dim1=1, dim2=2).add_(1e-4)
        P[sl] = Pd.to(dtype)
        Pd = P[sl].double()  # p* and c against the stored (rounded) P
        Ad = A[sl].double()
        z = normal(nb, m).double()
        y = z.clamp_min(0.0)
        s = y - z
        x = normal(nb, n).double()
        Px = (Pd @ x[:, :, None])[:, :, 0]
        cd = -(Ad.mT @ y[:, :, None])[:, :, 0] - Px
        c[sl] = cd.to(dtype)
        b[sl] = ((Ad @ x[:, :, None])[:, :, 0] + s).to(dtype)
        quad, lin = 0.5 * (x * Px).sum(1), (cd * x).sum(1)
        p_star[sl] = quad + lin
        obj_scale[sl] = torch.maximum(quad.abs(), lin.abs())
    return {"A": A, "P": P, "b": b, "c": c}, p_star, obj_scale


def kkt_check_batch(data, results, eps, margin=5.0, sub=64):
    """f64 KKT residuals of an LP/QP batch over the nonnegative cone against
    the raw data, each within margin x the solver's own criterion (the
    single-problem check of chip_smoke.kkt_check, batched on the data's
    device). P is the full symmetric matrix. Returns the worst ratios
    (pri, dual, gap) over the batch; raises on a violation."""
    A, P = data["A"], data.get("P")
    dev = A.device
    B = A.shape[0]

    X, Y, S = (
        torch.as_tensor(np.stack([r[k] for r in results]), dtype=torch.float64, device=dev)
        for k in ("x", "y", "s")
    )
    nrm = lambda v: torch.linalg.vector_norm(v, dim=1)  # noqa: E731
    worst = torch.zeros(3, dtype=torch.float64, device=dev)
    for lo in range(0, B, sub):
        sl = slice(lo, min(lo + sub, B))
        Ad = A[sl].double()
        x, y, s = X[sl], Y[sl], S[sl]
        bd, cd = data["b"][sl].double(), data["c"][sl].double()
        Px = torch.zeros_like(x)
        if P is not None:
            Px = (P[sl].double() @ x[:, :, None])[:, :, 0]
        Ax = (Ad @ x[:, :, None])[:, :, 0]
        Aty = (Ad.mT @ y[:, :, None])[:, :, 0]
        xPx, ctx, bty = (x * Px).sum(1), (cd * x).sum(1), (bd * y).sum(1)
        pri = nrm(Ax + s - bd)
        dual = nrm(Px + Aty + cd)
        gap = (xPx + ctx + bty).abs()
        mx = torch.maximum
        lim_p = eps + eps * mx(mx(nrm(Ax), nrm(s)), nrm(bd))
        lim_d = eps + eps * mx(mx(nrm(Px), nrm(Aty)), nrm(cd))
        lim_g = eps + eps * mx(mx(xPx.abs(), ctx.abs()), bty.abs())
        cone = torch.minimum(s.amin(1), y.amin(1)) / mx(
            mx(nrm(s), nrm(y)), torch.ones_like(pri)
        )
        ratios = torch.stack([pri / lim_p, dual / lim_d, gap / lim_g])
        bad = (ratios > margin).any(0) | (cone < -margin * eps)
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"KKT check failed for problem {lo + i}: pri/lim "
                f"{float(ratios[0, i]):.3e}, dual/lim {float(ratios[1, i]):.3e}, "
                f"gap/lim {float(ratios[2, i]):.3e}, cone {float(cone[i]):.3e}"
            )
        worst = torch.maximum(worst, ratios.amax(1))
    return tuple(float(w) for w in worst)


def profile_window(solver, chunks=2, warmup=2):
    """torch.profiler over `chunks` full-batch chunks of `solver` (a fresh
    BatchedSCS) after `warmup` chunks: returns (unprofiled_ms, profiled_ms,
    busy_ms, n_kernels, [(kernel name, ms, launches)] by device time). The
    unprofiled time is the same number of chunks, run just before."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    core, mats = solver.core, solver.mats
    state = solver._states
    max_iters = int(solver.stg.max_iters)

    def run(state, k):
        for _ in range(k):
            state = core.masked_chunk(state, mats, max_iters)
        torch.cuda.synchronize()
        return state

    state = run(state, warmup)
    t0 = time.perf_counter()
    state = run(state, chunks)
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, chunks)
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return plain_ms, prof_ms, busy, sum(r[2] for r in rows), rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    B, m, n = (int(a) for a in argv) if argv else FLAGSHIP
    if not torch.cuda.is_available():
        sys.exit("flagship: PyTorch sees no CUDA device; this runs only on the card")
    from .. import BatchedSCS  # noqa: PLC0415
    from ..ops.dense import gemv_cols, gemv_rows  # noqa: PLC0415

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    from ..ops import _kernels  # noqa: PLC0415

    _kernels.build_all()  # keep nvcc out of the setup times below
    data, p_star, obj_scale = gen_qp_batch(B, m, n)
    kw = dict(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iters=20000, device="cuda")
    solver = BatchedSCS(data, {"l": m}, **kw)
    print("setup", {k: round(v, 3) for k, v in solver.setup_breakdown.items()})
    chunk_iters = int(solver.stg.check_interval)
    plain_ms, prof_ms, busy, n_kernels, rows = profile_window(solver)
    print(
        f"window: 2 chunks = {2 * chunk_iters} lockstep iterations at B = {B}: "
        f"{plain_ms:.1f} ms unprofiled, {prof_ms:.1f} ms profiled; {n_kernels} "
        f"kernels, busy {busy:.1f} ms = {100 * busy / plain_ms:.1f}% of the "
        f"unprofiled wall (idle {100 - 100 * busy / plain_ms:.1f}%)"
    )
    for name, ms, count in rows[:12]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<6d} {name[:90]}")
    gemv_ms = sum(ms for name, ms, _ in rows if "gemv_" in name)
    print(f"gemv kernels: {gemv_ms:.1f} ms = {100 * gemv_ms / busy:.1f}% of busy")
    gemv_rows.launches = gemv_cols.launches = 0
    solver.reset()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    iters = [r["info"]["iter"] for r in res]
    solved = sum(r["info"]["status"] == "solved" for r in res)
    print(
        f"solve: {solved}/{B} solved in {secs:.3f} s; iterations mean "
        f"{sum(iters) / B:.1f}, max {max(iters)}; device_prob_iters "
        f"{solver.device_prob_iters}; ladder {solver.bucket_ladder}; launches "
        f"gemv_rows {gemv_rows.launches}, gemv_cols {gemv_cols.launches}"
    )
    err = (torch.as_tensor([r["info"]["pobj"] for r in res]) - p_star.cpu()).abs()
    print(
        f"objective: max |pobj - p*| {float(err.max()):.3e}; over the largest "
        f"term {float((err / obj_scale.cpu()).max()):.3e}; over 1 + |p*| "
        f"{float((err / (1 + p_star.cpu().abs())).max()):.3e}"
    )
    print("worst KKT / limit (pri, dual, gap):", kkt_check_batch(data, res, 1e-4))


if __name__ == "__main__":
    main()
