"""The workloads that chip_smoke.py and tools/dtype_proto.py share: their
sizes and seeds, the problem generators that do not live in bench_cli.py
or tools/flagship.py, and the host f64 checks of a solution and of a
certificate. Numpy and scipy only; nothing runs on import.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse

# The scs_tpu bench's `bell` cell (scs_tpu/bench_cli.py:_bell_submetric).
BELL_M, BELL_N, BELL_DENSITY, BELL_BS, BELL_EPS = 30000, 20000, 0.002, 128, 1e-4
# The scs_tpu bench's `bell_batch` cell (scs_tpu/bench_cli.py:341-409).
BATCH_B, BATCH_M, BATCH_N, BATCH_DENSITY, BATCH_WIDTH = 8, 30720, 20480, 0.002, 6
BATCH_SEED, BATCH_EPS = 11, 1e-4
DENSE_QP_M, DENSE_QP_N, DENSE_QP_EPS = 300, 200, 1e-6
# The scs_tpu bench's `hi_acc` cell (scs_tpu/bench_cli.py:235-338); its A
# width is also the single high-accuracy QP's of chip_smoke.py's phase 7
HI_B, HI_M, HI_N, HI_SEED = 32, 1500, 1000, 4321
# The wide mixed-cone batch's seed (tools/mixed_cone.py's generator)
WIDE_SEED = 4000
# The status LPs' size (sparse, density STATUS_DENSITY, so that "bell"
# packs them) and seed
STATUS_M, STATUS_N, STATUS_DENSITY, STATUS_SEED = 1200, 800, 0.05, 1600


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


def certificate(data, sol):
    """The certificate of an infeasible / unbounded LP over the nonnegative
    cone (its status "infeasible*" / "unbounded*"), in f64 on the host
    against the raw data, as the solver normalizes it (b'y = -1, c'x = -1):
    (residual, objective, least entry, norm) of (||A'y||, b'y, y, y) or
    (||Ax + s||, c'x, s, s); None for another status."""
    A, b, c = data["A"], data["b"], data["c"]
    status = sol["info"]["status"]
    if status.startswith("infeasible"):
        y = np.asarray(sol["y"], np.float64)
        return np.linalg.norm(A.T @ y), b @ y, y.min(), np.linalg.norm(y)
    if status.startswith("unbounded"):
        x, s = (np.asarray(sol[k], np.float64) for k in ("x", "s"))
        return np.linalg.norm(A @ x + s), c @ x, s.min(), np.linalg.norm(s)
    return None


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
