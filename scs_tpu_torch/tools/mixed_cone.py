"""Mixed-cone batches and the cone-projection kernels' checks.

What chip_smoke.py's cone phases and the tests share:

  * MIXED_K, wide_cone(): the cones of the two mixed-cone batches — the
    scs_tpu bench's `mixed_cone` cell (scs_tpu/bench_cli.py:412-509) and a
    wider one with thousands of exponential and power cones per problem;
  * gen_mixed_batch(): planted-optimum problems from tests/oracle.py (numpy
    and scipy only), c scaled to unit norm as the bench does; in worker
    processes when asked, one seed per problem;
  * check_solutions(): host f64 residuals against the solver's criterion
    and cone membership of s and y by the oracle's own projections;
  * exp_rows(), pow_rows(), box_case(): seeded numpy inputs that hit every
    regime of the three scalar-iteration projections;
  * geometry_*(): the variational test of a projection p of v in f64 — p in
    K, p - v in K*, <p, p - v> = 0 — with the oracle's membership functions;
  * check_cone_kernels(), check_plain_on_card(): each kernel of
    csrc/cone_proj.cu against its plain version on the card, and each plain
    projection on the card against the CPU.

    python -m scs_tpu_torch.tools.mixed_cone [B]

builds the kernels, runs the kernel checks and solves the bench's cell (B
problems, default 64) on the card, printing iterations and times.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The scs_tpu bench's `mixed_cone` cell: B = 64 problems over this cone, f32,
# eps 1e-4, n = m // 3, density 0.1, RandomState(3000).
MIXED_K = {
    "z": 10, "l": 15, "q": [5, 10, 0, 1], "s": [3, 4, 0, 0, 1, 10],
    "ep": 10, "ed": 10, "p": [-0.25, 0.5, 0.75, -0.33],
}
MIXED_B, MIXED_SEED, MIXED_EPS = 64, 3000, 1e-4
WIDE_B = 128
# The spectral-cone batches of chip_smoke.py's phase 15: (a) D-optimal
# experiment design (Boyd & Vandenberghe, Convex Optimization, 7.5), B
# problems of n parameters and p candidate measurement vectors, solved in
# f64 (in f32, scs_tpu and the port reach eps 1e-4 on few of them within
# 20,000 iterations); (b) planted optima over both spectral cones, m = 840,
# n = m // 3, f32.
DOPT_B, DOPT_N, DOPT_P, DOPT_SEED = 64, 32, 256, 5150
SPECTRAL_K = {"z": 4, "l": 32, "sl_n": [32, 16], "sl_k": [4, 3], "d": [16]}
SPECTRAL_B, SPECTRAL_SEED = 64, 6000


def wide_cone(seed=7, bounds=400, ep=200, ed=100, powers=100):
    """The wide batch's cone: 100 equalities, 500 inequalities, a box of
    `bounds` bounds (a fifth of each side infinite), 20 second-order cones
    of 50, four 32 x 32 PSD blocks, `ep` + `ed` exponential cones and
    `powers` power cones with powers drawn from (-0.9, 0.9)."""
    rng = np.random.RandomState(seed)
    bu = np.where(rng.rand(bounds) < 0.2, np.inf, 0.5 + rng.rand(bounds))
    bl = np.where(rng.rand(bounds) < 0.2, -np.inf, -0.5 - rng.rand(bounds))
    p = rng.uniform(0.1, 0.9, powers) * np.where(rng.rand(powers) < 0.5, -1.0, 1.0)
    return {
        "z": 100, "l": 500, "bu": bu.tolist(), "bl": bl.tolist(), "q": [50] * 20,
        "s": [32] * 4, "ep": ep, "ed": ed, "p": p.tolist(),
    }


def dopt_cone(n, p):
    """The cone of a D-optimal design's SCS form: Sum(lam) = 1, lam >= 0,
    and one logdet cone of an n x n matrix."""
    return {"z": 1, "l": p, "d": [n]}


def dopt_problem(V):
    """D-optimal experiment design over the candidates V (p, n): maximize
    logdet(sum_i lam_i v_i v_i') subject to 1'lam = 1, lam >= 0, in SCS form
    over x = (lam, t) with c = -e_t, rows in dopt_cone's order: the zero
    row Sum(lam) = 1; s = lam >= 0; the logdet cone's (s_t, s_v, s_X) =
    (t, 1, pack(sum_i lam_i v_i v_i')), packed as tests/oracle.py's
    _pack_sym packs (lower triangle by columns, sqrt(2) off the diagonal).
    Returns {"A": dense (m, p + 1), "b", "c"}, float64."""
    p, n = V.shape
    r, c = np.triu_indices(n)  # (j, i) of the packed entry (i, j), i >= j
    scale = np.where(r == c, 1.0, np.sqrt(2.0))
    packed = V[:, r] * V[:, c] * scale  # (p, n(n+1)/2): pack(v_i v_i') by rows
    m = 1 + p + 2 + len(r)
    A = np.zeros((m, p + 1))
    b = np.zeros(m)
    A[0, :p], b[0] = 1.0, 1.0
    A[1 : 1 + p, :p] = -np.eye(p)
    A[1 + p, p] = -1.0  # s_t = t
    b[2 + p] = 1.0  # s_v = 1
    A[3 + p :, :p] = -packed.T
    cvec = np.zeros(p + 1)
    cvec[p] = -1.0
    return {"A": A, "b": b, "c": cvec}


def gen_dopt_batch(B, n, p, seed):
    """B D-optimal design problems, problem i over p candidates drawn
    N(0, I_n) from RandomState(seed + i): (data {"A": float32 (B, m, p + 1),
    "b", "c" float64}, V (B, p, n))."""
    V = np.stack([np.random.RandomState(seed + i).randn(p, n) for i in range(B)])
    probs = [dopt_problem(Vi) for Vi in V]
    data = {"A": np.stack([d["A"] for d in probs]).astype(np.float32),
            "b": np.stack([d["b"] for d in probs]), "c": np.stack([d["c"] for d in probs])}
    return data, V


def kiefer_wolfowitz_gap(V, lam):
    """max_i v_i' X^-1 v_i - n at X = sum_i lam_i v_i v_i', lam clipped at 0
    and renormalized: by the Kiefer-Wolfowitz theorem an upper bound of
    logdet X* - logdet X(lam), 0 at the optimal design."""
    lam = np.clip(np.asarray(lam, np.float64), 0.0, None)
    lam = lam / lam.sum()
    X = V.T @ (lam[:, None] * V)
    return float(np.max(np.einsum("ij,ij->i", V @ np.linalg.inv(X), V)) - V.shape[1])


def dopt_check(V, x):
    """The design gates' numbers of a solution x = (lam, t), in f64:
    |t - logdet X(lam)| / (1 + |t|) (inf where X(lam) is not positive
    definite) and the Kiefer-Wolfowitz gap over n."""
    p, n = V.shape
    x = np.asarray(x, np.float64)
    lam, t = x[:p], x[p]
    sign, logdet = np.linalg.slogdet(V.T @ (lam[:, None] * V))
    rel = abs(t - logdet) / (1 + abs(t)) if sign > 0 else np.inf
    return rel, kiefer_wolfowitz_gap(V, lam) / n


def _oracle():
    """tests/oracle.py of this checkout: the independent numpy oracle
    (generators, projections and membership tests for every cone)."""
    tests_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "tests"
    )
    if tests_dir not in sys.path:
        sys.path.append(tests_dir)
    import oracle  # noqa: PLC0415

    return oracle


def _gen_one(args):
    """One planted-optimum problem (worker-process entry point)."""
    K, n, density, seed = args
    oracle = _oracle()
    with np.errstate(over="ignore"):
        data, p_star, _ = oracle.gen_feasible(
            K, n=n, density=density, rng=np.random.RandomState(seed)
        )
    k = np.linalg.norm(data["c"])
    return data["A"].astype(np.float32), data["b"], data["c"] / k, p_star / k


def gen_mixed_batch(K, B, seed, density=0.1, pool=None):
    """B planted-optimum problems over K with n = m // 3 and unit-norm c.
    Without a pool: one RandomState(seed) drawn from problem after problem,
    as scs_tpu's bench does. With a pool (a concurrent.futures executor):
    problem i from RandomState(seed + i), generated in the workers; returns
    the futures' list for collect_mixed_batch()."""
    oracle = _oracle()
    m = oracle.cone_dims(K)
    n = m // 3
    if pool is not None:
        return [pool.submit(_gen_one, (K, n, density, seed + i)) for i in range(B)]
    rng = np.random.RandomState(seed)
    As, bs, cs, stars = [], [], [], []
    for _ in range(B):
        with np.errstate(over="ignore"):
            data, p_star, _ = oracle.gen_feasible(K, n=n, density=density, rng=rng)
        k = np.linalg.norm(data["c"])
        As.append(np.asarray(data["A"].todense()))
        bs.append(data["b"])
        cs.append(data["c"] / k)
        stars.append(p_star / k)
    return {"A": np.stack(As), "b": np.stack(bs), "c": np.stack(cs)}, np.array(stars)


def collect_mixed_batch(futures):
    """The batch of gen_mixed_batch(pool=...): A as one float32 (B, m, n)
    array (the solver's type; a float64 copy would double the host's
    memory), b, c in float64, the planted objectives, and the problems'
    sparse float32 matrices (for check_solutions)."""
    first = futures[0].result()
    A = np.empty((len(futures),) + first[0].shape, np.float32)
    bs, cs, stars, A_rows = [], [], [], []
    for i, fut in enumerate(futures):
        Ai, b, c, p_star = fut.result()
        A[i] = Ai.toarray()
        A_rows.append(Ai)
        bs.append(b)
        cs.append(c)
        stars.append(p_star)
    return {"A": A, "b": np.stack(bs), "c": np.stack(cs)}, np.array(stars), A_rows


def _check_one(args):
    """Host f64 check of one solution (worker-process entry point): the
    residuals over the solver's criterion (pri, dual, gap), and, unless the
    job says otherwise, the distance of s from K and of y from K*, by the
    oracle's projections, relative to 1 + the vector's norm (0 when not
    checked)."""
    K, A, b, c, x, y, s, eps, cones = (*args, True)[:9]
    oracle = _oracle()
    A = np.asarray(A, np.float64) if isinstance(A, np.ndarray) else A.astype(np.float64)
    x, y, s = (np.asarray(v, np.float64) for v in (x, y, s))
    Ax, Aty = A @ x, A.T @ y
    nrm = np.linalg.norm
    pri = nrm(Ax + s - b) / (eps + eps * max(nrm(Ax), nrm(s), nrm(b)))
    dual = nrm(Aty + c) / (eps + eps * max(nrm(Aty), nrm(c)))
    gap = abs(c @ x + b @ y) / (eps + eps * max(abs(c @ x), abs(b @ y)))
    if not cones:
        return pri, dual, gap, 0.0, 0.0
    with np.errstate(over="ignore"):
        ds = nrm(s - oracle.proj_cone(s, K)) / (1 + nrm(s))
        dy = nrm(y - oracle.proj_dual_cone(y, K)) / (1 + nrm(y))
    return pri, dual, gap, ds, dy


def _check_jobs(K, data, results, eps, A_rows, cone_every):
    A_rows = data["A"] if A_rows is None else A_rows
    return [
        (K, A_rows[i], data["b"][i], data["c"][i], r["x"], r["y"], r["s"], eps,
         i % cone_every == 0)
        for i, r in enumerate(results)
    ]


def check_solutions(K, data, results, eps, margin=5.0, pool=None, A_rows=None, cone_margin=50.0,
                    cone_every=1):
    """Every solution's f64 residuals within margin x the solver's criterion,
    s within cone_margin x eps of K and y of K* (relative, by the oracle's
    projections; the returned s and y are iterates converged to eps, so
    they sit in the cones to a multiple of eps and not to rounding: the PSD
    blocks of scs_tpu's own f32 solutions of the mixed_cone cell are 2e-4
    off at eps 1e-4, those of the wide batch 1e-3). A_rows: the problems' matrices one by one (sparse, to
    hand to a pool's workers), default the rows of data["A"]. cone_every:
    cone membership on every cone_every-th problem only (the residuals on
    all). Returns the worst (pri, dual, gap, dist_s, dist_y); raises on a
    violation."""
    jobs = _check_jobs(K, data, results, eps, A_rows, cone_every)
    rows = list(pool.map(_check_one, jobs)) if pool is not None else [_check_one(j) for j in jobs]
    worst = np.max(np.asarray(rows), axis=0)
    for i, (pri, dual, gap, ds, dy) in enumerate(rows):
        if max(pri, dual, gap) > margin or max(ds, dy) > cone_margin * eps:
            raise AssertionError(
                f"problem {i}: pri/lim {pri:.3e}, dual/lim {dual:.3e}, gap/lim {gap:.3e}, "
                f"dist(s, K) {ds:.3e}, dist(y, K*) {dy:.3e}"
            )
    return tuple(float(w) for w in worst)


# ---------------------------------------------------------------------------
# Inputs for the three scalar-iteration projections
# ---------------------------------------------------------------------------


def exp_rows(k, seed=0):
    """k rows for the exponential-cone projection, float64: a seventh each
    inside the cone, in the polar cone, analytic (r, s < 0), generic
    (bisection) at unit scale, generic at magnitudes 1e-6..1e6, near the
    boundary, and rho -> 0 boundary rows (s > 0, t barely under s*exp(r/s))."""
    rng = np.random.RandomState(seed)
    v = rng.randn(k, 3)
    kind = np.arange(k) % 7
    s_in = np.abs(v[:, 1]) + 0.1
    inside = np.stack([v[:, 0], s_in, s_in * np.exp(v[:, 0] / s_in) * (1.5 + np.abs(v[:, 2]))], 1)
    u = -np.abs(v[:, 0]) - 0.1
    polar = -np.stack([u, v[:, 1], -u * np.exp(v[:, 1] / u) / np.e * (1.5 + np.abs(v[:, 2]))], 1)
    analytic = np.stack([-np.abs(v[:, 0]) - 0.01, -np.abs(v[:, 1]) - 0.01, v[:, 2]], 1)
    scaled = v * 10.0 ** rng.uniform(-6, 6, (k, 1))
    near = np.stack([v[:, 0], s_in, s_in * np.exp(v[:, 0] / s_in) * (1 - 1e-3 * rng.rand(k))], 1)
    edge = np.stack([v[:, 0], s_in, s_in * np.exp(v[:, 0] / s_in) * (1 - 1e-7 * rng.rand(k))], 1)
    out = v.copy()
    for i, rows in enumerate((inside, polar, analytic, v, scaled, near, edge)):
        out[kind == i] = rows[kind == i]
    return out


def pow_rows(k, seed=0):
    """k rows and powers for the power-cone projection, float64: a fifth
    each inside, in the polar cone, generic at unit scale, generic at
    magnitudes 1e-6..1e6, and with z = 0; powers from (0.05, 0.95); and a
    sign per row (a third of the rows go to the dual cone)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(k, 3)
    a = rng.uniform(0.05, 0.95, k)
    kind = np.arange(k) % 5
    x, y = np.abs(v[:, 0]) + 0.1, np.abs(v[:, 1]) + 0.1
    inside = np.stack([x, y, x**a * y ** (1 - a) * rng.uniform(-0.9, 0.9, k)], 1)
    polar = np.stack([-x, -y, (x / a) ** a * (y / (1 - a)) ** (1 - a) * rng.uniform(-0.9, 0.9, k)], 1)
    scaled = v * 10.0 ** rng.uniform(-6, 6, (k, 1))
    flat = np.stack([v[:, 0], v[:, 1], np.zeros(k)], 1)
    out = v.copy()
    for i, rows in enumerate((inside, polar, v, scaled, flat)):
        out[kind == i] = rows[kind == i]
    sign = np.where(np.arange(k) % 3 == 0, -1.0, 1.0)
    return out, a, sign


def box_case(B, nb, seed=0, per_row=False):
    """v (B, nb + 1) and bounds for the box-cone projection, float64: a
    fifth of each side infinite; bounds (nb,) shared or (B, nb)."""
    rng = np.random.RandomState(seed)
    shape = (B, nb) if per_row else (nb,)
    bu = np.where(rng.rand(*shape) < 0.2, np.inf, rng.rand(*shape) * 2.0)
    bl = np.where(rng.rand(*shape) < 0.2, -np.inf, -rng.rand(*shape) * 2.0)
    v = rng.randn(B, nb + 1) * 2.0
    v[:, 0] = rng.randn(B) * np.sqrt(nb)  # t on the scale of ||s||: t > 0, t -> 0 and t = 0 all occur
    return v, bl, bu


def logdet_rows(k, n, seed=0):
    """k rows (t0, v0, w0 (k, n)) for the logdet cone's vector projection,
    float64: a seventh each inside the cone, in the polar cone (t0 > 0, w0 <
    0, v0 <= t0 (n - sum log(t0 / |w0_i|)), below by a margin: minus a point
    of the dual cone, so the answer is 0), past the v = 0 facet (v0 far
    below 0, w0 >= 0, t0 <= 0: the facet's point is the answer), active (v0
    > 0, w0 > 0, t0 above the boundary), v0 <= 0 (a fifth of them v0 = 0),
    with negative eigenvalues, and at magnitudes 1e-3..1e3; eigenvalues in
    random order."""
    rng = np.random.RandomState(seed)
    t0, v0, w0 = rng.randn(k) * 2.0, rng.randn(k), rng.randn(k, n) * 2.0
    kind = np.arange(k) % 7
    a, b = np.abs(rng.randn(k)), np.abs(rng.randn(k, n))
    slog = lambda t, v, w: v * (np.log(w).sum(1) - n * np.log(v))  # noqa: E731
    rows = {
        0: (None, a + 0.1, b + 0.1),  # inside: t0 set below
        1: (a + 0.1, (a + 0.1) * (n - np.log((a + 0.1)[:, None] / (b + 0.1)).sum(1)) - a - 0.1,
            -b - 0.1),
        2: (-a, -3.0 * (a + 1.0), b),
        3: (None, a + 0.1, b + 0.1),  # active: t0 set below
        4: (t0, np.where(np.arange(k) % 5 == 4, 0.0, -a), w0),
        5: (t0, a + 0.1, w0),
    }
    for i, (t, v, w) in rows.items():
        sel = kind == i
        v0[sel], w0[sel] = v[sel], w[sel]
        if t is not None:
            t0[sel] = t[sel]
    for i, sign in ((0, -1.0), (3, 1.0)):
        sel = kind == i
        t0[sel] = slog(None, v0[sel], w0[sel]) + sign * (np.abs(rng.randn(sel.sum())) + 0.01)
    big = kind == 6
    mag = 10.0 ** rng.uniform(-3, 3, k)
    t0[big], v0[big], w0[big] = (x[big] * (mag[big] if x.ndim == 1 else mag[big, None])
                                 for x in (t0, v0, w0))
    return t0, v0, w0


def sl_rows(k, n, kk, seed=0, ascending=False):
    """k rows (t0, w0 (k, n)) for the sum-of-kk-largest cone's vector
    projection, float64: a fifth each inside (t0 above the sum), active,
    with ties (eigenvalues from a few integers), all negative with t0 far
    below, and at magnitudes 1e-3..1e3; in random order, or ascending as
    eigh returns them."""
    rng = np.random.RandomState(seed)
    w0 = rng.randn(k, n) * 2.0
    kind = np.arange(k) % 5
    ties = kind == 2
    w0[ties] = rng.randint(-2, 3, (ties.sum(), n)).astype(np.float64)
    neg = kind == 3
    w0[neg] = -np.abs(w0[neg]) - 0.5
    sk = np.sort(w0, 1)[:, ::-1][:, :kk].sum(1)
    a = np.abs(rng.randn(k))
    t0 = np.where(kind == 0, sk + a, np.where(neg, sk - 10.0 * (a + 1.0), sk - 2.0 * a - 0.1))
    big = kind == 4
    mag = 10.0 ** rng.uniform(-3, 3, k)
    t0[big], w0[big] = t0[big] * mag[big], w0[big] * mag[big, None]
    if ascending:
        w0 = np.sort(w0, 1)
    return t0, w0


class _Recorder:
    """A wrapper in the place of `fn`: `keep` sees each call's tensors,
    then `fn` runs. `launches` is fn's own counter (fn counts through the
    module name it now shares with this recorder)."""

    def __init__(self, fn, keep):
        self._fn, self._keep = fn, keep

    def __call__(self, *args, **kw):
        self._keep(*args)
        return self._fn(*args, **kw)

    @property
    def launches(self):
        return self._fn.launches

    @launches.setter
    def launches(self, n):
        self._fn.launches = n


class CaptureRows:
    """The rows a solve hands the cone kernels: inside `with
    CaptureRows(every) as cap:`, every `every`-th call of each wrapper is
    copied (cap.exp: (call, v, sign); cap.pow: (call, v, a, sign); cap.box:
    (call, v, bl, bu); cap.logdet: (call, t0, v0, w0); cap.sl: (call, t0,
    w0, kk); tensors on the call's device). The spectral wrappers count
    their calls per width (and kk), so that each bucket of a cone is
    copied. cap.calls: each wrapper's calls in the block. The projector
    looks the wrappers up in ops.projections at every call, so they are
    replaced there for the block; the copies launch no kernel of theirs,
    and the launch counters count as before."""

    KINDS = {"exp": ("_proj_exp_batch", 2), "pow": ("_proj_pow_batch", 3),
             "box": ("_proj_box", 3), "logdet": ("_proj_logdet_vec_batch", 3),
             "sl": ("_proj_sl_vec_batch", 3)}  # kind: (wrapper, arguments copied)

    def __init__(self, every=50):
        self.every, self.exp, self.pow, self.box, self.logdet, self.sl = every, [], [], [], [], []
        self.calls = {}

    @staticmethod
    def bucket(kind, snap):
        """The bucket a copy belongs to: the spectral rows' width (and kk);
        None for the other kinds."""
        if kind == "logdet":
            return snap[3].shape[1]
        if kind == "sl":
            return (snap[2].shape[1], snap[3])
        return None

    def __enter__(self):
        from ..ops import projections as pr  # noqa: PLC0415

        self._saved = {kind: getattr(pr, name) for kind, (name, _) in self.KINDS.items()}
        calls, self.calls = {}, dict.fromkeys(self.KINDS, 0)

        def keeper(kind, n):
            def keep(*args):
                args = args[:n] + (None,) * (n - len(args[:n]))
                key = (kind, self.bucket(kind, (None, *args)))
                if calls.get(key, 0) % self.every == 0:
                    copies = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
                    getattr(self, kind).append((calls.get(key, 0), *copies))
                calls[key] = calls.get(key, 0) + 1
                self.calls[kind] += 1

            return keep

        for kind, (name, n) in self.KINDS.items():
            setattr(pr, name, _Recorder(self._saved[kind], keeper(kind, n)))
        return self

    def __exit__(self, *exc):
        from ..ops import projections as pr  # noqa: PLC0415

        for kind, (name, _) in self.KINDS.items():
            setattr(pr, name, self._saved[kind])

    def phases(self, kind):
        """{"early", "middle", "late"}: the second, the middle and the last
        copy of `kind` (the first call projects the solver's starting
        point), for each bucket of the spectral kinds (labelled with it);
        and for each row count none of those has (a bucket the batch was
        compacted to), "bucket": the middle copy at that count."""
        out = {}
        groups = {}
        for snap in getattr(self, kind):
            groups.setdefault(self.bucket(kind, snap), []).append(snap)
        for key, snaps in groups.items():
            tag = "" if key is None else f"n={key} " if kind == "logdet" else f"n, kk={key} "
            mine = {f"{tag}early": snaps[min(1, len(snaps) - 1)],
                    f"{tag}middle": snaps[len(snaps) // 2], f"{tag}late": snaps[-1]}
            by_rows = {}
            for snap in snaps[1:]:
                by_rows.setdefault(snap[1].shape[0], []).append(snap)
            seen = {snap[1].shape[0] for snap in mine.values()}
            for rows, group in by_rows.items():
                if rows not in seen:
                    mine[f"{tag}bucket {rows}"] = group[len(group) // 2]
            out.update(mine)
        return out

    def inputs(self, tag):
        """The early, middle and late copies as check_cone_kernels' inputs
        (numpy float64), labelled with `tag`, the call and the shape:
        (exp_inputs, box_inputs, pow_inputs)."""
        as_np = lambda t: None if t is None else t.double().cpu().numpy()  # noqa: E731
        exp = [
            (f"{tag} {ph}, call {c}, {tuple(v.shape)}", as_np(v), as_np(sign))
            for ph, (c, v, sign) in self.phases("exp").items()
        ]
        box = [
            (f"{tag} {ph}, call {c}, {tuple(v.shape)} {'per-row' if bl.dim() == 2 else 'shared'} "
             f"bounds", as_np(v.reshape(-1, v.shape[-1])), as_np(bl), as_np(bu))
            for ph, (c, v, bl, bu) in self.phases("box").items()
        ]
        pow_ = [
            (f"{tag} {ph}, call {c}, {tuple(v.shape)}", as_np(v), as_np(a), as_np(sign))
            for ph, (c, v, a, sign) in self.phases("pow").items()
        ]
        return exp, box, pow_

    def spectral_inputs(self, tag):
        """The early, middle and late copies of each spectral bucket as
        check_spectral_kernels' inputs (numpy float64): (logdet_inputs,
        sl_inputs)."""
        as_np = lambda t: t.double().cpu().numpy()  # noqa: E731
        logdet = [
            (f"{tag} {ph}, call {c}, {tuple(w0.shape)}", as_np(t0), as_np(v0), as_np(w0))
            for ph, (c, t0, v0, w0) in self.phases("logdet").items()
        ]
        sl = [
            (f"{tag} {ph}, call {c}, {tuple(w0.shape)}", as_np(t0), as_np(w0), kk)
            for ph, (c, t0, w0, kk) in self.phases("sl").items()
        ]
        return logdet, sl


# ---------------------------------------------------------------------------
# The variational test of a projection, in f64 on the host
# ---------------------------------------------------------------------------


def _geometry(v, p, in_cone, in_dual, proj_cone, proj_dual, tol, inner_tol=np.inf):
    """The variational test over rows (k, 3), float64: p in K, p - v in K*
    and <p, p - v> = 0, each relative to 1 + |v|. Membership is the oracle's
    membership function at tolerance tol or, where that refuses a point
    (its tolerance is not a distance: a coordinate off by one rounding can
    sit under an exponential), a distance from the oracle's own projection
    within tol; |<p, p - v>| / (1 + |v|)^2 within inner_tol. Returns (the
    mask of rows that fail, worst |<p, p - v>| / (1 + |v|)^2)."""
    bad, worst = [], 0.0
    for vi, pi in zip(v, p):
        scale = 1.0 + np.abs(vi).max()
        ps, qs = pi / scale, (pi - vi) / scale
        ok = np.all(np.isfinite(pi))
        ok = ok and (in_cone(ps, tol) or np.linalg.norm(ps - proj_cone(ps)) <= tol)
        ok = ok and (in_dual(qs, tol) or np.linalg.norm(qs - proj_dual(qs)) <= tol)
        ok = ok and abs(ps @ qs) <= inner_tol
        bad.append(not ok)
        worst = max(worst, abs(ps @ qs))
    return np.array(bad, bool), worst


def geometry_exp(v, p, sign=None, tol=1e-5, inner_tol=np.inf):
    """The test for rows projected onto the exponential cone (sign > 0 or
    None) or its dual (sign < 0)."""
    oracle = _oracle()
    v, p = np.asarray(v, np.float64), np.asarray(p, np.float64)
    dual = np.zeros(len(v), bool) if sign is None else np.asarray(sign) < 0
    proj = oracle.proj_exp
    proj_d = lambda w: w + oracle.proj_exp(-w)  # noqa: E731
    with np.errstate(all="ignore"):
        b1, w1 = _geometry(v[~dual], p[~dual], oracle.in_exp, oracle.in_exp_dual, proj, proj_d, tol,
                           inner_tol)
        b2, w2 = _geometry(v[dual], p[dual], oracle.in_exp_dual, oracle.in_exp, proj_d, proj, tol,
                           inner_tol)
    bad = np.zeros(len(v), bool)
    bad[~dual], bad[dual] = b1, b2
    return bad, max(w1, w2)


def geometry_pow(v, p, a, sign=None, tol=1e-5, inner_tol=np.inf):
    """The test for rows projected onto the power cone K_a[row] or its dual."""
    oracle = _oracle()
    v, p = np.asarray(v, np.float64), np.asarray(p, np.float64)
    dual = np.zeros(len(v), bool) if sign is None else np.asarray(sign) < 0
    bad, worst = [], 0.0
    with np.errstate(all="ignore"):
        for vi, pi, ai, di in zip(v, p, np.asarray(a, np.float64), dual):
            fns = (
                lambda w, t, ai=ai: oracle.in_pow(w, ai, t),
                lambda w, t, ai=ai: oracle.in_pow_dual(w, ai, t),
                lambda w, ai=ai: oracle.proj_pow(w, ai),
                lambda w, ai=ai: w + oracle.proj_pow(-w, ai),
            )
            if di:
                fns = (fns[1], fns[0], fns[3], fns[2])
            b, w = _geometry(vi[None], pi[None], *fns, tol, inner_tol)
            bad.append(b[0])
            worst = max(worst, w)
    return np.array(bad, bool), worst


def geometry_box(v, p, bl, bu, tol=1e-5, inner_tol=np.inf):
    """Rows (t, s) projected onto the box cone: p in K (t >= 0, bl t <= s <=
    bu t) and p no farther from v than the oracle's golden-section answer,
    by tol and by inner_tol, relative to 1 + |v|. Returns (the mask of rows
    that fail, worst excess distance)."""
    oracle = _oracle()
    v, p = np.asarray(v, np.float64), np.asarray(p, np.float64)
    bad, worst = [], 0.0
    for i, (vi, pi) in enumerate(zip(v, p)):
        lo = np.asarray(bl[i] if np.ndim(bl) == 2 else bl, np.float64)
        hi = np.asarray(bu[i] if np.ndim(bu) == 2 else bu, np.float64)
        scale = 1.0 + np.abs(vi).max()
        t, s = pi[0], pi[1:]
        with np.errstate(invalid="ignore"):
            lo_t = np.where(np.isfinite(lo), lo * t, -np.inf)
            hi_t = np.where(np.isfinite(hi), hi * t, np.inf)
        inside = t >= 0 and np.all(s >= lo_t - tol * scale) and np.all(s <= hi_t + tol * scale)
        with np.errstate(invalid="ignore"):
            ref = oracle.proj_box(vi, lo, hi)
        excess = (np.linalg.norm(pi - vi) - np.linalg.norm(ref - vi)) / scale
        bad.append(not inside or excess > min(tol, inner_tol))
        worst = max(worst, excess)
    return np.array(bad, bool), worst


def _spectral_dist(args):
    """The distance from one spectral row to the oracle's projection of it
    (worker entry point): ("d", t0, v0, w0) or ("sl", t0, w0, kk), the row
    given as the matrix diag(w0), whose packed form is isometric to
    (t0, [v0,] w0)."""
    kind, *row = args
    oracle = _oracle()
    with np.errstate(all="ignore"):
        if kind == "d":
            t0, v0, w0 = row
            z = np.r_[t0, v0, oracle._pack_sym(np.diag(w0))]
            p = oracle.proj_logdet(z, len(w0))
        else:
            t0, w0, kk = row
            z = np.r_[t0, oracle._pack_sym(np.diag(w0))]
            p = oracle.proj_sumlargest(z, len(w0), kk)
    return float(np.linalg.norm(p - z))


def geometry_spectral(kind, row, p, ref_dist, kk=None, tol=1e-5, inner_tol=np.inf):
    """Rows projected onto the logdet cone (kind "d": row and p (t, v, w))
    or the sum-of-kk-largest cone ("sl": (t, w)), in f64: p in K (the
    oracle's _logdet_feasible, or the sum of the kk largest w_i at most t)
    at tolerance tol, and p no farther from the row than the oracle's
    projection (ref_dist, _spectral_dist's) by min(tol, inner_tol), all
    relative to 1 + |row|_inf. Returns (the mask of rows that fail, worst
    excess distance)."""
    oracle = _oracle()
    row = [np.asarray(x, np.float64) for x in row]
    p = [np.asarray(x, np.float64) for x in p]
    vecs = lambda r: np.concatenate([x[:, None] if x.ndim == 1 else x for x in r], 1)  # noqa: E731
    v_all, p_all = vecs(row), vecs(p)
    scale = 1.0 + np.abs(v_all).max(1)
    excess = (np.linalg.norm(p_all - v_all, axis=1) - ref_dist) / scale
    bad = []
    with np.errstate(all="ignore"):
        for i in range(len(scale)):
            q = p_all[i] / scale[i]
            if not np.all(np.isfinite(q)):
                bad.append(True)
                continue
            if kind == "d":
                member = oracle._logdet_feasible(q[0], q[1], q[2:], float(len(q) - 2), tol)
            else:
                member = oracle.sum_k_largest(q[1:], kk) <= q[0] + tol
            bad.append(not member or excess[i] > min(tol, inner_tol))
    return np.array(bad, bool), float(excess.max()) if len(excess) else 0.0


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

# |kernel - plain| <= KERNEL_TOL * max(1, |v|_inf) per row. The two run the
# same operations in the same order, but nvcc contracts a*b+c into FMAs and
# its log/exp differ from the library's by an ulp; a flipped comparison in
# the bisection then ends on another end of a bracket of 8 eps * max(1, rho),
# rho up to |v|, and the cone's curvature carries that into s and t. On a
# few rows the f32 Newton iteration has not settled after its fixed count
# (the plain f32 version is itself off its f64 run by 1e-2 of |v| there) and
# a rounding is amplified: at most STRAY_ROWS of the rows may exceed
# KERNEL_TOL, and none STRAY_TOL. The spectral kernels' check
# (check_spectral_kernels) takes the plain version in f64 as witness for an
# f32 row over KERNEL_TOL: where the plain f32 answer is itself more than
# KERNEL_TOL off the f64 one, the row passes if the kernel's answer is no
# farther from the f64 one than the plain f32 answer plus KERNEL_TOL.
KERNEL_TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
STRAY_ROWS = 1e-3
STRAY_TOL = {torch.float32: 5e-2, torch.float64: 1e-6}
# |<p, p - v>| / (1 + |v|)^2 of the kernel's answer, in f64 on the host
INNER_TOL = {torch.float32: 5e-3, torch.float64: 1e-8}
# operations per pass, counted from the plain versions' arithmetic lines
# (a log, exp, sqrt or division as one operation each). POW_OPS_PER_NEWTON:
# ops.projections._pow_newton_step as written, each add, subtract,
# multiply, divide, max, abs, sqrt, log and exp one operation, no compare
# or select: for each half (x, y) _pow_calc_x 10, dxdr 6, the safe power
# 4, a dxdr / x 2; then xy, f, |f|, the sum of the halves, fp (2), f / fp
# and r - f / fp
EXP_OPS_PER_NEWTON, EXP_OPS_PER_SOLVE = 14, 12
POW_OPS_PER_NEWTON = 52
BOX_OPS_PER_ELEMENT = 12


def pow_repeat_steps(v, a, sign=None):
    """Per row of a power-cone projection (the rows after the dual's sign),
    the Newton steps its exact answer needs on the plain version's map
    (ops.projections._pow_newton_step, a function of r alone) and the
    period it ends on: none for a row inside the cone or its polar cone
    (period 0); else the first step i whose r_i repeats an earlier iterate
    r_(i-p), after which the 40-step count's point is known (p = 1 a fixed
    point, p >= 2 a cycle); all 40 where nothing repeats (period 0).
    Returns (steps, period), int64 (k,) tensors on v's device."""
    from ..ops import projections as pr  # noqa: PLC0415

    w = v if sign is None else v * sign[:, None]
    in_cone, in_polar = pr._pow_cases(w, a)
    n = pr.POW_NEWTON_ITERS
    rh = w[:, 2].abs()
    its = torch.empty((n + 1,) + rh.shape, dtype=rh.dtype, device=rh.device)
    its[0] = rh / 2.0
    for i in range(n):
        its[i + 1] = pr._pow_newton_step(its[i], w[:, 0], w[:, 1], a, rh)
    newton = ~(in_cone | in_polar)
    steps = torch.where(newton, n, 0)
    period = torch.zeros_like(steps)
    live = newton.clone()
    for i in range(1, n + 1):
        # the latest earlier iterate equal to r_i: the smallest period
        j = torch.arange(i, device=rh.device)[:, None]
        last = torch.where(its[:i] == its[i], j, -1).amax(0)
        hit = live & (last >= 0)
        steps, period = torch.where(hit, i, steps), torch.where(hit, i - last, period)
        live &= ~hit
    return steps, period


def _time_ms(fn, reps=10):
    """Median over `reps` CUDA-event pairs of one call, after a warm-up."""
    import statistics  # noqa: PLC0415

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


def _count_kernels(fn):
    """Kernels one call of fn launches on the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(
        ev.count for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA
    )


def _row_err(out_k, out_p, v):
    """Per row: max |kernel - plain| over max(1, |v|_inf)."""
    scale = v.abs().amax(dim=-1).clamp_min(1.0)
    return (out_k - out_p).abs().amax(dim=-1) / scale


def _bound_ms(n_bytes, n_ops, dtype, hbm, peak):
    by, op = n_bytes / hbm, n_ops / peak[dtype]
    return max(by, op) * 1e3, "bytes" if by >= op else "operations"


# rows (exp, power) and (B, bounds, per-row bounds?) cases of the kernel
# checks: what one projection of the mixed_cone cell stacks (64 problems x
# 20 exponential and x 4 power cones), what the wide batch stacks (128 x 300
# and x 100; its box: 128 problems of 400 bounds), the cell's exponential
# cones of one kind alone (640), and 10^6
EXP_SIZES = (640, 1280, 38400, 1_000_000)
POW_SIZES = (256, 12800, 1_000_000)
BOX_CASES = ((128, 400, True), (512, 1000, True), (512, 1000, False), (1, 1000, False))
REPORT_AT = {"proj_exp": 38400, "proj_pow": 12800, "proj_box": (128, 400, True)}


def check_cone_kernels(hbm_bytes_per_s, peak_flops, exp_sizes=EXP_SIZES, pow_sizes=POW_SIZES,
                       box_cases=BOX_CASES, report_at=None, geometry_rows=2100, plain_reps=2,
                       log=print, exp_inputs=(), box_inputs=(), pow_inputs=(),
                       dtypes=(torch.float32, torch.float64)):
    """proj_exp, proj_pow and proj_box against their plain versions on the
    card, f32 and f64: the row-wise limit KERNEL_TOL, a bit-equal repeat,
    the geometry of the kernel's answer in f64 on the host (on at most
    `geometry_rows` rows of a case: membership, and |<p, p - v>| or the
    excess distance within INNER_TOL; it must hold on every row where it
    holds for the plain version's answer: on a few extreme rows the
    algorithm itself, scs_tpu's too, and the oracle's, stop short of the
    projection), CUDA-event times of kernel and plain
    version, and the bound from the passes this run's data needed. Beside
    the synthetic sizes, given inputs: `exp_inputs` (label, v (k, 3), sign
    (k,) or None), `pow_inputs` (label, v (k, 3), a (k,), sign (k,) or
    None) and `box_inputs` (label, v (B, nb + 1), bl, bu), numpy float64,
    such as the rows a solve handed the kernels (CaptureRows). Returns
    {name: {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "bound_steps_ms", "shape"}} in f32 at the sizes of `report_at` (default
    REPORT_AT, the wide batch's shapes). bound_ms counts the plain
    algorithm's passes (proj_exp: its solves at 40 Newton steps each;
    proj_pow: the steps each row needs to its first repeat on the plain
    map, pow_repeat_steps, and "bound_fixed_ms" beside it at 40 steps on
    every row outside the cone and its polar); bound_steps_ms the Newton
    steps the kernel ran, its exits at fixed points and cycles taken
    (proj_box counts those in bound_ms already)."""
    report_at = REPORT_AT if report_at is None else report_at
    from ..ops import projections as pr  # noqa: PLC0415

    dev = torch.device("cuda")
    report = {}

    def both(geometry, out_k, out_p, sub, *args, **kw):
        """The geometry of the kernel's and of the plain version's answer on
        rows `sub`: (rows where only the kernel's fails, rows where both
        fail, the kernel's worst inner product or excess distance over all
        of them)."""
        as_np = lambda t: t[sub].double().cpu().numpy()  # noqa: E731
        bad_k, worst = geometry(as_np(out_k), *args, **kw)
        bad_p, _ = geometry(as_np(out_p), *args, **kw)
        return int((bad_k & ~bad_p).sum()), int((bad_k & bad_p).sum()), worst

    def finish(name, label, dtype, v, out_k, out_p, geo, k_ms, p_ms, bound, passes, key,
               bound_steps=None, extra=None):
        bad, bad_both, worst = geo
        rows = _row_err(out_k, out_p, v)
        err, n_stray = float(rows.max()), int((rows > KERNEL_TOL[dtype]).sum())
        abs_err = float((out_k - out_p).abs().max())
        faults = []
        if not bool(torch.isfinite(out_k).all()):
            faults.append("the kernel returned a non-finite value")
        if n_stray > STRAY_ROWS * rows.numel() or not err <= STRAY_TOL[dtype]:
            faults.append(
                f"kernel disagrees with the plain version: {n_stray} of {rows.numel()} rows "
                f"over {KERNEL_TOL[dtype]:g} of max(1, |v|), worst {err:.3e}"
            )
        if bad:
            faults.append(
                f"{bad} rows of the kernel's answer fail cone membership or |<p, p - v>| (excess "
                f"distance) <= {INNER_TOL[dtype]:g} where the plain version's pass; worst "
                f"{worst:.3e}"
            )
        if faults:
            raise AssertionError(f"{name} {label} {dtype}: " + "; ".join(faults))
        log(
            f"[3] {name} {label} {str(dtype)[6:]}: max |kernel - plain| {err:.3e} of max(1, |v|), "
            f"{n_stray} rows over {KERNEL_TOL[dtype]:g} (absolute {abs_err:.3e}), repeat bit-equal; f64 "
            f"geometry of the kernel's answer: p in K, p - v in K* and |<p, p - v>| (excess "
            f"distance) within {INNER_TOL[dtype]:g} on every row checked but {bad_both} where the "
            f"plain version's fails too, worst {worst:.2e}; {passes}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.2f} ms, bound {bound[0]:.6f} ms by {bound[1]}"
            + ("" if bound_steps is None else
               f" (from the Newton steps run: {bound_steps[0]:.6f} ms by {bound_steps[1]})")
        )
        if key:
            bound_steps = bound if bound_steps is None else bound_steps
            report[name] = {
                "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "bound_steps_ms": bound_steps[0], "shape": label,
                **(extra or {}),
            }

    def run_exp(label, v_np, sign_np, dtype, geo_tol, key):
        k = len(v_np)
        sub = slice(0, min(k, geometry_rows))
        v = torch.as_tensor(v_np, dtype=dtype, device=dev)
        sign = None if sign_np is None else torch.as_tensor(sign_np, dtype=dtype, device=dev)
        evals, steps, cycles = (torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(3))
        out_k = pr._proj_exp_batch(v, sign, evals, steps, cycles)
        if not torch.equal(out_k, pr._proj_exp_batch(v, sign)):
            raise AssertionError(f"proj_exp {label} {dtype}: a repeated launch differs")
        out_p = pr._signed(pr._proj_exp_batch_ref, v, sign)
        torch.cuda.synchronize()
        geo = both(
            lambda p: geometry_exp(v[sub].double().cpu().numpy(), p,
                                   None if sign_np is None else sign_np[sub], tol=geo_tol,
                                   inner_tol=INNER_TOL[dtype]),
            out_k, out_p, sub,
        )
        n_solves, n_steps = int(evals.sum()), int(steps.sum())
        ops = n_solves * (pr.EXP_NEWTON_ITERS * EXP_OPS_PER_NEWTON + EXP_OPS_PER_SOLVE)
        ops_run = n_steps * EXP_OPS_PER_NEWTON + n_solves * EXP_OPS_PER_SOLVE
        finish(
            "proj_exp", label, dtype, v, out_k, out_p, geo,
            _time_ms(lambda: pr._proj_exp_batch(v, sign)),
            _time_ms(lambda: pr._signed(pr._proj_exp_batch_ref, v, sign), plain_reps),
            _bound_ms(k * 7 * item, ops, dtype, hbm_bytes_per_s, peak_flops),
            f"{pr.exp_group(k)} lanes a cone; {n_solves} inner Newton solves in all, at most "
            f"{int(evals.max())} a row, {n_steps} Newton steps, {int(cycles.sum())} solves "
            f"left on a cycle",
            key, _bound_ms(k * 7 * item, ops_run, dtype, hbm_bytes_per_s, peak_flops),
        )

    def run_pow(label, v_np, a_np, sign_np, dtype, geo_tol, key):
        k = len(v_np)
        sub = slice(0, min(k, geometry_rows))
        v = torch.as_tensor(v_np, dtype=dtype, device=dev)
        a = torch.as_tensor(a_np, dtype=dtype, device=dev)
        sign = None if sign_np is None else torch.as_tensor(sign_np, dtype=dtype, device=dev)
        iters = torch.zeros(k, dtype=torch.int32, device=dev)
        out_k = pr._proj_pow_batch(v, a, sign, iters)
        if not torch.equal(out_k, pr._proj_pow_batch(v, a, sign)):
            raise AssertionError(f"proj_pow {label} {dtype}: a repeated launch differs")
        plain = lambda: pr._signed(lambda w: pr._proj_pow_batch_ref(w, a), v, sign)  # noqa: E731
        out_p = plain()
        torch.cuda.synchronize()
        geo = both(
            lambda p: geometry_pow(v[sub].double().cpu().numpy(), p, a[sub].double().cpu().numpy(),
                                   None if sign_np is None else sign_np[sub], tol=geo_tol,
                                   inner_tol=INNER_TOL[dtype]),
            out_k, out_p, sub,
        )
        need, period = pow_repeat_steps(v, a, sign)
        n_newton, n_need = int((need > 0).sum()), int(need.sum())
        n_steps, n_cycles = int(iters.sum()), int((period >= 2).sum())
        nbytes = k * 8 * item
        fixed = _bound_ms(nbytes, n_newton * pr.POW_NEWTON_ITERS * POW_OPS_PER_NEWTON, dtype,
                          hbm_bytes_per_s, peak_flops)
        finish(
            "proj_pow", label, dtype, v, out_k, out_p, geo,
            _time_ms(lambda: pr._proj_pow_batch(v, a, sign)), _time_ms(plain, plain_reps),
            _bound_ms(nbytes, n_need * POW_OPS_PER_NEWTON, dtype, hbm_bytes_per_s, peak_flops),
            f"{n_newton} rows need Newton, {n_need} steps to their first repeat on the plain map "
            f"({n_cycles} rows end on a cycle); the kernel ran {n_steps} steps, at most "
            f"{int(iters.max())} a row; at the fixed count of {pr.POW_NEWTON_ITERS} the bound "
            f"would be {fixed[0]:.6f} ms by {fixed[1]}",
            key, _bound_ms(nbytes, n_steps * POW_OPS_PER_NEWTON, dtype, hbm_bytes_per_s,
                           peak_flops),
            {"bound_fixed_ms": fixed[0], "cycles": n_cycles, "repeat_steps": n_need,
             "newton_steps": n_steps, "rows_newton": n_newton},
        )

    def run_box(label, v_np, bl_np, bu_np, dtype, geo_tol, key):
        B, nb = v_np.shape[0], v_np.shape[1] - 1
        per_row = np.ndim(bl_np) == 2
        v = torch.as_tensor(v_np, dtype=dtype, device=dev)
        bl = torch.as_tensor(bl_np, dtype=dtype, device=dev)
        bu = torch.as_tensor(bu_np, dtype=dtype, device=dev)
        iters, cycles = (torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2))
        out_k = pr._proj_box(v, bl, bu, iters_out=iters, cycles_out=cycles)
        if not torch.equal(out_k, pr._proj_box(v, bl, bu)):
            raise AssertionError(f"proj_box {label} {dtype}: a repeated launch differs")
        if not per_row:
            # the same bounds given row by row must give the same bits
            rows = pr._proj_box(v, bl.expand(B, nb).contiguous(), bu.expand(B, nb).contiguous())
            if not torch.equal(out_k, rows):
                raise AssertionError(f"proj_box {label} {dtype}: shared and per-row bounds differ")
        out_p = pr._proj_box_ref(v, bl, bu)
        torch.cuda.synchronize()
        gsub = slice(0, min(B, 64))
        geo = both(
            lambda p: geometry_box(
                v_np[gsub], p, bl_np[gsub] if per_row else bl_np,
                bu_np[gsub] if per_row else bu_np, tol=geo_tol, inner_tol=INNER_TOL[dtype],
            ),
            out_k, out_p, gsub,
        )
        n_steps = int(iters.sum())
        n_bytes = (2 * B * (nb + 1) + 2 * (B if per_row else 1) * nb) * item
        finish(
            "proj_box", label, dtype, v, out_k, out_p, geo,
            _time_ms(lambda: pr._proj_box(v, bl, bu)),
            _time_ms(lambda: pr._proj_box_ref(v, bl, bu), plain_reps),
            _bound_ms(n_bytes, (n_steps + B) * nb * BOX_OPS_PER_ELEMENT, dtype,
                      hbm_bytes_per_s, peak_flops),
            f"{n_steps} Newton steps in all, at most {int(iters.max())} a problem, "
            f"{int(cycles.sum())} left on a cycle",
            key,
        )

    for dtype in dtypes:
        item = 4 if dtype == torch.float32 else 8
        f32 = dtype == torch.float32
        # membership in f64 is certified to the oracle's own resolution (its
        # bisection ends at ~1e-6 of the point), no further
        geo_tol = 1e-4 if f32 else 3e-6
        for k in exp_sizes:
            # exponential cone, a third of the rows to the dual cone
            v_np = exp_rows(k, seed=k % 1000)
            sign_np = np.where(np.arange(k) % 3 == 0, -1.0, 1.0)
            v_np = v_np * sign_np[:, None]  # so that every regime reaches both cones
            run_exp(f"(k={k}, 3)", v_np, sign_np, dtype, geo_tol,
                    k == report_at["proj_exp"] and f32)
        for label, v_np, sign_np in exp_inputs:
            run_exp(label, v_np, sign_np, dtype, geo_tol, False)
        for k in pow_sizes:
            v_np, a_np, sign_np = pow_rows(k, seed=k % 1000 + 1)
            run_pow(f"(k={k}, 3)", v_np, a_np, sign_np, dtype, geo_tol,
                    k == report_at["proj_pow"] and f32)
        for label, v_np, a_np, sign_np in pow_inputs:
            run_pow(label, v_np, a_np, sign_np, dtype, geo_tol, False)
        # box cone: one problem, and a batch under shared and per-row bounds
        for B, nb, per_row in box_cases:
            v_np, bl_np, bu_np = box_case(B, nb, seed=B + per_row, per_row=per_row)
            run_box(f"({B}, {nb + 1}) {'per-row' if per_row else 'shared'} bounds", v_np, bl_np,
                    bu_np, dtype, geo_tol, (B, nb, per_row) == tuple(report_at["proj_box"]) and f32)
        for label, v_np, bl_np, bu_np in box_inputs:
            run_box(label, v_np, bl_np, bu_np, dtype, geo_tol, False)
    return report


# C4 / C5 (csrc/spectral_proj.cu). Operations per pass, counted from the
# plain versions' arithmetic lines (a log, sqrt or division one operation):
# the logdet cone's slog(v) per eigenvalue w0^2, (4 mu) v, +, sqrt, +, *0.5,
# max, log and the sum's add, and per pass the midpoint, the log of v and
# phi with its compare and select; per h(mu) its midpoint, v slog - t0 + mu
# and the select. The sum-of-largest cone's capped-simplex pass per
# eigenvalue a subtract, the clamp and the sum's add, per pass the midpoint,
# compare and select; per h(mu) per eigenvalue the division, the clamp,
# mu y, w0 - mu y, the sort's log2(n) compares and the sum's add. The bound
# (spectral_bound_ms) counts these on the passes the rows need on the plain
# map, whatever implements them. The kernel's serial floor (chain_ms): its
# longest row's inner passes (the chain through its warps) at LD_CHAIN_OPS /
# SL_CHAIN_OPS dependent operations each, CHAIN_CYCLES cycles each at the
# card's highest SM clock. A logdet pass: the group's tree node (two
# midpoints, 4), per eigenvalue (4 mu) v, the FMA, sqrt, +, * 0.5 and max
# (6), its mantissa and the product's multiply (2), the lane's one log and
# its exponents' term (2), the group's butterfly of three shuffles and adds
# (6), phi with its compare and the ballot (6), the walk's two levels (6); a
# sum-of-largest pass: the node (4), per eigenvalue the subtract, the
# clamp's max and min and the add (4), the butterfly (6), the compare and
# the ballot (2), the walk (6).
LD_OPS_PER_ELEMENT, LD_OPS_PER_INNER, LD_OPS_PER_OUTER = 9, 12, 8
SL_OPS_PER_ELEMENT, SL_OPS_PER_INNER, SL_OPS_PER_ELEMENT_OUTER = 4, 5, 9
LD_CHAIN_OPS, SL_CHAIN_OPS, CHAIN_CYCLES = 32, 22, 4
# (rows, n) cases of the logdet kernel and (rows, n, kk, ascending) of the
# sum-of-largest one: n in 1, 2, 31 and 33 (k in 1 and n - 1), the shapes
# phase 15 hands them (ascending, as eigh returns them), the (16, 6) and
# (16, 8) of the plain versions' first timing, the edges of the kernel's
# layouts (a group of 8 lanes holds 8, 16, 32 or 64 eigenvalues, of 16
# lanes 128, of 32 lanes 256, past that the memory path: each capacity and
# one past it), and row counts that are multiples of nothing the launch
# tiles by (a cluster of two blocks a cone)
LOGDET_CASES = ((70, 1), (70, 2), (70, 31), (70, 33), (64, 32), (64, 16), (16, 6), (67, 8),
                (67, 9), (67, 17), (67, 64), (67, 65), (13, 128), (13, 129), (11, 256), (7, 257))
SL_CASES = (
    (70, 1, 1, False), (70, 2, 1, False), (70, 31, 1, False), (70, 31, 30, False),
    (70, 32, 1, False), (70, 32, 31, False), (70, 33, 1, False), (70, 33, 32, False),
    (64, 32, 4, True), (64, 16, 3, True), (16, 8, 3, False), (67, 9, 4, False),
    (67, 64, 63, False), (67, 65, 2, True), (13, 128, 5, False), (13, 129, 128, False),
    (11, 256, 100, True), (5, 257, 128, False),
)
SPECTRAL_REPORT_AT = {"proj_logdet_vec": (64, 32), "proj_sl_vec": (64, 32, 4)}
GEOMETRY_MAX_N = 64  # the oracle's SLSQP on a wider row takes minutes


def spectral_bound_ms(kind, n, dtype, counts, hbm_bytes_per_s, peak_flops):
    """The roofline of C4 ("d") or C5 ("sl") on rows of n eigenvalues: the
    larger of the bytes (each row read and written once) over the memory
    rate and the plain algorithm's operations on the passes the rows need
    over the peak rate of `dtype`. `counts`: the plain version's per-row
    counts on these rows (its `counts` output), never the kernel's.
    Returns (ms, "bytes" or "operations")."""
    k = len(counts["inner"])
    item = 4 if dtype == torch.float32 else 8
    inner, outer = int(counts["inner"].sum()), int(counts["outer"].sum())
    if kind == "d":
        ops = inner * (n * LD_OPS_PER_ELEMENT + LD_OPS_PER_INNER) + outer * LD_OPS_PER_OUTER
        n_bytes = 2 * k * (n + 2) * item
    else:
        per_outer = n * (SL_OPS_PER_ELEMENT_OUTER + math.ceil(math.log2(max(n, 2))))
        ops = inner * (n * SL_OPS_PER_ELEMENT + SL_OPS_PER_INNER) + outer * per_outer
        n_bytes = 2 * k * (n + 1) * item
    return _bound_ms(n_bytes, ops, dtype, hbm_bytes_per_s, peak_flops)


def chain_ms(kind, inner, clock_hz):
    """The kernel's serial floor on rows whose inner passes (the kernel's
    counts) are `inner`: its longest chain at LD_CHAIN_OPS / SL_CHAIN_OPS
    dependent operations a pass, CHAIN_CYCLES cycles each."""
    ops = LD_CHAIN_OPS if kind == "d" else SL_CHAIN_OPS
    return int(inner.max()) * ops * CHAIN_CYCLES / clock_hz * 1e3


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]
    return float(out) * 1e6


def _spectral_plain(args):
    """The plain version of C4 ("d": rows (t0, v0, w0)) or C5 ("sl": (t0,
    w0), kk) on the CPU, in the rows' own type (worker-process entry
    point): its answer and its per-row counts (the plain map's passes), as
    numpy arrays."""
    from ..ops import projections as pr  # noqa: PLC0415

    kind, rows, kk = args
    torch.set_num_threads(1)
    row = [torch.as_tensor(x) for x in rows]
    counts = {}
    out = (pr._proj_logdet_vec_batch_ref(*row, counts=counts) if kind == "d"
           else pr._proj_sl_vec_batch_ref(*row, kk, counts=counts))
    return [x.numpy() for x in out], {key: c.numpy() for key, c in counts.items()}


def f64_witness(kind, kk, rows, out_k, out_p, tol):
    """Per f32 row (numpy, as C4 "d" or C5 "sl" takes them): whether the
    plain version's f32 answer `out_p` is more than `tol` of max(1, |row|)
    off its answer in f64 on the same rows, and the kernel's answer `out_k`
    no farther from that than the plain f32 answer plus `tol`."""
    k = len(rows[0])
    flat = lambda out: np.concatenate(  # noqa: E731
        [np.asarray(x, np.float64).reshape(k, -1) for x in out], 1)
    out64, _ = _spectral_plain((kind, [np.asarray(x, np.float64) for x in rows], kk))
    scale = np.maximum(np.abs(flat(rows)).max(1), 1.0)
    d_p, d_k = (np.abs(flat(out) - flat(out64)).max(1) / scale for out in (out_p, out_k))
    return (d_p > tol) & (d_k <= d_p + tol)


def check_spectral_kernels(hbm_bytes_per_s, peak_flops, clock_hz, logdet_cases=LOGDET_CASES,
                           sl_cases=SL_CASES, report_at=None, geometry_rows=4, log=print,
                           logdet_inputs=(), sl_inputs=(), dtypes=(torch.float32, torch.float64),
                           pool=None):
    """proj_logdet_vec (C4) and proj_sl_vec (C5) against their plain
    versions, f32 and f64: the row-wise limit KERNEL_TOL (at most STRAY_ROWS
    of the rows past it, none past STRAY_TOL; an f32 row past it passes on
    f64_witness), a bit-equal repeat, and the
    geometry of the kernel's answer in f64 on the host on up to
    `geometry_rows` rows of a case of n <= GEOMETRY_MAX_N
    (geometry_spectral against the oracle's projection; it must hold
    wherever it holds for the plain version's answer). The plain version
    runs on the CPU (the same function on the same rows, in the same type,
    with its counts; on the card one call takes 0.2-16 s, the launches of
    its passes): with a pool in its workers, beside the oracle's
    projections, every case submitted before any is read; without one, here.
    The kernel's device time from CUDA-graph replays; the plain version's on
    the card from CUDA events around one call at the shapes of `report_at`
    (default SPECTRAL_REPORT_AT, f32), where it is reported; the bound: the
    roofline of the plain algorithm's work on the rows (spectral_bound_ms,
    from the plain version's counts), and beside it the kernel's serial
    floor (chain_ms, from its own counts). Beside the synthetic cases, given
    inputs: `logdet_inputs` (label, t0, v0, w0) and `sl_inputs` (label, t0,
    w0, kk), numpy float64, such as the rows a solve handed the kernels
    (CaptureRows). Returns {name: {"max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by", "chain_ms", "shape", "inner", "outer",
    "inner_max", "outer_max", "plain_inner", "plain_outer",
    "plain_inner_max", "plain_outer_max", "rows"}} at the report shapes:
    the kernel's serial passes and the plain map's, in all and at most a
    row."""
    from ..ops import projections as pr  # noqa: PLC0415
    from .gemv_proto import time_graph_ms  # noqa: PLC0415

    report_at = SPECTRAL_REPORT_AT if report_at is None else report_at
    dev = torch.device("cuda")
    report, pending = {}, []

    def run(name, label, dtype, row_np, kk, geo_tol, key):
        k, n = row_np[-1].shape
        kind = "d" if kk is None else "sl"
        row = [torch.as_tensor(x, dtype=dtype, device=dev) for x in row_np]
        extra = () if kk is None else (kk,)
        kern = pr._proj_logdet_vec_batch if kk is None else pr._proj_sl_vec_batch
        plain = pr._proj_logdet_vec_batch_ref if kk is None else pr._proj_sl_vec_batch_ref
        inner, outer = (torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(2))
        out_k = kern(*row, *extra, inner_out=inner, outer_out=outer)
        again = kern(*row, *extra)
        if not all(torch.equal(a, b) for a, b in zip(out_k, again)):
            raise AssertionError(f"{name} {label} {dtype}: a repeated launch differs")
        if not all(bool(torch.isfinite(x).all()) for x in out_k):
            raise AssertionError(f"{name} {label} {dtype}: the kernel returned a non-finite value")
        host = lambda out: [x.cpu().numpy() for x in out]  # noqa: E731
        p_ms = None
        if key:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            plain(*row, *extra)
            end.record()
            end.synchronize()
            p_ms = start.elapsed_time(end)
        job = (kind, host(row), kk)
        out_p = pool.submit(_spectral_plain, job) if pool is not None else _spectral_plain(job)
        k_ms = time_graph_ms(lambda: kern(*row, *extra), reps=5, inner=5)
        inner, outer = inner.cpu().numpy(), outer.cpu().numpy()
        sub = min(k, geometry_rows) if n <= GEOMETRY_MAX_N else 0
        rows64 = [x[:sub].double().cpu().numpy() for x in row]
        jobs = [(kind, *r) for r in zip(*rows64)] if kk is None else [
            (kind, t, w, kk) for t, w in zip(*rows64)]
        refs = [pool.submit(_spectral_dist, j) for j in jobs] if pool is not None else [
            _spectral_dist(j) for j in jobs]
        pending.append(dict(
            name=name, label=label, dtype=dtype, kind=kind, kk=kk, key=key, k=k, n=n,
            rows=host(row), out_k=host(out_k), out_p=out_p, refs=refs, rows64=rows64,
            geo_tol=geo_tol, chain_ms=chain_ms(kind, inner, clock_hz), k_ms=k_ms, p_ms=p_ms,
            record={"ms": k_ms, "plain_ms": p_ms, "shape": label, "inner": int(inner.sum()),
                    "outer": int(outer.sum()), "inner_max": int(inner.max()),
                    "outer_max": int(outer.max()), "rows": k}))

    for dtype in dtypes:
        f32 = dtype == torch.float32
        geo_tol = 1e-4 if f32 else 3e-6
        for k, n in logdet_cases:
            rows = logdet_rows(k, n, seed=k + n)
            run("proj_logdet_vec", f"(k={k}, n={n})", dtype, rows, None, geo_tol,
                f32 and (k, n) == tuple(report_at["proj_logdet_vec"]))
        for label, *rows in logdet_inputs:
            run("proj_logdet_vec", label, dtype, rows, None, geo_tol, False)
        for k, n, kk, asc in sl_cases:
            rows = sl_rows(k, n, kk, seed=k + n + kk, ascending=asc)
            run("proj_sl_vec", f"(k={k}, n={n}, kk={kk}{', ascending' if asc else ''})", dtype,
                rows, kk, geo_tol, f32 and (k, n, kk) == tuple(report_at["proj_sl_vec"]))
        for label, t0, w0, kk in sl_inputs:
            run("proj_sl_vec", label, dtype, (t0, w0), kk, geo_tol, False)

    # the plain versions' answers and counts and the oracle's projections,
    # once every case is under way
    for c in pending:
        who, dtype = f"{c['name']} {c['label']} {c['dtype']}", c["dtype"]
        out_p, counts = c["out_p"] if isinstance(c["out_p"], tuple) else c["out_p"].result()
        flat = lambda out: np.concatenate(  # noqa: E731
            [np.asarray(x, np.float64).reshape(c["k"], -1) for x in out], 1)
        diff = np.abs(flat(c["out_k"]) - flat(out_p))
        scale = np.maximum(np.abs(flat(c["rows"])).max(1), 1.0)
        rows_err = diff.max(1) / scale
        over = rows_err > KERNEL_TOL[dtype]
        held = np.zeros_like(over)
        if dtype == torch.float32 and over.any():
            held[over] = f64_witness(c["kind"], c["kk"], [x[over] for x in c["rows"]],
                                     [x[over] for x in c["out_k"]], [x[over] for x in out_p],
                                     KERNEL_TOL[dtype])
        n_witness = int(held.sum())
        err, n_stray = float(rows_err.max()), int((over & ~held).sum())
        abs_err = float(diff.max())
        if n_stray > STRAY_ROWS * c["k"] or not err <= STRAY_TOL[dtype]:
            raise AssertionError(
                f"{who}: kernel disagrees with the plain version: {n_stray} of {c['k']} rows over "
                f"{KERNEL_TOL[dtype]:g} of max(1, |row|) (and not within it of the plain f32 "
                f"answer's distance from the plain f64 one), worst {err:.3e}")
        geo = ""
        if c["refs"]:
            sub = len(c["refs"])
            ref = np.array([r.result() if pool is not None else r for r in c["refs"]])
            cut = lambda out: [np.asarray(x[:sub], np.float64) for x in out]  # noqa: E731
            args = (c["kind"], c["rows64"])
            tols = (c["kk"], c["geo_tol"], INNER_TOL[dtype])
            bad_k, worst = geometry_spectral(*args, cut(c["out_k"]), ref, *tols)
            bad_p, _ = geometry_spectral(*args, cut(out_p), ref, *tols)
            if (bad_k & ~bad_p).any():
                raise AssertionError(
                    f"{who}: {int((bad_k & ~bad_p).sum())} of {sub} rows of the kernel's answer "
                    f"fail cone membership or lie farther from the row than the oracle's "
                    f"projection by more than {min(c['geo_tol'], INNER_TOL[dtype]):g} where the "
                    f"plain version's pass; worst excess {worst:.3e}")
            geo = (f"; f64 geometry on {sub} rows: in K, no farther than the oracle's projection "
                   f"(worst excess {worst:.2e} of 1 + |row|) but {int((bad_k & bad_p).sum())} "
                   f"where the plain version's fails too")
        bound = spectral_bound_ms(c["kind"], c["n"], dtype, counts, hbm_bytes_per_s, peak_flops)
        rec = c["record"]
        rec.update(bound_ms=bound[0], bound_by=bound[1], chain_ms=c["chain_ms"],
                   plain_inner=int(counts["inner"].sum()), plain_outer=int(counts["outer"].sum()),
                   plain_inner_max=int(counts["inner"].max()),
                   plain_outer_max=int(counts["outer"].max()))
        log(f"[3] {who[:-len(str(dtype))]}{str(dtype)[6:]}: max |kernel - plain| {err:.3e} of "
            f"max(1, |row|), {n_stray} rows over {KERNEL_TOL[dtype]:g} (absolute {abs_err:.3e}; "
            f"{n_witness} more held to the plain f64 answer), "
            f"repeat bit-equal{geo}; serial passes: kernel inner {rec['inner']} in all, at most "
            f"{rec['inner_max']} a row, outer {rec['outer']}, at most {rec['outer_max']}; plain map "
            f"inner {rec['plain_inner']}, at most {rec['plain_inner_max']}, outer "
            f"{rec['plain_outer']}, at most {rec['plain_outer_max']}; kernel {c['k_ms']:.4f} ms "
            "(graph replays), plain " + ("on the host" if c["p_ms"] is None else
                                         f"{c['p_ms']:.1f} ms") +
            f", bound {bound[0]:.6f} ms by {bound[1]}, serial chain {c['chain_ms']:.6f} ms")
        if c["key"]:
            report[c["name"]] = {"max_abs_err": abs_err, **rec}
    return report


def check_plain_on_card(log=print):
    """Every projection left as plain tensor code, on the card against the
    same function on the CPU, both in f64 (so that a difference is the
    library's: eigh, svd, sort, and not rounding), at the shapes of the two
    mixed-cone batches, with the wall time and the kernels of one call; and
    the library's batched eigh timed per shape in f32. Returns {label: eigh
    ms}."""
    from ..ops import projections as pr  # noqa: PLC0415

    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    sd = lambda n: n * (n + 1) // 2  # noqa: E731
    cases = [
        ("q (1280, 50)", pr._proj_soc_batch, (1280, 50)),
        ("s n=3 (64, 6)", lambda z: pr._proj_psd_batch(z, 3), (64, sd(3))),
        ("s n=10 (64, 55)", lambda z: pr._proj_psd_batch(z, 10), (64, sd(10))),
        ("s n=32 (512, 528)", lambda z: pr._proj_psd_batch(z, 32), (512, sd(32))),
        ("cs n=6 (64, 36)", lambda z: pr._proj_csd_batch(z, 6), (64, 36)),
        ("ell1 n=40 (64, 41)", pr._proj_ell1_batch, (64, 41)),
        ("nuc 8x5 (64, 41)", lambda z: pr._proj_nuc_batch(z, (8, 5)), (64, 41)),
    ]
    for label, fn, shape in cases:
        z = torch.as_tensor(rng.randn(*shape) * 2.0)
        zc = z.to(dev)
        on_card = fn(zc).cpu()  # also the warm-up: the library's handles and workspaces
        on_cpu = fn(z)
        err = float((on_card - on_cpu).abs().max())
        if not err <= 1e-9 * (1 + float(z.abs().max())):
            raise AssertionError(f"plain projection {label}: card and CPU differ by {err:.3e} in f64")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(zc)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[3] plain projection {label} f64: card against CPU max |diff| {err:.3e}; one call "
            f"on the card {secs * 1e3:.2f} ms of wall time, {_count_kernels(lambda: fn(zc))} kernels")
    eigh_ms = {}
    for k, n in ((64, 3), (64, 4), (64, 10), (512, 32)):
        a = torch.randn(k, n, n, device=dev)
        a = a + a.mT
        eigh_ms[f"({k}, {n}, {n})"] = _time_ms(lambda: torch.linalg.eigh(a))
    log("[3] torch.linalg.eigh f32 on the card, ms per call by shape: "
        + ", ".join(f"{k} {v:.3f}" for k, v in eigh_ms.items()))
    return eigh_ms


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if argv else MIXED_B
    if not torch.cuda.is_available():
        sys.exit("mixed_cone: PyTorch sees no CUDA device; this runs only on the card")
    from .. import BatchedSCS  # noqa: PLC0415
    from ..ops import _kernels  # noqa: PLC0415
    from ..ops import projections as pr  # noqa: PLC0415

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    _kernels.build_all()
    print(_kernels.build_log.get("cone_proj", ""))
    check_cone_kernels(3.35e12, {torch.float32: 67e12, torch.float64: 34e12})
    check_plain_on_card()
    data, p_star = gen_mixed_batch(MIXED_K, B, MIXED_SEED)
    t0 = time.perf_counter()
    solver = BatchedSCS(
        data, MIXED_K, dtype="float32", eps_abs=MIXED_EPS, eps_rel=MIXED_EPS,
        max_iters=20000, scale=1.0, device="cuda",
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    for f in (pr._proj_exp_batch, pr._proj_pow_batch, pr._proj_box):
        f.launches = 0
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    iters = np.array([r["info"]["iter"] for r in res])
    solved = sum(r["info"]["status"] == "solved" for r in res)
    err = np.abs(np.array([r["info"]["pobj"] for r in res]) - p_star)
    print(
        f"mixed_cone B = {B}: {solved}/{B} solved; setup {setup:.3f} s, solve {secs:.3f} s; "
        f"iterations mean {iters.mean():.1f}, max {iters.max()}; max |pobj - p*| {err.max():.3e}; "
        f"launches proj_exp {pr._proj_exp_batch.launches}, proj_pow {pr._proj_pow_batch.launches}"
    )
    print("worst (pri, dual, gap, dist s, dist y):", check_solutions(MIXED_K, data, res, MIXED_EPS))


if __name__ == "__main__":
    main()
