"""The spectral-cone projections' vector parts (logdet, sum-of-k-largest)
and phase 15's generators: scs_tpu_torch against scs_tpu.

Inputs are made with numpy from a seed and go through both packages on the
CPU (the JAX side jitted, as its solver runs it: CPU, x64). On the CPU the
wrappers _proj_logdet_vec_batch / _proj_sl_vec_batch are the plain
versions (_ref); the kernels of csrc/spectral_proj.cu (C4, C5) run only on
a card, in tests/test_torch_spectral_card.py, which holds them against the
plain versions.

Tolerances. f64: the port's plain versions equal scs_tpu's to 1e-10 of
1 + |scs_tpu's value| (the same operations in the same order; what is seen
is 1e-15 or less: the plain versions leave a bisection early only where
every later pass would repeat the last). f32: 2e-4 of max(1, |row|) per
row, as tests/test_torch_cones.py holds sl and logdet (a flipped comparison
in a bisection moves the answer by its bracket, and the roots amplify one
rounding). The first 25 iterates of a solve agree to 1e-7, as in
tests/test_torch_cones.py.
"""

import numpy as np
import pytest
import torch
from scipy import sparse

import jax
import jax.numpy as jnp

import oracle
import scs_tpu
import scs_tpu_torch
from scs_tpu.ops import projections as jpr
from scs_tpu_torch.cones import ConeSpec
from scs_tpu_torch.ops import projections as tpr
from scs_tpu_torch.tools import mixed_cone as mc

torch.set_num_threads(1)

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
WIDTHS = (1, 2, 3, 6, 17)
CHECK_INTERVAL = 25
CPU = dict(device="cpu")

_jit_logdet = jax.jit(jpr._proj_logdet_vec_batch)
_jit_sl = jax.jit(jpr._proj_sl_vec_batch, static_argnums=2)
_jit_simplex = jax.jit(jpr._proj_capped_simplex, static_argnums=1)


def _close(out_t, out_j, rows, dtype):
    """The port's answer (a tuple of tensors) against scs_tpu's, within the
    module docstring's limits."""
    flat = lambda out: np.concatenate(  # noqa: E731
        [np.asarray(x, np.float64).reshape(len(rows[0]), -1) for x in out], 1)
    t, j, v = flat(out_t), flat(out_j), flat(rows)
    assert t.shape == j.shape and np.isfinite(t).all()
    if dtype == "f64":
        np.testing.assert_array_less(np.abs(t - j), 1e-10 * (1 + np.abs(j)))
    else:
        scale = np.maximum(1.0, np.abs(v).max(1, keepdims=True))
        np.testing.assert_array_less(np.abs(t - j) / scale, 2e-4)


def _both(rows, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x, jdt) for x in rows],
            [torch.as_tensor(np.asarray(x), dtype=tdt) for x in rows])


# ---------------------------------------------------------------------------
# The plain versions against scs_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n, ascending", [(n, False) for n in WIDTHS] + [(17, True)])
def test_logdet_vec_matches_scs_tpu_in_every_regime(n, ascending, dtype):
    t0, v0, w0 = rows = mc.logdet_rows(14, n, seed=n + 3 * ascending)
    if ascending:
        rows = (t0, v0, np.sort(w0, 1))
    jin, tin = _both(rows, dtype)
    out_t = tpr._proj_logdet_vec_batch(*tin)
    _close(out_t, _jit_logdet(*jin), rows, dtype)
    if dtype == "f64":
        # every regime is there: rows kept (inside), sent to 0 (polar), onto
        # the v = 0 facet and onto the curved boundary (candidate C, which
        # also lands within rounding of the facet, at v ~ 1e-18)
        t, v, w = (x.numpy() for x in out_t)
        tiny = 1e-12 * (1 + np.abs(np.c_[t0, v0, w0]).max(1))
        kept = (t == rows[0]) & (v == rows[1])
        flat = np.abs(v) <= tiny
        zero = flat & (np.abs(t) <= 1e3 * tiny) & (np.abs(w).max(1) <= 1e3 * tiny)
        facet = flat & ~zero & ~kept
        assert kept.sum() >= 2 and zero.sum() >= 2 and facet.sum() >= 2
        assert (~flat & ~kept).sum() >= 4


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ascending", [False, True])
@pytest.mark.parametrize("n", WIDTHS)
def test_sl_vec_matches_scs_tpu_in_every_regime(n, ascending, dtype):
    for kk in sorted({1, max(1, n - 1)}):
        rows = mc.sl_rows(15, n, kk, seed=n + kk, ascending=ascending)
        jin, tin = _both(rows, dtype)
        out_t = tpr._proj_sl_vec_batch(*tin, kk)
        _close(out_t, _jit_sl(*jin, kk), rows, dtype)
        if dtype == "f64":
            t, w = (x.numpy() for x in out_t)
            inside = t == rows[0]
            assert inside.sum() >= 3 and (~inside).sum() >= 9
            # on the boundary where moved: the kk largest sum to t
            srt = np.sort(w[~inside], 1)[:, ::-1]
            np.testing.assert_allclose(srt[:, :kk].sum(1), t[~inside], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_capped_simplex_matches_scs_tpu(dtype):
    rng = np.random.RandomState(4)
    for n, kk in ((1, 1), (5, 2), (17, 16), (17, 1)):
        w = rng.randn(9, n) * 10.0 ** rng.uniform(-2, 2, (9, 1))
        w[::3] = np.round(w[::3])  # ties
        jin, tin = _both((w,), dtype)
        y = tpr._proj_capped_simplex(tin[0], kk)
        _close((y,), (_jit_simplex(jin[0], kk),), (w,), dtype)
        if dtype == "f64":
            np.testing.assert_allclose(y.numpy().sum(1), kk, rtol=1e-9)


def test_plain_versions_leave_a_bisection_only_when_it_is_frozen():
    """The plain versions' early exits give the fixed counts' answer bit for
    bit: a frozen bracket stays frozen."""
    t0, v0, w0 = (torch.as_tensor(x) for x in mc.logdet_rows(7, 4, seed=2))
    lo, hi = torch.tensor([0.0, 1.0]), torch.tensor([1.0, 1.0])
    mid = 0.5 * (lo + hi)
    up = torch.tensor([True, False])
    assert not tpr._frozen(lo, hi, *tpr._bisect_step(lo, mid, hi, up))
    assert tpr._frozen(lo[1:], hi[1:], *tpr._bisect_step(lo[1:], mid[1:], hi[1:], up[1:]))
    out = tpr._proj_logdet_vec_batch_ref(t0, v0, w0)
    again = tpr._proj_logdet_vec_batch_ref(t0, v0, w0, n_outer=200)  # past the frozen bracket
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    t0, w0 = (torch.as_tensor(x) for x in mc.sl_rows(10, 5, 2, seed=3))
    out = tpr._proj_sl_vec_batch_ref(t0, w0, 2)
    again = tpr._proj_sl_vec_batch_ref(t0, w0, 2, n_bisect=200)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


# ---------------------------------------------------------------------------
# The plain map's counts, C5's one ranking, the kernels' bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", (1, 6, 32))
@pytest.mark.parametrize("kind", ["logdet", "sl"])
def test_plain_counts_cut_the_bisections_to_the_same_bits(kind, n, dtype, monkeypatch):
    """The plain versions' per-row counts (the passes before each bracket
    froze): a row's bisections cut at its counts give its fixed-count
    answer bit for bit, asking for the counts changes no bit, and the
    answer stays scs_tpu's."""
    jin, tin = None, None
    if kind == "logdet":
        rows = mc.logdet_rows(7, n, seed=n + 1)
        ref, extra, cut = tpr._proj_logdet_vec_batch_ref, (), "n_outer"
        jin, tin = _both(rows, dtype)
        jax_out = _jit_logdet(*jin)
    else:
        kk = max(1, n // 3)
        rows = mc.sl_rows(10, n, kk, seed=n + 2)
        ref, extra, cut = tpr._proj_sl_vec_batch_ref, (kk,), "n_bisect"
        jin, tin = _both(rows, dtype)
        jax_out = _jit_sl(*jin, kk)
    counts = {}
    out = ref(*tin, *extra, counts=counts)
    assert all(torch.equal(a, b) for a, b in zip(out, ref(*tin, *extra)))
    _close(out, jax_out, rows, dtype)
    assert sorted(counts) == ["inner", "inner_bisect", "outer", "outer_bisect"]
    inside = counts["outer"] == 0  # rows already inside need no pass
    assert 0 < int(inside.sum()) < len(rows[0])
    moved = ~inside
    assert bool((counts["inner"][moved] >= counts["outer"][moved]).all())
    assert bool((counts["outer_bisect"][moved] < counts["outer"][moved]).all())  # + the final h
    assert bool((counts["inner_bisect"][moved] < counts["inner"][moved]).all())
    simplex = tpr._proj_capped_simplex
    for i in range(len(rows[0])):
        row = [x[i : i + 1] for x in tin]
        fixed = ref(*row, *extra)
        inner = int(counts["inner_bisect"][i])
        with monkeypatch.context() as m:  # the inner bisections cut at the row's count
            if kind == "logdet":
                m.setattr(tpr, "LOGDET_V_BISECTIONS", inner)
            else:
                m.setattr(tpr, "_proj_capped_simplex",
                          lambda w, k_val, n_bisect=60, passes=None: simplex(w, k_val, inner, passes))
            short = ref(*row, *extra, **{cut: int(counts["outer_bisect"][i])})
        assert all(torch.equal(a, b) for a, b in zip(fixed, short)), i
        assert all(torch.equal(a[0], b[i]) for a, b in zip(fixed, out)), i


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sum_of_largest_ranks_once(dtype):
    """C5's premise: w_at(x) = x - mu clamp(x / d - tau, 0, 1), d = max(mu,
    tiny), is nondecreasing in x, so the sum of the kk largest of the plain
    map's w_at(w0) is w_at summed over the kk largest entries of w0 (ties
    to the lower index), to n ulps of the row's magnitude; on rows with
    ties, negative rows, magnitudes 1e-3..1e3, at mu from 0 and below the
    type's smallest normal number up to 1e3 |w0|. Rows where w0 / d
    overflows (mu < tiny) have no finite w_at in the plain map either."""
    tdt = DTYPES[dtype][1]
    tiny, eps = torch.finfo(tdt).tiny, torch.finfo(tdt).eps
    for n, kk in ((1, 1), (6, 2), (17, 16), (32, 4)):
        t0, w0 = (torch.as_tensor(x, dtype=tdt) for x in mc.sl_rows(25, n, kk, seed=n))
        top = torch.sort(-w0, dim=1, stable=True).indices[:, :kk]
        mag = w0.abs().amax(1)
        for mu_s in (0.0, tiny / 4, tiny, 1e-30, 1e-6, 1e-3, 1.0, 1e3):
            mu = mu_s * mag if mu_s > 1e-20 else torch.full_like(mag, mu_s)
            d = torch.clamp_min(mu, tiny)
            w = w0 - mu[:, None] * tpr._proj_capped_simplex(w0 / d[:, None], kk)
            largest = torch.sort(w, dim=1, descending=True).values[:, :kk].sum(1)
            ranked = torch.gather(w, 1, top).sum(1)
            fin = torch.isfinite(w).all(1)
            assert bool(fin.all()) or mu_s <= tiny  # only w0 / tiny overflows
            scale = torch.maximum(mag, mu)[fin]
            assert bool(((largest - ranked)[fin].abs() <= n * eps * scale).all()), (n, mu_s)


@pytest.mark.parametrize("kind", ["d", "sl"])
def test_spectral_bound_is_the_roofline_of_the_plain_maps_work(kind):
    """check_spectral_kernels' bound (mixed_cone.spectral_bound_ms): the
    larger of the bytes (each row read and written once) over the memory
    rate and the plain algorithm's operations on the passes the rows need
    on the plain map over the peak rate; it takes the plain version's
    counts and nothing of the kernel's (whose counts set chain_ms, the
    kernel's serial floor, beside it)."""
    import inspect  # noqa: PLC0415
    import math  # noqa: PLC0415

    hbm, peak = 3.35e12, {torch.float32: 67e12, torch.float64: 34e12}
    assert list(inspect.signature(mc.spectral_bound_ms).parameters) == [
        "kind", "n", "dtype", "counts", "hbm_bytes_per_s", "peak_flops"]
    n, kk = 6, (None if kind == "d" else 2)
    rows = mc.logdet_rows(7, n, seed=4) if kind == "d" else mc.sl_rows(10, n, kk, seed=4)
    for dtype, np_dtype, item in ((torch.float32, np.float32, 4), (torch.float64, np.float64, 8)):
        _, counts = mc._spectral_plain((kind, [np.asarray(x, np_dtype) for x in rows], kk))
        inner, outer = int(counts["inner"].sum()), int(counts["outer"].sum())
        k = len(rows[0])
        if kind == "d":
            ops = inner * (n * 9 + 12) + outer * 8
            n_bytes = 2 * k * (n + 2) * item
        else:
            ops = inner * (n * 4 + 5) + outer * n * (9 + math.ceil(math.log2(n)))
            n_bytes = 2 * k * (n + 1) * item
        by_bytes, by_ops = n_bytes / hbm, ops / peak[dtype]
        assert inner > 0 and by_ops > by_bytes  # these rows are bound by their passes
        assert mc.spectral_bound_ms(kind, n, dtype, counts, hbm, peak) == (
            max(by_bytes, by_ops) * 1e3, "operations")
        # rows that need no pass (all inside) are bound by their bytes
        none = {key: np.zeros_like(c) for key, c in counts.items()}
        assert mc.spectral_bound_ms(kind, n, dtype, none, hbm, peak) == (by_bytes * 1e3, "bytes")
    # the kernel's serial floor reads the kernel's counts: its longest chain
    chain_ops = mc.LD_CHAIN_OPS if kind == "d" else mc.SL_CHAIN_OPS
    assert mc.chain_ms(kind, np.array([3, 900, 10]), 2e9) == 900 * chain_ops * 4 / 2e9 * 1e3


def test_f64_witness_holds_the_kernel_to_the_plain_f64_answer():
    """check_spectral_kernels' witness for an f32 row over KERNEL_TOL: row
    13 of logdet_rows(67, 64, seed=131) has the plain f32 answer 1.2e-3 of
    |row| off the plain f64 one; an answer at the f64 one passes there and
    only there; one moved 4e-3 of |row| off the plain f32 answer (so at
    least 2.8e-3 off the f64 one, past 1.2e-3 + KERNEL_TOL) fails."""
    tol = mc.KERNEL_TOL[torch.float32]
    rows = [np.asarray(x, np.float32)[[13, 18, 25]] for x in mc.logdet_rows(67, 64, seed=131)]
    out_p, _ = mc._spectral_plain(("d", rows, None))
    out64, _ = mc._spectral_plain(("d", [x.astype(np.float64) for x in rows], None))
    at64 = [x.astype(np.float32) for x in out64]
    assert mc.f64_witness("d", None, rows, at64, out_p, tol).tolist() == [True, False, False]
    far = [x.copy() for x in out_p]
    far[0][0] += 4e-3 * np.abs(np.concatenate([rows[0][:1], rows[1][:1], rows[2][0]])).max()
    assert not mc.f64_witness("d", None, rows, far, out_p, tol).any()


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    before = tpr._proj_logdet_vec_batch.launches, tpr._proj_sl_vec_batch.launches
    t0, v0, w0 = (torch.as_tensor(x) for x in mc.logdet_rows(7, 3, seed=1))
    for a, b in zip(tpr._proj_logdet_vec_batch(t0, v0, w0),
                    tpr._proj_logdet_vec_batch_ref(t0, v0, w0)):
        assert torch.equal(a, b)
    t0, w0 = (torch.as_tensor(x) for x in mc.sl_rows(5, 4, 2, seed=1))
    for a, b in zip(tpr._proj_sl_vec_batch(t0, w0, 2), tpr._proj_sl_vec_batch_ref(t0, w0, 2)):
        assert torch.equal(a, b)
    # the whole projections reach them through the wrappers
    z = torch.as_tensor(np.random.RandomState(0).randn(3, 8))
    tpr._proj_logdet_batch(z, 3)
    tpr._proj_sl_batch(z[:, :7], (3, 2))
    assert (tpr._proj_logdet_vec_batch.launches, tpr._proj_sl_vec_batch.launches) == before


def test_wrappers_raise_on_bad_input():
    w0 = torch.zeros(4, 3)
    t0 = torch.zeros(4)
    with pytest.raises(TypeError):
        tpr._proj_logdet_vec_batch(t0.int(), t0.int(), w0.int())
    with pytest.raises(TypeError):
        tpr._proj_sl_vec_batch(t0.half(), w0.half(), 1)
    with pytest.raises(ValueError):
        tpr._proj_logdet_vec_batch(t0, t0, torch.zeros(12))  # not (k, n)
    with pytest.raises(ValueError):
        tpr._proj_sl_vec_batch(t0, torch.zeros(4, 0), 1)  # n = 0
    with pytest.raises(ValueError):
        tpr._proj_logdet_vec_batch(torch.zeros(3), t0, w0)  # t0 of another length
    with pytest.raises(ValueError):
        tpr._proj_logdet_vec_batch(t0, t0.double(), w0)  # v0 of another type
    for kk in (0, 4, 1.5):
        with pytest.raises(ValueError):
            tpr._proj_sl_vec_batch(t0, w0, kk)
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tpr._proj_sl_vec_batch(torch.zeros(4, **meta), torch.zeros(4, 3, **meta), 1)
    with pytest.raises(ValueError):
        tpr._proj_logdet_vec_batch(torch.zeros(4, **meta), torch.zeros(4, **meta),
                                   torch.zeros(4, 3, **meta))


def test_capture_rows_copies_each_spectral_bucket():
    """CaptureRows counts the spectral wrappers' calls per width and kk, so
    that each bucket is copied, and hands them on as check inputs."""
    K = {"z": 1, "l": 2, "sl_n": [3, 2], "sl_k": [2, 1], "d": [2]}
    spec = ConeSpec.from_dict(K)
    proj = tpr.make_cone_projector(spec)
    wrappers = (tpr._proj_logdet_vec_batch, tpr._proj_sl_vec_batch)
    rng = np.random.RandomState(5)
    with mc.CaptureRows(every=2) as cap:
        for _ in range(5):
            proj(torch.as_tensor(rng.randn(2, spec.dim)))
    assert (tpr._proj_logdet_vec_batch, tpr._proj_sl_vec_batch) == wrappers
    assert cap.calls["logdet"] == 5 and cap.calls["sl"] == 10
    assert [c for c, *_ in cap.logdet] == [0, 2, 4]
    assert sorted((w.shape[1], kk, c) for c, _, w, kk in cap.sl) == [
        (2, 1, 0), (2, 1, 2), (2, 1, 4), (3, 2, 0), (3, 2, 2), (3, 2, 4)]
    ld_in, sl_in = cap.spectral_inputs("t")
    assert [x[0].split(",")[0] for x in ld_in] == ["t n=2 early", "t n=2 middle", "t n=2 late"]
    assert len(sl_in) == 6 and {x[3] for x in sl_in} == {1, 2}
    assert all(a.dtype == np.float64 for a in ld_in[0][1:] + sl_in[0][1:3])
    # the copies are the rows the wrappers were handed: the eigenvalues
    c, t0, v0, w0 = cap.logdet[0]
    assert t0.shape == v0.shape == (2,) and w0.shape == (2, 2)
    assert bool((w0[:, :-1] <= w0[:, 1:]).all())  # ascending, as eigh returns them


# ---------------------------------------------------------------------------
# Phase 15's generators, through both packages
# ---------------------------------------------------------------------------


def _first_iterates(data, K):
    """The first CHECK_INTERVAL iterations of a solve of `data` in both
    packages, f64, "direct", without acceleration (one projection an
    iteration: the plain spectral projections take ~0.5 s a call on the
    CPU); the iterate they end on compared."""
    kw = dict(eps_abs=1e-12, eps_rel=1e-12, verbose=False, max_iters=CHECK_INTERVAL,
              dtype="float64", acceleration_lookback=0)
    sj = scs_tpu.solve(data, K, **kw)
    st = scs_tpu_torch.solve(data, K, **CPU, **kw)
    assert st["info"]["status"] == sj["info"]["status"]
    assert st["info"]["iter"] == sj["info"]["iter"] == CHECK_INTERVAL
    for k in ("x", "y", "s"):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-7, atol=1e-7, err_msg=k)


def test_dopt_generator_first_iterates_match_scs_tpu():
    n, p = 4, 12
    data, V = mc.gen_dopt_batch(1, n, p, seed=11)
    K = mc.dopt_cone(n, p)
    assert data["A"].shape == (1, oracle.cone_dims(K), p + 1)
    single = {"A": sparse.csc_matrix(data["A"][0].astype(np.float64)), "b": data["b"][0],
              "c": data["c"][0]}
    _first_iterates(single, K)
    # the form: at a design lam and t = logdet X(lam), s = b - A x lies in K
    # (on the logdet cone's boundary), and c'x = -t
    lam = np.full(p, 1.0 / p)
    t = np.linalg.slogdet(V[0].T @ (lam[:, None] * V[0]))[1]
    x = np.r_[lam, t]
    s = single["b"] - single["A"] @ x
    np.testing.assert_allclose(s, oracle.proj_cone(s, K), atol=1e-6)
    assert single["c"] @ x == -t
    # at full size: m = 787, n_x = 257
    assert oracle.cone_dims(mc.dopt_cone(mc.DOPT_N, mc.DOPT_P)) == 787


def test_planted_spectral_generator_first_iterates_match_scs_tpu():
    K = {"z": 2, "l": 4, "sl_n": [4], "sl_k": [2], "d": [3]}
    data, p_star = mc.gen_mixed_batch(K, 1, seed=21, density=0.3)
    single = {"A": sparse.csc_matrix(data["A"][0]), "b": data["b"][0], "c": data["c"][0]}
    assert np.isfinite(p_star).all()
    _first_iterates(single, K)
    # phase 15 (b)'s cone: m = 840, n = 280
    assert oracle.cone_dims(mc.SPECTRAL_K) == 840


def test_kiefer_wolfowitz_gap():
    n = 5
    rng = np.random.RandomState(0)
    others = rng.randn(7, n)
    V = np.vstack([np.eye(n), others / np.linalg.norm(others, axis=1, keepdims=True)])
    lam = np.r_[np.full(n, 1.0 / n), np.zeros(7)]
    assert abs(mc.kiefer_wolfowitz_gap(V, lam)) <= 1e-12
    # clipped at 0 and renormalized first
    assert abs(mc.kiefer_wolfowitz_gap(V, np.r_[np.full(n, 2.0 / n), -1e-3 * np.ones(7)])) <= 1e-12
    lam2 = lam.copy()
    lam2[0], lam2[n] = lam[0] - 0.05, 0.05
    assert mc.kiefer_wolfowitz_gap(V, lam2) > 1e-3
    rel, gap = mc.dopt_check(V, np.r_[lam, np.linalg.slogdet(np.eye(n) / n)[1]])
    assert rel <= 1e-12 and abs(gap) <= 1e-12
    rel, _ = mc.dopt_check(V, np.r_[lam, np.linalg.slogdet(np.eye(n) / n)[1] + 0.1])
    assert abs(rel * (1 + abs(np.linalg.slogdet(np.eye(n) / n)[1] + 0.1)) - 0.1) <= 1e-12


@pytest.mark.slow
def test_spectral_solve_end_to_end_matches_scs_tpu():
    """One whole f64 solve over a logdet cone and a sum-of-largest cone, to
    eps, in both packages: max logdet X2 - (sum of the 2 largest
    eigenvalues of X1) over the two epigraphs, as tests/test_coverage.py
    poses each alone. The same status, the objective within 10 eps of
    scs_tpu's and of the closed form, and the KKT conditions at eps, s in K
    and y in K* by the oracle. Slow tier: the plain spectral projections
    take ~0.5 s an iteration on the CPU, and the port's 50 iterations
    alone take ~26 s (both solves together 32-44 s)."""
    rng = np.random.RandomState(14)
    M = rng.randn(3, 3)
    X1 = M + M.T
    G = rng.randn(2, 2)
    X2 = G @ G.T + 0.5 * np.eye(2)
    # the logdet cone's rows come first: (t2, 1, X2); then (t1, X1)
    ld = np.concatenate([[0.0, 1.0], oracle._pack_sym(X2)])
    sl = np.concatenate([[0.0], oracle._pack_sym(X1)])
    A = np.zeros((len(ld) + len(sl), 2))
    A[0, 1] = A[len(ld), 0] = -1.0
    data = {"A": sparse.csc_matrix(A), "b": np.concatenate([ld, sl]),
            "c": np.array([1.0, -1.0])}
    K = {"d": [2], "sl_n": [3], "sl_k": [2]}
    p_star = np.sort(np.linalg.eigvalsh(X1))[-2:].sum() - np.linalg.slogdet(X2)[1]
    eps = 1e-5
    kw = dict(eps_abs=eps, eps_rel=eps, verbose=False, dtype="float64", max_iters=20000)
    sj = scs_tpu.solve(data, K, **kw)
    st = scs_tpu_torch.solve(data, K, **CPU, **kw)
    assert st["info"]["status"] == sj["info"]["status"] == "solved"
    tol = 10 * eps * (1 + abs(p_star))
    assert abs(st["info"]["pobj"] - sj["info"]["pobj"]) <= tol
    assert abs(st["info"]["pobj"] - p_star) <= tol
    A, b, c = data["A"].toarray(), data["b"], data["c"]
    x, y, s = st["x"], st["y"], st["s"]
    assert np.linalg.norm(A @ x + s - b) <= eps * (1 + max(np.linalg.norm(A @ x),
                                                          np.linalg.norm(s), np.linalg.norm(b)))
    assert np.linalg.norm(A.T @ y + c) <= eps * (1 + max(np.linalg.norm(A.T @ y),
                                                        np.linalg.norm(c)))
    assert abs(c @ x + b @ y) <= eps * (1 + max(abs(c @ x), abs(b @ y)))
    np.testing.assert_allclose(s, oracle.proj_cone(s, K), atol=10 * eps)
    np.testing.assert_allclose(y, oracle.proj_dual_cone(y, K), atol=10 * eps)
