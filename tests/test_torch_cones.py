"""Every cone projection of scs_tpu_torch against scs_tpu's, and curved-cone
solves end to end.

Inputs are made with numpy from a seed and go through both packages on the
CPU (the JAX side as tests/test_projections.py runs it: CPU, x64).

Tolerances. In f64 a projection of the port equals scs_tpu's to 1e-9 of
1 + |reference| (the aim; what is seen is 1e-13 or less: the two run the
same operations in the same order, and differ by the libraries' log/exp,
eigh and summation order). In f32 the limit is 2e-4 of max(1, |v|) per row
for the scalar iterations (a flipped comparison in a bisection moves the
answer by its bracket; the exp cone's near-boundary rows and the power
cone's unsettled Newton rows are the reference's own ill-conditioned cases,
scs_tpu/ops/projections.py:321-328, 353-358, 372-376) and 2e-5 of 1 + |v|
elsewhere. Against tests/oracle.py the limits are those of
tests/test_projections.py.

End to end (f64, CPU): same status, iteration counts within one
check_interval, objectives to 1e-6 relative; iterates of a short mixed-cone
run to 1e-7.
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
from scs_tpu.cones import ConeSpec as JConeSpec
from scs_tpu.ops import projections as jpr
from scs_tpu_torch.cones import ConeSpec, sd_cone_size
from scs_tpu_torch.ops import projections as tpr
from scs_tpu_torch.tools import mixed_cone as mc

torch.set_num_threads(1)

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# the scs_tpu bench's mixed_cone K, and a K with every kind of cone
BENCH_K = mc.MIXED_K
EVERY_K = {
    "z": 3, "l": 4, "bu": [1.0, np.inf, 2.0], "bl": [-1.0, 0.0, -np.inf],
    "q": [5, 3, 5, 1], "s": [3, 1, 4, 3], "cs": [2, 1, 3], "ep": 3, "ed": 2,
    "p": [-0.25, 0.5, 0.75, -0.33], "d": [3], "nuc_m": [3], "nuc_n": [2],
    "ell1": [4], "sl_n": [4], "sl_k": [2],
}


def _t(x, tdt):
    return torch.as_tensor(np.asarray(x), dtype=tdt)


def _close(out_t, out_j, v, dtype, f32_tol=2e-5):
    """|port - scs_tpu| within the module docstring's limits."""
    out_t, out_j = np.asarray(out_t, np.float64), np.asarray(out_j, np.float64)
    assert out_t.shape == out_j.shape
    assert np.isfinite(out_t).all()
    if dtype == "f64":
        np.testing.assert_array_less(np.abs(out_t - out_j), 1e-9 * (1 + np.abs(out_j)))
    else:
        scale = np.maximum(1.0, np.abs(np.asarray(v, np.float64)).max(axis=-1, keepdims=True))
        np.testing.assert_array_less(np.abs(out_t - out_j) / scale, f32_tol)


# ---------------------------------------------------------------------------
# Each projection against scs_tpu's
# ---------------------------------------------------------------------------


def _rows(k, size, seed, scale=2.0):
    return np.random.RandomState(seed).randn(k, size) * scale


BATCH_CASES = {
    "soc1": (lambda: _rows(6, 1, 1), "_proj_soc_batch", ()),
    "soc3": (lambda: _rows(16, 3, 2), "_proj_soc_batch", ()),
    "soc7": (lambda: _rows(16, 7, 3), "_proj_soc_batch", ()),
    "psd2": (lambda: _rows(8, sd_cone_size(2), 4), "_proj_psd_batch", (2,)),
    "psd5": (lambda: _rows(8, sd_cone_size(5), 5), "_proj_psd_batch", (5,)),
    "psd10": (lambda: _rows(4, sd_cone_size(10), 6), "_proj_psd_batch", (10,)),
    "csd2": (lambda: _rows(8, 4, 7), "_proj_csd_batch", (2,)),
    "csd4": (lambda: _rows(8, 16, 8), "_proj_csd_batch", (4,)),
    "ell1": (lambda: _rows(16, 8, 9), "_proj_ell1_batch", ()),
    "ell1_big": (lambda: _rows(16, 8, 10, 20.0), "_proj_ell1_batch", ()),
    "nuc": (lambda: _rows(8, 13, 11), "_proj_nuc_batch", ((4, 3),)),
    "sl": (lambda: _rows(6, sd_cone_size(4) + 1, 12), "_proj_sl_batch", ((4, 2),)),
    "logdet": (lambda: _rows(6, sd_cone_size(3) + 2, 13), "_proj_logdet_batch", (3,)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_projection_matches_scs_tpu(case, dtype):
    make, name, args = BATCH_CASES[case]
    jdt, tdt = DTYPES[dtype]
    z = make()
    out_j = getattr(jpr, name)(jnp.asarray(z, jdt), *args)
    out_t = getattr(tpr, name)(_t(z, tdt), *args)
    assert out_t.dtype == tdt
    # f32: eigh, svd and the nested bisections of sl / logdet amplify one
    # rounding to ~1e-4 of the row
    _close(out_t, out_j, z, dtype, f32_tol=2e-4 if case in ("sl", "logdet", "nuc") else 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_projection_matches_scs_tpu_in_every_regime(dtype):
    jdt, tdt = DTYPES[dtype]
    v = mc.exp_rows(700, seed=1)
    out_j = np.asarray(jpr._proj_exp_batch(jnp.asarray(v, jdt)))
    out_t = tpr._proj_exp_batch(_t(v, tdt)).numpy()
    _close(out_t, out_j, v, dtype, f32_tol=2e-4)
    # every regime is there: rows returned as they are (inside), zeroed
    # (polar), with s set to 0 (analytic), and moved (bisection)
    same = (out_t == np.asarray(v, out_t.dtype)).all(1)
    zero = (out_t == 0).all(1)
    assert same.sum() >= 90 and zero.sum() >= 90 and (~same & ~zero).sum() >= 300


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pow_projection_matches_scs_tpu_in_every_regime(dtype):
    """In f64 the port equals scs_tpu (1e-9). In f32 scs_tpu's Newton clips a
    first overshooting step onto r = |z| and cannot leave it (the next steps
    are below an f32 ulp), so ~1-2% of its rows are no projection; the port
    halves towards the bound instead. So the port's f32 answer is held to
    scs_tpu's f64 answer on every row (2e-4 of max(1, |v|)), and to
    scs_tpu's f32 answer on the rows where that one is right."""
    jdt, tdt = DTYPES[dtype]
    v, a, _ = mc.pow_rows(500, seed=2)
    v32, a32 = (np.asarray(x, np.float32).astype(np.float64) for x in (v, a))
    out_t = tpr._proj_pow_batch(_t(v, tdt), _t(a, tdt)).numpy()
    if dtype == "f64":
        out_j = np.asarray(jpr._proj_pow_batch(jnp.asarray(v, jdt), jnp.asarray(a, jdt)))
        _close(out_t, out_j, v, dtype)
        return
    truth = np.asarray(jpr._proj_pow_batch(jnp.asarray(v32), jnp.asarray(a32)))
    out_j = np.asarray(jpr._proj_pow_batch(jnp.asarray(v, jdt), jnp.asarray(a, jdt)), np.float64)
    scale = np.maximum(1.0, np.abs(v).max(1))
    err_t = np.abs(out_t.astype(np.float64) - truth).max(1) / scale
    err_j = np.abs(out_j - truth).max(1) / scale
    assert err_t.max() <= 2e-4
    good = err_j <= 2e-5  # rows on which scs_tpu's f32 run is right
    assert good.mean() >= 0.95
    assert (np.abs(out_t.astype(np.float64) - out_j).max(1) / scale)[good].max() <= 2e-4


def test_exp_degenerate_ray():
    """tests/test_mixed_cone_f32.py's collapsed row: the limit point."""
    v = np.array([[-15.92210628, 0.34189767, -7.81484659]])
    out = tpr._proj_exp_batch(_t(v, torch.float64)).numpy()
    np.testing.assert_allclose(out, np.asarray(jpr._proj_exp_batch(jnp.asarray(v))), atol=1e-12)
    assert 0.0 <= out[0][2] < 1e-12


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("per_row", [False, True])
def test_box_projection_matches_scs_tpu(per_row, dtype):
    jdt, tdt = DTYPES[dtype]
    v, bl, bu = mc.box_case(5, 37, seed=3, per_row=per_row)
    out_t = tpr._proj_box(_t(v, tdt), _t(bl, tdt), _t(bu, tdt)).numpy()
    rows = []
    for i in range(len(v)):
        lo, hi = (bl[i], bu[i]) if per_row else (bl, bu)
        rows.append(np.asarray(jpr._proj_box(
            jnp.asarray(v[i], jdt), jnp.asarray(lo, jdt), jnp.asarray(hi, jdt))))
    _close(out_t, np.stack(rows), v, dtype)
    # one problem alone, (bsize,) in and out, gives its row of the batch
    lo, hi = (bl[2], bu[2]) if per_row else (bl, bu)
    one = tpr._proj_box(_t(v[2], tdt), _t(lo, tdt), _t(hi, tdt)).numpy()
    np.testing.assert_array_equal(one, out_t[2])
    assert np.isinf(bl).any() and np.isinf(bu).any()


def test_box_shared_and_per_row_bounds_agree():
    v, bl, bu = mc.box_case(6, 50, seed=4)
    shared = tpr._proj_box(_t(v, torch.float64), _t(bl, torch.float64), _t(bu, torch.float64))
    rows = tpr._proj_box(
        _t(v, torch.float64), _t(np.tile(bl, (6, 1)), torch.float64),
        _t(np.tile(bu, (6, 1)), torch.float64),
    )
    assert torch.equal(shared, rows)
    bad, worst = mc.geometry_box(v, shared.numpy(), bl, bu, tol=1e-9)
    assert not bad.any() and worst <= 1e-9


# ---------------------------------------------------------------------------
# Two-cycles: the kernels leave a Newton iteration whose iterate alternates
# between two values (t_{k+1} == t_{k-1}) and return the one the fixed count
# ends on, chosen by the parity of the steps left. These tests hold that
# premise against the plain versions, which run the fixed count.
# ---------------------------------------------------------------------------


def _parity_points(iterates, n_fixed):
    """iterates (n_fixed + 1, rows): t_0 .. t_{n_fixed} of a map, one column
    a row. Per row, the first step k >= 1 with t_{k+1} == t_{k-1} != t_k,
    and the point the kernels return there: t_{k+1} if the steps left after
    step k + 1 are even, else t_k."""
    ks, points = [], []
    for col in iterates.T:
        k = next(k for k in range(1, n_fixed) if col[k + 1] == col[k - 1] != col[k])
        ks.append(k)
        points.append(col[k + 1] if (n_fixed - 1 - k) % 2 == 0 else col[k])
    return np.array(ks), np.array(points)


def _box_cycling_rows(tdt):
    """Rows of mc.box_case whose plain projection ends on a two-cycle."""
    v, bl, bu = mc.box_case(400, 20, seed=3, per_row=True)
    t = [tpr._proj_box_ref(_t(v, tdt), _t(bl, tdt), _t(bu, tdt), n_iters=n)[:, 0].numpy()
         for n in (98, 99, 100)]
    rows = (t[0] == t[2]) & (t[0] != t[1])
    return v[rows], bl[rows], bu[rows]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_box_two_cycle_ends_on_the_parity_point(dtype):
    jdt, tdt = DTYPES[dtype]
    v, bl, bu = _box_cycling_rows(tdt)
    assert len(v) >= 10  # a tenth of the rows cycle, in f32 and f64 alike
    tv, tl, tu = _t(v, tdt), _t(bl, tdt), _t(bu, tdt)
    # every row cycles, so no step of the batch is a fixed point of all of
    # them and n_iters = k gives each row's k-th iterate
    iterates = np.stack([tpr._proj_box_ref(tv, tl, tu, n_iters=k)[:, 0].numpy()
                         for k in range(tpr.BOX_NEWTON_ITERS + 1)])
    t98, t99, t100 = iterates[98], iterates[99], iterates[100]
    np.testing.assert_array_equal(t98, t100)
    assert (t99 != t100).all()
    ks, points = _parity_points(iterates, tpr.BOX_NEWTON_ITERS)
    np.testing.assert_array_equal(points, t100)
    assert ks.max() < 90  # the cycle starts well before the fixed count ends
    # the whole projection is the one at the parity point's t, and scs_tpu's
    # fixed count lands there too
    out = tpr._proj_box_ref(tv, tl, tu).numpy()
    np.testing.assert_array_equal(out[:, 0], points)
    ref = np.stack([np.asarray(jpr._proj_box(jnp.asarray(v[i], jdt), jnp.asarray(bl[i], jdt),
                                             jnp.asarray(bu[i], jdt))) for i in range(len(v))])
    _close(out, ref, v, dtype)


def _exp_newton_cycling(tdt, n=20000, seed=0):
    """Inputs (rho, y_hat, z_hat, w) of the inner Newton whose plain run
    ends on a two-cycle."""
    rng = np.random.RandomState(seed)
    mag = lambda: 10.0 ** rng.uniform(-3, 3, n)  # noqa: E731
    rho = 10.0 ** rng.uniform(-4, 4, n)
    y, z, w = rng.randn(n) * mag(), rng.randn(n) * mag(), rng.randn(n) * mag()
    args = [_t(a, tdt) for a in (rho, y, z, w)]
    t = [tpr._exp_newton_onz(*args, n_iters=k).numpy() for k in (38, 39, 40)]
    rows = (t[0] == t[2]) & (t[0] != t[1])
    return [a[rows] for a in (rho, y, z, w)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_newton_two_cycle_ends_on_the_parity_point(dtype):
    jdt, tdt = DTYPES[dtype]
    rho, y, z, w = _exp_newton_cycling(tdt)
    assert len(rho) >= 100  # about one inner solve in seven cycles here
    args = [_t(a, tdt) for a in (rho, y, z, w)]
    iterates = np.stack([tpr._exp_newton_onz(*args, n_iters=k).numpy()
                         for k in range(tpr.EXP_NEWTON_ITERS + 1)])
    np.testing.assert_array_equal(iterates[38], iterates[40])
    assert (iterates[39] != iterates[40]).all()
    ks, points = _parity_points(iterates, tpr.EXP_NEWTON_ITERS)
    np.testing.assert_array_equal(points, iterates[40])
    assert ks.min() < 20  # many cycles start early: the steps an exit saves
    if dtype == "f64":
        # scs_tpu's fixed count of 40 lands on the same point (in f32 the two
        # points of a cycle can lie far apart, and XLA's fused arithmetic
        # can fall into another cycle than PyTorch's)
        ref = np.asarray(jpr._exp_newton_onz(*(jnp.asarray(a, jdt) for a in (rho, y, z, w))))
        _close(iterates[40][:, None], ref[:, None], np.stack([rho, y, z, w], 1), dtype)


def _exit_points(iterates, n_fixed, plain_steps=0):
    """The kernels' exit from a Newton iteration of n_fixed steps
    (newton_fixed_count in csrc/cone_proj.cu, whose first `plain_steps`
    steps test for a fixed point alone), replayed on iterates
    (n_fixed + 1, rows): per row (the step i at which the loop leaves:
    t_{i+1} repeats t_i, or, from step plain_steps on, t_i repeats t_{i-2}
    or the checkpoint kept at the powers of two; n_fixed if nothing
    repeats; the period p, 1 for a fixed point, 0 where nothing repeats;
    the point returned: t_i stepped on (n_fixed - i) mod p times on a
    cycle)."""
    out = []
    for col in iterates.T:
        t, prev, prev2, saved = col[0], np.nan, np.nan, np.nan
        at = seen = 0
        res = (n_fixed, 0, col[n_fixed])
        for i in range(n_fixed):
            if i < plain_steps:
                if col[i + 1] == t:
                    res = (i, 1, t)
                    break
                t = col[i + 1]
                continue
            cycle = t == prev2 or t == saved
            seen = at
            if i & (i - 1) == 0:
                saved, at = t, i
            if col[i + 1] == t or cycle:
                p = (2 if t == prev2 else i - seen) if cycle else 1
                res = (i, p, col[i + (n_fixed - i) % p] if cycle else t)
                break
            prev2, prev, t = prev, t, col[i + 1]
        out.append(res)
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_box_cycles_of_any_period_end_where_the_fixed_count_does(dtype):
    _, tdt = DTYPES[dtype]
    v, bl, bu = (_t(a, tdt) for a in mc.box_case(2000, 20, seed=5, per_row=True))
    iterates = np.stack([tpr._proj_box_ref(v, bl, bu, n_iters=k)[:, 0].numpy()
                         for k in range(tpr.BOX_NEWTON_ITERS + 1)])
    exits = _exit_points(iterates, tpr.BOX_NEWTON_ITERS)
    np.testing.assert_array_equal([pt for *_, pt in exits], iterates[-1])
    periods = [p for _, p, _ in exits]
    assert periods.count(2) >= 100 and sum(p >= 3 for p in periods) >= 3
    assert max(i for i, p, _ in exits if p) < 60  # the exits come early


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_newton_cycles_of_any_period_end_where_the_fixed_count_does(dtype):
    _, tdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    n = 5000
    mag = lambda: 10.0 ** rng.uniform(-3, 3, n)  # noqa: E731
    args = [_t(a, tdt) for a in (10.0 ** rng.uniform(-4, 4, n), rng.randn(n) * mag(),
                                 rng.randn(n) * mag(), rng.randn(n) * mag())]
    iterates = np.stack([tpr._exp_newton_onz(*args, n_iters=k).numpy()
                         for k in range(tpr.EXP_NEWTON_ITERS + 1)])
    # with the cycle tests from the first step, and from step 4 on as
    # proj_exp runs them (kExpPlainSteps)
    for plain_steps in (0, 4):
        exits = _exit_points(iterates, tpr.EXP_NEWTON_ITERS, plain_steps)
        np.testing.assert_array_equal([pt for *_, pt in exits], iterates[-1])
        periods = np.array([p for _, p, _ in exits])
        # periods of 3 and more are common here, and the exits save steps
        assert (periods >= 3).sum() >= 0.1 * n
        assert np.mean([i + 1 if p else 40 for i, p, _ in exits]) < 15


def _proj_pow_batch_ref_before(v, a, n_iters=tpr.POW_NEWTON_ITERS):
    """_proj_pow_batch_ref as it was written before its Newton step became
    tpr._pow_newton_step, line for line."""
    x0, y0, z0 = v[:, 0], v[:, 1], v[:, 2]
    tiny = tpr._tiny(v)
    b = 1 - a

    def safe_pow(base, e):
        return torch.exp(e * torch.log(torch.clamp_min(base, tiny)))

    in_cone = (x0 >= 0) & (y0 >= 0) & (safe_pow(x0, a) * safe_pow(y0, b) >= torch.abs(z0))
    in_polar = (
        (x0 <= 0) & (y0 <= 0)
        & (safe_pow(-x0 / a, a) * safe_pow(-y0 / b, b) >= torch.abs(z0))
    )
    rh = torch.abs(z0)

    def calc_x(r, xh, aa):
        return torch.clamp_min(0.5 * (xh + torch.sqrt(xh * xh + 4.0 * aa * (rh - r) * r)), 1e-12)

    r = rh / 2.0
    for _ in range(n_iters):
        x = calc_x(r, x0, a)
        y = calc_x(r, y0, b)
        xy = safe_pow(x, a) * safe_pow(y, b)
        f = xy - r
        dxdr = a * (rh - 2.0 * r) / (2.0 * x - x0)
        dydr = b * (rh - 2.0 * r) / (2.0 * y - y0)
        fp = xy * (a * dxdr / x + b * dydr / y) - 1.0
        step = r - f / fp
        r_new = torch.where(step > rh, 0.5 * (r + rh), torch.where(step < 0, 0.5 * r, step))
        r_new = torch.where(torch.abs(f) < 1e-12, r, r_new)
        if torch.equal(r_new, r):
            break
        r = r_new
    out = torch.stack([calc_x(r, x0, a), calc_x(r, y0, b), torch.sign(z0) * r], dim=1)
    out = tpr._where_rows(in_polar, torch.zeros((), dtype=v.dtype), out)
    return tpr._where_rows(in_cone, v, out)


def _pow_iterates(tdt, k, seed):
    """r_0 .. r_40 of the power cone's Newton map (tpr._pow_newton_step) on
    mc.pow_rows(k, seed), the dual rows negated as the wrapper hands them
    on: (41, k)."""
    v, a, sign = mc.pow_rows(k, seed=seed)
    v, a = _t(v * sign[:, None], tdt), _t(a, tdt)
    rh = v[:, 2].abs()
    r = rh / 2.0
    iterates = [r]
    for _ in range(tpr.POW_NEWTON_ITERS):
        r = tpr._pow_newton_step(r, v[:, 0], v[:, 1], a, rh)
        iterates.append(r)
    return np.stack([t.numpy() for t in iterates])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pow_newton_step_is_the_plain_versions_step(dtype):
    """The factored step leaves _proj_pow_batch_ref's answers bit for bit
    as they were, at the fixed count and short of it, and iterating it
    gives the r the plain version ends on."""
    _, tdt = DTYPES[dtype]
    v, a, sign = mc.pow_rows(500, seed=2)
    tv, ta = _t(v * sign[:, None], tdt), _t(a, tdt)
    for n in (1, 7, tpr.POW_NEWTON_ITERS):
        np.testing.assert_array_equal(tpr._proj_pow_batch_ref(tv, ta, n_iters=n).numpy(),
                                      _proj_pow_batch_ref_before(tv, ta, n_iters=n).numpy())
    iterates = _pow_iterates(tdt, 500, seed=2)
    out = tpr._proj_pow_batch_ref(tv, ta).numpy()
    moved = ~(out == tv.numpy()).all(1) & ~(out == 0).all(1)
    assert moved.sum() >= 150
    np.testing.assert_array_equal(np.abs(out[moved, 2]), iterates[-1][moved])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pow_newton_two_cycle_ends_on_the_parity_point(dtype):
    _, tdt = DTYPES[dtype]
    iterates = _pow_iterates(tdt, 20000, seed=0)
    rows = (iterates[38] == iterates[40]) & (iterates[38] != iterates[39])
    assert rows.sum() >= (500 if dtype == "f32" else 50)
    ks, points = _parity_points(iterates[:, rows], tpr.POW_NEWTON_ITERS)
    np.testing.assert_array_equal(points, iterates[40][rows])
    assert ks.min() < 10  # many cycles start early: the steps an exit saves


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pow_newton_cycles_of_any_period_end_where_the_fixed_count_does(dtype):
    _, tdt = DTYPES[dtype]
    iterates = _pow_iterates(tdt, 20000, seed=5)
    # newton_fixed_count's exits, with the cycle tests from the first step
    # and from the fourth on (as proj_exp runs them)
    for plain_steps in (0, 4):
        exits = _exit_points(iterates, tpr.POW_NEWTON_ITERS, plain_steps)
        np.testing.assert_array_equal([pt for *_, pt in exits], iterates[-1])
        periods = np.array([p for _, p, _ in exits])
        assert (periods >= 3).sum() >= (300 if dtype == "f32" else 30)
        assert (periods == 2).sum() >= (1000 if dtype == "f32" else 50)
        # the exits leave the rows within half the fixed count on average
        assert np.mean([i + 1 if p else 40 for i, p, _ in exits]) < 20


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pow_repeat_steps_find_each_rows_first_repeat(dtype):
    """mc.pow_repeat_steps, the count of proj_pow's bound: per row the
    first step whose r repeats an earlier one, at the smallest period, and
    the 40-step count's point known from there."""
    _, tdt = DTYPES[dtype]
    v, a, sign = mc.pow_rows(2000, seed=4)
    steps, period = (t.numpy() for t in mc.pow_repeat_steps(_t(v, tdt), _t(a, tdt), _t(sign, tdt)))
    iterates = _pow_iterates(tdt, 2000, seed=4)
    in_cone, in_polar = tpr._pow_cases(_t(v * sign[:, None], tdt), _t(a, tdt))
    newton = ~(in_cone | in_polar).numpy()
    assert (steps[~newton] == 0).all() and (period[~newton] == 0).all()
    n = tpr.POW_NEWTON_ITERS
    for j in np.flatnonzero(newton):
        col = iterates[:, j]
        first = next(((i, i - q) for i in range(1, n + 1) for q in reversed(range(i))
                      if col[i] == col[q]), (n, 0))
        assert (steps[j], period[j]) == first
        if period[j]:
            i, p = first
            assert col[n] == col[i - p + (n - i) % p]
    assert (period == 1).sum() >= 300
    assert (period >= 2).sum() >= (100 if dtype == "f32" else 5)


def test_exp_group_fills_the_card():
    """proj_exp's lanes a cone: the largest G of EXP_GROUPS whose
    threads stay within EXP_FILL_THREADS, one lane when none does."""
    for k in (1, 7, 640, 1280, 2561, 4224, 9600, 19200, 20481, 38400, 10**6):
        g = tpr.exp_group(k)
        assert g in tpr.EXP_GROUPS
        assert g == 1 or k * g <= tpr.EXP_FILL_THREADS
        assert all(k * h > tpr.EXP_FILL_THREADS for h in tpr.EXP_GROUPS if h > g)
    assert [tpr.exp_group(k) for k in (1280, 9600, 19200, 38400, 10**6)] == [32, 8, 4, 1, 1]


def test_capture_rows_copies_every_nth_call_and_puts_the_wrappers_back():
    K = {"z": 2, "l": 6, "bu": [1.0, np.inf, 2.0], "bl": [-1.0, 0.0, -np.inf], "ep": 2, "ed": 1,
         "p": [0.3, -0.6]}
    data, _ = _mixed_batch(2, K)
    wrappers = (tpr._proj_exp_batch, tpr._proj_pow_batch, tpr._proj_box)
    with mc.CaptureRows(every=4) as cap:
        scs_tpu_torch.BatchedSCS(data, K, device="cpu", max_iters=30).solve()
    assert (tpr._proj_exp_batch, tpr._proj_pow_batch, tpr._proj_box) == wrappers
    assert [c for c, *_ in cap.exp] == list(range(0, 4 * len(cap.exp), 4))
    assert [c for c, *_ in cap.pow] == [c for c, *_ in cap.exp]
    assert len(cap.exp) == len(cap.box) == len(cap.pow) >= 3
    c, v, sign = cap.exp[1]
    assert v.shape == (2 * 3, 3) and sign.tolist() == [1.0, 1.0, -1.0] * 2
    c, v, a, sign = cap.pow[1]
    assert v.shape == (2 * 2, 3) and sign.tolist() == [1.0, -1.0] * 2
    np.testing.assert_allclose(a.numpy(), [0.3, 0.6] * 2)
    c, v, bl, bu = cap.box[1]
    assert v.shape == (2, 4) and bl.shape == bu.shape == (2, 3)
    phases = cap.phases("box")
    assert [phases[p][0] for p in ("early", "middle", "late")] == [
        cap.box[1][0], cap.box[len(cap.box) // 2][0], cap.box[-1][0]]
    exp_in, box_in, pow_in = cap.inputs("t")
    assert [x[0].split(",")[0] for x in exp_in] == ["t early", "t middle", "t late"]
    assert [x[0].split(",")[0] for x in pow_in] == ["t early", "t middle", "t late"]
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float64 for a in box_in[0][1:])
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float64 for a in pow_in[0][1:])
    # a wrapper counts its launches through its module name: inside the
    # block that count still lands on the wrapper's own counter
    for fn in wrappers:
        before = fn.launches
        with mc.CaptureRows():
            getattr(tpr, fn.__name__).launches += 2
        assert fn.launches == before + 2
        fn.launches = before
    # the copies are the rows the projector was handed
    spec = ConeSpec.from_dict(K)
    z = torch.as_tensor(np.random.RandomState(2).randn(2, spec.dim))
    with mc.CaptureRows(every=1) as cap:
        tpr.make_cone_projector(spec)(z)
    np.testing.assert_array_equal(cap.box[0][1].numpy(), z[:, 8:12].numpy())  # the box segment
    np.testing.assert_array_equal(cap.exp[0][1].numpy(), z[:, 12:21].reshape(6, 3).numpy())
    np.testing.assert_array_equal(cap.pow[0][1].numpy(), z[:, 21:27].reshape(4, 3).numpy())


# ---------------------------------------------------------------------------
# Against the numpy oracle
# ---------------------------------------------------------------------------

ORACLE_CASES = {
    "soc": ({"q": [3, 1, 5, 2]}, 1e-10),
    "psd": ({"s": [2, 3, 1, 4]}, 1e-9),
    "csd": ({"cs": [2, 1, 3]}, 1e-9),
    "box": ({"bu": [1.0, 2.0, np.inf, 0.5], "bl": [-1.0, 0.0, -2.0, -np.inf]}, 1e-6),
    "ell1": ({"ell1": [4, 2]}, 1e-9),
    "nuc": ({"nuc_m": [3], "nuc_n": [2]}, 1e-8),
    "mixed": ({"z": 2, "l": 3, "q": [4], "s": [3], "ep": 2, "ed": 2, "p": [0.3, -0.7]}, 2e-5),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_projector_matches_oracle(case):
    K, tol = ORACLE_CASES[case]
    spec = ConeSpec.from_dict(K)
    proj = tpr.make_cone_projector(spec)
    rng = np.random.RandomState(11)
    for _ in range(3):
        z = rng.randn(spec.dim) * 2
        np.testing.assert_allclose(proj(_t(z, torch.float64)).numpy(), oracle.proj_cone(z, K), atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_and_pow_geometry(dtype):
    """The variational test of a projection in f64: p in K, p - v in K*,
    <p, p - v> = 0, with the oracle's membership functions."""
    tdt = DTYPES[dtype][1]
    # membership is certified to the oracle's own resolution (~1e-6), the
    # inner product to rounding
    tol, inner = (3e-6, 1e-8) if dtype == "f64" else (1e-4, 5e-3)
    v = mc.exp_rows(210, seed=5)
    sign = np.where(np.arange(210) % 3 == 0, -1.0, 1.0)
    v = v * sign[:, None]
    p = tpr._proj_exp_batch(_t(v, tdt), _t(sign, tdt)).double().numpy()
    bad, worst = mc.geometry_exp(_t(v, tdt).double().numpy(), p, sign, tol=tol)
    assert not bad.any() and worst <= inner
    v = np.random.RandomState(6).randn(150, 3) * 3
    a = np.random.RandomState(7).uniform(0.1, 0.9, 150)
    sign = np.where(np.arange(150) % 2 == 0, -1.0, 1.0)
    p = tpr._proj_pow_batch(_t(v, tdt), _t(a, tdt), _t(sign, tdt)).double().numpy()
    bad, worst = mc.geometry_pow(
        _t(v, tdt).double().numpy(), p, _t(a, tdt).double().numpy(), sign, tol=tol
    )
    assert bad.mean() <= (0.0 if dtype == "f64" else 0.03) and worst <= inner


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("name", ["bench", "every"])
def test_dispatcher_matches_scs_tpu_single_and_batched(name, dual, dtype):
    K = BENCH_K if name == "bench" else EVERY_K
    jdt, tdt = DTYPES[dtype]
    jspec, tspec = JConeSpec.from_dict(K), ConeSpec.from_dict(K)
    assert tpr.spec_signature(tspec) == jpr.spec_signature(jspec)
    make_j = jpr.make_dual_cone_projector if dual else jpr.make_cone_projector
    make_t = tpr.make_dual_cone_projector if dual else tpr.make_cone_projector
    pj, pt = jax.jit(jax.vmap(make_j(jspec, jdt))), make_t(tspec, tdt)
    Z = np.random.RandomState(21).randn(3, tspec.dim) * 2
    out_j = np.asarray(pj(jnp.asarray(Z, jdt)), np.float64)
    if dtype == "f32":
        # the power cones are held to scs_tpu's f64 answer: its f32 Newton
        # stalls on some rows (test_pow_projection_matches_scs_tpu_in_every_regime)
        Z32 = Z.astype(np.float32).astype(np.float64)
        out_j64 = np.asarray(jax.jit(jax.vmap(make_j(jspec, jnp.float64)))(jnp.asarray(Z32)))
        for sg in tspec.segments():
            if sg.kind == "p":
                out_j[:, sg.offset : sg.offset + sg.length] = out_j64[:, sg.offset : sg.offset + sg.length]
    out_t = pt(_t(Z, tdt))
    assert out_t.shape == Z.shape and out_t.dtype == tdt
    scale = np.abs(Z).max() * np.ones_like(Z[:, :1])
    _close(out_t.numpy(), out_j, scale, dtype, f32_tol=2e-4)
    # a (m,) vector gives its row of the batch
    for i in range(len(Z)):
        np.testing.assert_array_equal(pt(_t(Z[i], tdt)).numpy(), out_t[i].numpy())


def test_dispatcher_box_bounds_per_call_and_per_problem():
    K = {"l": 2, "bu": [1.0, np.inf, 2.0], "bl": [-1.0, 0.0, -np.inf], "q": [3]}
    tspec, jspec = ConeSpec.from_dict(K), JConeSpec.from_dict(K)
    pt, pj = tpr.make_cone_projector(tspec), jpr.make_cone_projector(jspec)
    rng = np.random.RandomState(3)
    Z = rng.randn(4, tspec.dim) * 2
    bl = -np.abs(rng.randn(4, 3))
    bu = np.abs(rng.randn(4, 3))
    bu[1, 0], bl[2, 1] = np.inf, -np.inf
    out = pt(_t(Z, torch.float64), _t(bl, torch.float64), _t(bu, torch.float64)).numpy()
    ref = np.stack([
        np.asarray(pj(jnp.asarray(Z[i]), jnp.asarray(bl[i]), jnp.asarray(bu[i]))) for i in range(4)
    ])
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    # the default bounds are the spec's
    np.testing.assert_allclose(
        pt(_t(Z[0], torch.float64)).numpy(), np.asarray(pj(jnp.asarray(Z[0]))), rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("K", [{"ed": 3}, {"p": [-0.3, -0.8]}, {"ep": 1, "ed": 2, "p": [0.4, -0.6, 0.2]}])
def test_dual_cones_go_through_moreau(K):
    """ed and negative powers: v + Pi(-v) with the primal projection."""
    spec = ConeSpec.from_dict(K)
    z = np.random.RandomState(9).randn(spec.dim) * 2
    out = tpr.make_cone_projector(spec)(_t(z, torch.float64)).numpy()
    rows, want = z.reshape(-1, 3), []
    kinds = ["ep"] * K.get("ep", 0) + ["ed"] * K.get("ed", 0) + list(K.get("p", []))
    for v, kind in zip(rows, kinds):
        v2 = _t(v[None], torch.float64)
        if kind == "ep":
            want.append(tpr._proj_exp_batch_ref(v2)[0].numpy())
        elif kind == "ed":
            want.append(v + tpr._proj_exp_batch_ref(-v2)[0].numpy())
        else:
            a = _t([abs(kind)], torch.float64)
            p = tpr._proj_pow_batch_ref(v2 if kind > 0 else -v2, a)[0].numpy()
            want.append(p if kind > 0 else v + p)
    np.testing.assert_allclose(out, np.concatenate(want), rtol=0, atol=1e-15)
    np.testing.assert_allclose(out, oracle.proj_cone(z, K), atol=2e-5)


def test_interleaved_segments_are_gathered_and_put_back():
    """Cones of one size that do not lie side by side (q: 5, 3, 5) are
    bucketed through one gather and one scatter."""
    K = {"q": [5, 3, 5, 3], "s": [2, 3, 2]}
    spec = ConeSpec.from_dict(K)
    pt = tpr.make_cone_projector(spec)
    Z = np.random.RandomState(2).randn(2, spec.dim)
    out = pt(_t(Z, torch.float64)).numpy()
    np.testing.assert_allclose(out[0], oracle.proj_cone(Z[0], K), atol=1e-9)
    np.testing.assert_allclose(out[1], oracle.proj_cone(Z[1], K), atol=1e-9)
    assert pt.per_device[torch.device("cpu")]["order"] is not None
    # the bench's K lies bucket after bucket already: no gather
    bench = tpr.make_cone_projector(ConeSpec.from_dict(BENCH_K))
    bench(torch.zeros(ConeSpec.from_dict(BENCH_K).dim, dtype=torch.float64))
    assert bench.per_device[torch.device("cpu")]["order"] is None


def test_projector_keeps_its_tensors_per_device():
    """A projector cached from a CPU solve must not hand CPU index tensors
    to a later call on another device: what it needs lives in a table keyed
    by the input's device (the meta device stands in for the card)."""
    K = {"l": 2, "bu": [1.0, 2.0], "bl": [-1.0, 0.0], "q": [3, 2, 3], "ep": 1, "ed": 1, "p": [0.3, -0.6]}
    spec = ConeSpec.from_dict(K)
    proj = tpr.get_projector(spec, torch.float64)
    assert tpr.get_projector(spec, torch.float64) is proj
    proj(torch.zeros(spec.dim, dtype=torch.float64))
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert set(proj.per_device) >= {cpu}
    table = proj.per_device[cpu]
    assert table["order"].device == cpu and table["bl"].device == cpu
    entry = proj.on_device(meta)
    assert proj.per_device[meta] is entry and proj.per_device[cpu] is table
    assert entry["order"].device == meta and entry["inverse"].device == meta
    assert entry["bl"].device == meta and entry["bu"].device == meta
    tensors = [t for consts in entry["consts"] for t in consts.values() if t is not None]
    assert tensors and all(t.device == meta for t in tensors)


def test_non_finite_rows_answer_nan_and_do_not_raise():
    """An iterate may carry a NaN (a rejected acceleration candidate): the
    factorizing projections answer NaN for that cone, as scs_tpu's do, and
    the other cones are untouched."""
    K = {"l": 2, "s": [3, 3], "cs": [2], "nuc_m": [3], "nuc_n": [2]}
    spec = ConeSpec.from_dict(K)
    proj = tpr.make_cone_projector(spec)
    z = np.random.RandomState(4).randn(2, spec.dim)
    clean = proj(_t(z, torch.float64)).numpy()
    z[0, 3], z[1, -1] = np.nan, np.inf
    out = proj(_t(z, torch.float64)).numpy()
    assert np.isnan(out[0, 2:8]).all() and np.isnan(out[1, -7:]).all()
    keep = np.isfinite(out)
    np.testing.assert_array_equal(out[keep], clean[keep])
    assert keep.sum() == out.size - 6 - 7


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_no_nan_on_the_f32_regression_inputs(dtype):
    """The inputs of tests/test_mixed_cone_f32.py and tests/test_spectral_f32.py."""
    tdt = DTYPES[dtype][1]
    for scale in (0.1, 1.0, 10.0, 100.0):
        v = np.random.RandomState(17).randn(256, 3) * scale
        assert torch.isfinite(tpr._proj_exp_batch(_t(v, tdt))).all()
    rng = np.random.RandomState(21)
    for a in (0.25, 0.65):
        for scale in (1.0, 30.0):
            v = rng.randn(256, 3) * scale
            assert torch.isfinite(tpr._proj_pow_batch(_t(v, tdt), torch.full((256,), a, dtype=tdt))).all()
    for scale in (1.0, 20.0):
        assert torch.isfinite(tpr._proj_ell1_batch(_t(np.random.RandomState(3).randn(64, 8) * scale, tdt))).all()
        z = np.random.RandomState(5).randn(32, 13) * scale
        assert torch.isfinite(tpr._proj_nuc_batch(_t(z, tdt), (4, 3))).all()
    z = np.random.RandomState(7).randn(8, sd_cone_size(5) + 1) * 3
    assert torch.isfinite(tpr._proj_sl_batch(_t(z, tdt), (5, 2))).all()
    z = np.random.RandomState(9).randn(8, sd_cone_size(4) + 2) * 3
    assert torch.isfinite(tpr._proj_logdet_batch(_t(z, tdt), 4)).all()


def test_guards_follow_the_dtype():
    for tdt in (torch.float32, torch.float64):
        x = torch.zeros(1, dtype=tdt)
        assert tpr._tiny(x) == torch.finfo(tdt).tiny > 0
        assert torch.isfinite(torch.exp(torch.tensor(tpr._explim(x), dtype=tdt)))
    assert tpr._explim(torch.zeros(1)) == jpr._explim(jnp.zeros(1, jnp.float32))
    assert tpr._explim(torch.zeros(1, dtype=torch.float64)) == jpr._explim(jnp.zeros(1))


# ---------------------------------------------------------------------------
# End to end against scs_tpu (CPU, f64)
# ---------------------------------------------------------------------------

CHECK_INTERVAL = 25
SOLVES = {
    "socp": ({"z": 2, "l": 3, "q": [4, 3, 4]}, False),
    "sdp": ({"l": 2, "s": [3, 4, 1]}, False),
    "box_qp": ({"l": 3, "bu": [1.0, np.inf, 2.0, 0.5], "bl": [-1.0, 0.0, -np.inf, -0.5]}, True),
    "complex_psd": ({"l": 2, "cs": [2, 3]}, False),
    "spectral": ({"l": 2, "ell1": [3], "nuc_m": [3], "nuc_n": [2]}, False),
}


def _problem(K, with_P, seed=5):
    m = oracle.cone_dims(K)
    return oracle.gen_feasible(
        K, n=max(m // 3, 2), density=0.5, rng=np.random.RandomState(seed), with_P=with_P
    )


@pytest.mark.parametrize("strategy", ["direct", "indirect"])
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_curved_cone_solve_matches_scs_tpu(name, strategy):
    K, with_P = SOLVES[name]
    data, p_star, _ = _problem(K, with_P)
    # the complex PSD problem crawls at tight tolerances in both packages
    eps = 1e-4 if name == "complex_psd" else 1e-7
    kw = dict(eps_abs=eps, eps_rel=eps, verbose=False, max_iters=5000,
              solver_strategy=strategy, dtype="float64")
    sj = scs_tpu.solve(data, K, **kw)
    st = scs_tpu_torch.solve(data, K, device="cpu", **kw)
    ij, it = sj["info"], st["info"]
    assert it["status"] == ij["status"] == "solved"
    assert abs(it["iter"] - ij["iter"]) <= CHECK_INTERVAL
    assert abs(it["pobj"] - ij["pobj"]) <= max(1e-6, eps) * (1 + abs(ij["pobj"]))
    assert abs(it["pobj"] - p_star) <= 100 * eps * (1 + abs(p_star))
    s = np.asarray(st["s"], np.float64)
    assert np.linalg.norm(s - oracle.proj_cone(s, K)) <= 100 * eps * (1 + np.linalg.norm(s))


def test_bell_strategy_takes_curved_cones():
    K = {"l": 3, "q": [4, 3], "s": [3]}
    data, p_star, _ = _problem(K, False)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, max_iters=5000,
              solver_strategy="bell", bell_block_size=8, dtype="float64")
    sj = scs_tpu.solve(data, K, **kw)
    st = scs_tpu_torch.solve(data, K, device="cpu", **kw)
    assert st["info"]["status"] == sj["info"]["status"] == "solved"
    assert abs(st["info"]["pobj"] - p_star) <= 1e-4 * (1 + abs(p_star))
    assert abs(st["info"]["pobj"] - sj["info"]["pobj"]) <= 1e-5 * (1 + abs(p_star))


@pytest.mark.parametrize("strategy", ["direct", "indirect"])
def test_mixed_cone_first_iterates_match_scs_tpu(strategy):
    """The first 25 iterations (one check interval) of a solve over z + l +
    box + SOC + PSD + exp + dual exp + power cones: the same iterates to
    1e-7."""
    K = {"z": 2, "l": 3, "bu": [1.0, np.inf], "bl": [-np.inf, -0.5], "q": [4], "s": [3],
         "ep": 2, "ed": 1, "p": [0.3, -0.6]}
    data, _, _ = _problem(K, False, seed=8)
    # every CG solve converged and AA regularized, so that last-bit
    # differences are not amplified (tests/test_torch_api.py's STABLE)
    kw = dict(eps_abs=1e-12, eps_rel=1e-12, verbose=False, max_iters=CHECK_INTERVAL,
              solver_strategy=strategy, dtype="float64", cg_tol_factor=1e-12,
              acceleration_regularization=1e-4)
    sj = scs_tpu.solve(data, K, **kw)
    st = scs_tpu_torch.solve(data, K, device="cpu", **kw)
    assert st["info"]["status"] == sj["info"]["status"]
    assert st["info"]["iter"] == sj["info"]["iter"] == CHECK_INTERVAL
    for k in ("x", "y", "s"):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-7, atol=1e-7, err_msg=k)


def _mixed_batch(B, K, seed=3):
    m = oracle.cone_dims(K)
    rng = np.random.RandomState(seed)
    As, bs, cs, stars = [], [], [], []
    for _ in range(B):
        data, p_star, _ = oracle.gen_feasible(K, n=m // 3, density=0.4, rng=rng)
        As.append(np.asarray(data["A"].todense()))
        bs.append(data["b"])
        cs.append(data["c"])
        stars.append(p_star)
    return {"A": np.stack(As), "b": np.stack(bs), "c": np.stack(cs)}, np.array(stars)


def test_batched_mixed_cones_with_compaction_match_scs_tpu(monkeypatch):
    """A small batch over box + SOC + PSD cones, compaction on (bl/bu rows
    are gathered with the rest), against scs_tpu's batch and against each
    problem solved alone."""
    import scs_tpu.batch as jb
    import scs_tpu_torch.batch as tb

    monkeypatch.setattr(jb.BatchedSCS, "_MIN_BUCKET", 2)
    monkeypatch.setattr(tb.BatchedSCS, "_MIN_BUCKET", 2)
    K = {"l": 3, "bu": [1.0, np.inf, 0.7], "bl": [-1.0, -0.5, -np.inf], "q": [4, 3], "s": [3]}
    data, p_star = _mixed_batch(6, K)
    kw = dict(dtype="float64", eps_abs=1e-6, eps_rel=1e-6, max_iters=5000, check_interval=25)
    rj = scs_tpu.BatchedSCS(data, K, **kw).solve()
    solver = scs_tpu_torch.BatchedSCS(data, K, device="cpu", **kw)
    rt = solver.solve()
    assert len(solver.bucket_ladder) > 1  # the batch was compacted
    for i, (a, b) in enumerate(zip(rt, rj)):
        assert a["info"]["status"] == b["info"]["status"] == "solved"
        assert abs(a["info"]["iter"] - b["info"]["iter"]) <= 25
        assert abs(a["info"]["pobj"] - p_star[i]) <= 1e-4 * (1 + abs(p_star[i]))
        assert abs(a["info"]["pobj"] - b["info"]["pobj"]) <= 1e-5 * (1 + abs(p_star[i]))
    # update b (the bounds stay with the problem) and solve again
    b2 = data["b"] * 1.01
    solver.update(b=b2)
    again = solver.solve()
    one = scs_tpu_torch.solve(
        {"A": sparse.csc_matrix(data["A"][2]), "b": b2[2], "c": data["c"][2]}, K, device="cpu",
        dtype="float64",
        eps_abs=1e-6, eps_rel=1e-6, max_iters=5000, verbose=False,
    )
    assert again[2]["info"]["status"] == one["info"]["status"] == "solved"
    assert abs(again[2]["info"]["pobj"] - one["info"]["pobj"]) <= 1e-4 * (1 + abs(one["info"]["pobj"]))


def test_batched_exp_and_power_cones_first_iterates_match_scs_tpu():
    """Two chunks of a batch over exp, dual exp and power cones: the same
    statuses, counts and iterates as scs_tpu's batch (f64, 1e-6)."""
    K = {"l": 2, "q": [3], "ep": 2, "ed": 1, "p": [0.3, -0.6]}
    data, _ = _mixed_batch(2, K, seed=6)
    kw = dict(dtype="float64", eps_abs=1e-12, eps_rel=1e-12, max_iters=20, check_interval=10, scale=1.0)
    rj = scs_tpu.BatchedSCS(data, K, **kw).solve()
    rt = scs_tpu_torch.BatchedSCS(data, K, device="cpu", **kw).solve()
    for a, b in zip(rt, rj):
        assert a["info"]["status"] == b["info"]["status"]
        assert a["info"]["iter"] == b["info"]["iter"]
        np.testing.assert_allclose(a["x"], b["x"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a["s"], b["s"], rtol=1e-6, atol=1e-6)


def test_wide_cone_and_generators():
    K = mc.wide_cone()
    spec = ConeSpec.from_dict(K)
    assert spec.dim == oracle.cone_dims(K) == 5313
    assert spec.ep + spec.ed + len(spec.p) == 400 and len(spec.bu) == 400
    assert np.isinf(K["bu"]).any() and np.isinf(K["bl"]).any()
    assert all(0.1 <= abs(p) <= 0.9 for p in K["p"]) and min(K["p"]) < 0 < max(K["p"])
    # the bench cell's generator draws scs_tpu's problems
    data, p_star = mc.gen_mixed_batch(BENCH_K, 2, mc.MIXED_SEED)
    rng = np.random.RandomState(mc.MIXED_SEED)
    m = oracle.cone_dims(BENCH_K)
    ref, ref_star, _ = oracle.gen_feasible(BENCH_K, n=m // 3, density=0.1, rng=rng)
    k = np.linalg.norm(ref["c"])
    np.testing.assert_array_equal(data["A"][0], np.asarray(ref["A"].todense()))
    np.testing.assert_array_equal(data["c"][0], ref["c"] / k)
    assert p_star[0] == ref_star / k and data["A"].shape == (2, m, m // 3)


def test_check_solutions_holds_a_solve_to_its_criterion():
    K = {"l": 3, "q": [4], "s": [3]}
    data, _ = _mixed_batch(2, K)
    res = scs_tpu_torch.BatchedSCS(
        data, K, device="cpu", dtype="float64", eps_abs=1e-6, eps_rel=1e-6, max_iters=5000
    ).solve()
    worst = mc.check_solutions(K, data, res, 1e-6)
    assert max(worst[:3]) <= 1.0 + 1e-9 and max(worst[3:]) <= 2e-5
    res[1]["s"] = np.asarray(res[1]["s"]) + 1e-2
    with pytest.raises(AssertionError, match="problem 1"):
        mc.check_solutions(K, data, res, 1e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cone_proj kernels have no CPU mode")
    return torch.device("cuda")


def _exp_group_sizes():
    """A cone count at which exp_group picks each G of EXP_GROUPS, none of
    them a multiple of its G > 1."""
    sizes = [tpr.EXP_FILL_THREADS // g - 1 for g in tpr.EXP_GROUPS if g > 1]
    sizes.append(tpr.EXP_FILL_THREADS + 1)
    assert [tpr.exp_group(k) for k in sizes] == list(tpr.EXP_GROUPS)
    assert all(k % g for k, g in zip(sizes, tpr.EXP_GROUPS) if g > 1)
    return tuple(sizes)


def _exp_cycling_rows(device, dtype, k=20000):
    """exp_rows whose inner solves end on a cycle on the card (counted by
    the kernel itself), at the most lanes a cone and, repeated, at one."""
    v = mc.exp_rows(k, seed=11)
    cycles = torch.zeros(k, dtype=torch.int32, device=device)
    tpr._proj_exp_batch(torch.as_tensor(v, dtype=dtype, device=device), cycles_out=cycles)
    rows = v[cycles.cpu().numpy() > 0]
    assert len(rows) >= 100
    few, many = rows[: tpr.EXP_FILL_THREADS // 32], np.resize(rows, (tpr.EXP_FILL_THREADS + 1, 3))
    assert (tpr.exp_group(len(few)), tpr.exp_group(len(many))) == (32, 1)
    return [(f"rows whose solves cycle, G = {tpr.exp_group(len(r))}", r, None) for r in (few, many)]


def _pow_cycling_rows(device, dtype, k=20000):
    """pow_rows whose Newton iteration cycles on the plain version's map
    (mc.pow_repeat_steps, on the card), alone and repeated over more
    threads than the card holds at once."""
    v, a, sign = mc.pow_rows(k, seed=13)
    _, period = mc.pow_repeat_steps(*(torch.as_tensor(x, dtype=dtype, device=device)
                                      for x in (v, a, sign)))
    rows = period.cpu().numpy() >= 2
    assert rows.sum() >= (100 if dtype == torch.float32 else 10)
    few = tuple(x[rows] for x in (v, a, sign))
    many = tuple(np.resize(x, (200_000,) + x.shape[1:]) for x in few)
    return [(f"rows that cycle, {len(r[0])} of them", *r) for r in (few, many)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["exp", "pow", "box", "exp_groups", "exp_cycles", "box_cycles",
                                    "pow_cycles"])
def test_cone_kernels_match_plain_on_card(cuda_device, kernel, dtype):
    """check_cone_kernels' gates (agreement to KERNEL_TOL, bit-equal repeat,
    geometry in f64) at small sizes, one kernel at a time; proj_exp also at
    every lanes-per-cone G on cone counts that no G > 1 divides, and the
    three kernels on rows whose Newton iterations cycle."""
    sizes = dict(exp_sizes=(), pow_sizes=(), box_cases=())
    if kernel in ("exp", "pow", "box"):
        sizes[{"exp": "exp_sizes", "pow": "pow_sizes", "box": "box_cases"}[kernel]] = {
            "exp": (7, 700, 20000), "pow": (5, 500, 20000),
            "box": ((1, 1, False), (3, 77, True), (64, 1000, False), (5, 3000, True)),
        }[kernel]
    elif kernel == "exp_groups":
        sizes["exp_sizes"] = _exp_group_sizes()
    elif kernel == "exp_cycles":
        sizes["exp_inputs"] = _exp_cycling_rows(cuda_device, dtype)
    elif kernel == "pow_cycles":
        sizes["pow_inputs"] = _pow_cycling_rows(cuda_device, dtype)
    else:
        v, bl, bu = _box_cycling_rows(dtype)
        sizes["box_inputs"] = [("rows that two-cycle", v, bl, bu)]
    launches = sum(f.launches for f in (tpr._proj_exp_batch, tpr._proj_pow_batch, tpr._proj_box))
    lines = []
    mc.check_cone_kernels(3.35e12, {torch.float32: 67e12, torch.float64: 34e12},
                          report_at={"proj_exp": 0, "proj_pow": 0, "proj_box": ()},
                          geometry_rows=350, log=lines.append, dtypes=(dtype,), **sizes)
    assert lines and all(str(dtype)[6:] in ln for ln in lines)  # a fault would have raised
    assert sum(f.launches for f in (tpr._proj_exp_batch, tpr._proj_pow_batch, tpr._proj_box)) > launches


@pytest.mark.cuda
def test_cone_wrappers_raise_on_card_for_bad_input(cuda_device):
    v = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        tpr._proj_exp_batch(torch.zeros((4, 2), device=cuda_device))
    with pytest.raises(TypeError):
        tpr._proj_exp_batch(v.half())
    with pytest.raises(ValueError):
        tpr._proj_exp_batch(v, steps_out=torch.zeros(4, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        tpr._proj_box(torch.zeros((2, 3), device=cuda_device), torch.zeros(2, device=cuda_device),
                      torch.zeros(2, device=cuda_device), cycles_out=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tpr._proj_pow_batch(v, torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError):
        tpr._proj_pow_batch(v, torch.zeros(4))  # a on the CPU
    with pytest.raises(ValueError):
        tpr._proj_pow_batch(v, torch.zeros(4, device=cuda_device), torch.ones(4))  # sign on the CPU
    with pytest.raises(ValueError):
        tpr._proj_pow_batch(v, torch.zeros(4, device=cuda_device),
                            iters_out=torch.zeros(4, dtype=torch.int64, device=cuda_device))
    with pytest.raises(TypeError):
        tpr._proj_pow_batch(v.half(), torch.zeros(4, device=cuda_device).half())
    with pytest.raises(ValueError):
        tpr._proj_box(v, torch.zeros(3, device=cuda_device), torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError):
        tpr._proj_box(v, torch.zeros((2, 2), device=cuda_device), torch.zeros((2, 2), device=cuda_device))


@pytest.mark.cuda
def test_projector_on_card_matches_cpu(cuda_device):
    """The dispatcher on the card (kernels for box, exp, power) against the
    CPU (plain versions), f64, single and batched; the projector cached
    from the CPU call keeps a table of its own for the card."""
    spec = ConeSpec.from_dict(EVERY_K)
    proj = tpr.get_projector(spec, torch.float64)
    Z = torch.as_tensor(np.random.RandomState(1).randn(3, spec.dim) * 2)
    on_cpu = proj(Z)
    before = tpr._proj_exp_batch.launches, tpr._proj_pow_batch.launches, tpr._proj_box.launches
    on_card = proj(Z.to(cuda_device))
    after = tpr._proj_exp_batch.launches, tpr._proj_pow_batch.launches, tpr._proj_box.launches
    assert all(b == a + 1 for a, b in zip(before, after))
    assert on_card.device.type == "cuda"
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(proj(Z[1].to(cuda_device)).cpu().numpy(), on_cpu[1].numpy(), rtol=1e-9, atol=1e-9)
    assert {d.type for d in proj.per_device} == {"cpu", "cuda"}


@pytest.mark.cuda
def test_socp_on_card_matches_cpu(cuda_device):
    K, with_P = SOLVES["socp"]
    data, p_star, _ = _problem(K, with_P)
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, verbose=False, max_iters=5000, dtype="float64")
    a = scs_tpu_torch.solve(data, K, device="cuda", **kw)
    b = scs_tpu_torch.solve(data, K, device="cpu", **kw)
    assert a["info"]["status"] == b["info"]["status"] == "solved"
    assert abs(a["info"]["iter"] - b["info"]["iter"]) <= CHECK_INTERVAL
    assert abs(a["info"]["pobj"] - p_star) <= 1e-5 * (1 + abs(p_star))
