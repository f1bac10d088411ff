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
