"""solver.Core: scs_tpu_torch against scs_tpu from identical data and state.

Both packages build the same problem; convert.py carries scs_tpu's Mats
and State across, so both cores start from identical numbers. Then one CG
solve, one DR step, 2*acceleration_interval iterations (including an AA
trial) and one chunk's check must agree to rtol 1e-10 in f64: the same
math, summed in a different order.

Two settings keep last-bit differences from being amplified, so that the
comparison tests the math and not the summation order:

  * cg_tol_factor=1e-12: every CG solve runs to its floor. Under the
    default schedule CG stops early on purpose (its tolerance tracks the
    DR step), and an early-stopped Krylov iterate amplifies rounding: on
    the LP below a 1e-15 relative change of w moves the next u_t by ~1e-4,
    and scs_tpu jitted and eager differ by as much after two iterations.
  * acceleration_regularization=1e-4: with the default 1e-8 the type-I AA
    least squares is nearly singular, and its second trial on the QP turns
    2e-12 differences in the ring buffers into 2e-8 in w (same cause).

The default settings are compared end to end in test_torch_api.py.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import sparse

import scs_tpu
import scs_tpu_torch
from scs_tpu_torch.convert import mats_from_numpy, state_from_numpy
from scs_tpu_torch.solver import Diag

# the port's entry points run on the card unless told otherwise
CPU = dict(device="cpu")

torch.set_num_threads(1)

RTOL = 1e-10
KW = dict(
    solver_strategy="bell", bell_block_size=16, eps_abs=1e-7, eps_rel=1e-7,
    verbose=False, cg_tol_factor=1e-12, acceleration_regularization=1e-4,
)
# At its floor CG stops by the 12-step stall rule, which compares
# noise-level residuals: the iteration counts may differ within one window.
CG_STALL_WINDOW = 12


def _lp(m=60, n=45, seed=0):
    """The LP of tests/test_bell.py::test_bell_matches_direct_lp."""
    rng = np.random.RandomState(seed)
    A = sparse.random(m, n, density=0.1, random_state=rng, format="csc")
    A = (A + sparse.diags(np.ones(min(m, n)), shape=(m, n), format="csc")).tocsc()
    A.sort_indices()
    z = rng.randn(m)
    y = np.maximum(z, 0)
    s = y - z
    x = rng.randn(n)
    b = A @ x + s
    c = np.asarray(-(A.T @ y)).ravel()
    return {"A": A, "b": b, "c": c}, {"l": m}


def _qp(m=50, n=35, seed=3):
    """The QP of tests/test_bell.py::test_bell_qp_kkt."""
    rng = np.random.RandomState(seed)
    A = sparse.random(m, n, density=0.15, random_state=rng, format="csc")
    A = (A + sparse.diags(np.ones(min(m, n)), shape=(m, n), format="csc")).tocsc()
    A.sort_indices()
    x0 = rng.randn(n)
    b = np.asarray(A @ x0).ravel() + np.abs(rng.randn(m))
    c = rng.randn(n)
    G = rng.randn(n, 6)
    P = sparse.csc_matrix(np.triu(G @ G.T * 0.1 + 1.0 * np.eye(n)))
    return {"A": A, "b": b, "c": c, "P": P}, {"l": m}


PROBLEMS = {"lp": _lp, "qp": _qp}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def pair(request):
    data, cone = PROBLEMS[request.param]()
    sj = scs_tpu.SCS(data, cone, **KW)
    st = scs_tpu_torch.SCS(data, cone, **KW, **CPU)
    cj = sj.core
    return {
        "sj": sj, "cj": cj, "ct": st.core,
        "mats_t": mats_from_numpy(_np(sj.mats)),
        "iter_j": jax.jit(cj._iter_body),
    }


def _advance(pair, k):
    state = pair["sj"]._state0
    for _ in range(k):
        state = pair["iter_j"](state, pair["sj"].mats)
    return state


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1e-300)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale)


def test_setup_g_matches(pair):
    s0j = pair["sj"]._state0
    s0t = pair["ct"].init_state(pair["mats_t"])
    _close(s0t.gx.numpy(), s0j.gx)
    _close(s0t.gy.numpy(), s0j.gy)


@pytest.mark.parametrize("op", ["_Ax", "_ATy", "_Px"])
def test_operators_match(pair, op):
    """Core._Ax/_ATy/_Px on vectors of the true lengths n and m (no
    multiples of the block size: the port pads nothing before the product)
    against scs_tpu's, which pad to whole tiles."""
    cj, ct = pair["cj"], pair["ct"]
    assert cj.n % 16 and cj.m % 16  # ragged in both orientations
    if op == "_Px" and not ct.has_P:
        assert pair["mats_t"].pbell is None and pair["sj"].mats.pbell is None
        return
    v = np.random.RandomState(13).randn(cj.m if op == "_ATy" else cj.n)
    out_j = getattr(cj, op)(pair["sj"].mats, jax.numpy.asarray(v))
    out_t = getattr(ct, op)(pair["mats_t"], torch.as_tensor(v))
    assert tuple(out_t.shape) == out_j.shape == ((cj.m,) if op == "_Ax" else (cj.n,))
    _close(out_t.numpy(), out_j)


def test_cg_solve_matches(pair):
    cj, ct = pair["cj"], pair["ct"]
    st_j = _advance(pair, 5)
    st_t = state_from_numpy(_np(st_j))
    rng = np.random.RandomState(11)
    rhs, x0 = rng.randn(cj.n), rng.randn(cj.n)
    tol = 1e-12 * np.linalg.norm(rhs)  # converged: see the module docstring
    dy_j = 1.0 / cj._ry(st_j.scale)
    dy_t = 1.0 / ct._ry(st_t.scale)
    x_j, k_j = jax.jit(cj._cg)(pair["sj"].mats, dy_j, rhs, x0, tol, st_j.scale)
    x_t, k_t = ct._cg(pair["mats_t"], dy_t, torch.as_tensor(rhs), torch.as_tensor(x0),
                      torch.tensor(tol, dtype=torch.float64), st_t.scale)
    assert k_t == int(k_j) > 0
    _close(x_t.numpy(), x_j)


def test_step_matches(pair):
    cj, ct = pair["cj"], pair["ct"]
    st_j = _advance(pair, 5)
    out_j = jax.jit(cj._step)(st_j, pair["sj"].mats)
    out_t = ct._step(state_from_numpy(_np(st_j)), pair["mats_t"])
    for f in ("w", "u", "v", "px_warm", "diff_u_ut_2", "diff_u_ut_inf",
              "diff_v_2", "diff_v_inf"):
        _close(getattr(out_t, f).numpy(), getattr(out_j, f))
    assert abs(out_t.cg_iters - int(out_j.cg_iters)) <= CG_STALL_WINDOW


def test_iter_body_two_intervals_with_aa_trials(pair):
    """2 * acceleration_interval iterations from the cold start: the AA
    ring fills and two AA trials fire (iterations 10 and 20)."""
    ct, mats_t = pair["ct"], pair["mats_t"]
    k = 2 * pair["cj"].interval
    st_j = _advance(pair, k)
    st_t = state_from_numpy(_np(pair["sj"]._state0))
    for _ in range(k):
        st_t = ct._iter_body(st_t, mats_t)
    assert st_t.it == int(st_j.it) == k
    assert st_t.aa.aa_iter == int(st_j.aa.aa_iter) == 2
    for f in ("n_accept", "n_reject_nonfinite", "n_reject_weight_cap",
              "n_safeguard_reject", "count"):
        assert getattr(st_t.aa, f) == int(getattr(st_j.aa, f)), f
    assert abs(st_t.cg_iters - int(st_j.cg_iters)) <= CG_STALL_WINDOW
    for f in ("w", "u", "v", "u_sum", "v_sum"):
        _close(getattr(st_t, f).numpy(), getattr(st_j, f))
    _close(st_t.aa.dX.numpy(), st_j.aa.dX)
    _close(st_t.aa.last_aa_norm.numpy(), st_j.aa.last_aa_norm)


def test_check_after_one_chunk(pair):
    sj, ct = pair["sj"], pair["ct"]
    st_j = sj.core._jit_chunk(sj._state0, sj.mats)
    st_t = ct._chunk(state_from_numpy(_np(sj._state0)), pair["mats_t"])
    assert st_t.it == int(st_j.it) == sj.stg.check_interval
    assert st_t.status == int(st_j.status)
    assert st_t.scale_updates == int(st_j.scale_updates)
    _close(st_t.scale.numpy(), st_j.scale)
    _close(st_t.w.numpy(), st_j.w)
    # residuals are differences of terms linear in the iterate, which the
    # check renormalizes to norm sqrt(N) over equilibrated O(1) data: an
    # rtol-sized difference of the iterate moves them by up to ~rtol*sqrt(N)
    atol = RTOL * np.sqrt(sj.core.N)
    for f in Diag._fields:
        a, b = getattr(st_t.diag, f).numpy(), np.asarray(getattr(st_j.diag, f))
        if np.isinf(b):
            assert a == b, f
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=f)


def test_state_from_numpy_types(pair):
    st = state_from_numpy(_np(pair["sj"]._state0))
    assert isinstance(st.it, int) and isinstance(st.aa.count, int)
    assert isinstance(st.avg_cnt, float)
    assert st.w.dtype == torch.float64 and st.scale.dim() == 0
    assert st.aa.count == -1 and st.status == scs_tpu_torch.UNFINISHED


# -- the dense strategies -------------------------------------------------------
#
# "direct" in both direct_solver modes and "indirect" on the same LP and QP
# (densified by the API). The direct path has no CG stall rule and no
# early-stopped Krylov iterate, so only the AA least squares needs the
# stabilising regularization; the tolerance stays rtol 1e-10.

DENSE_KW = dict(eps_abs=1e-7, eps_rel=1e-7, verbose=False, acceleration_regularization=1e-4)
DENSE_MODES = {
    "cholesky": dict(solver_strategy="direct", direct_solver="cholesky"),
    "inverse": dict(solver_strategy="direct", direct_solver="inverse"),
    "indirect": dict(solver_strategy="indirect", cg_tol_factor=1e-12),
}


@pytest.fixture(
    scope="module",
    params=[(p, m) for p in sorted(PROBLEMS) for m in sorted(DENSE_MODES)],
    ids=lambda pm: f"{pm[0]}-{pm[1]}",
)
def dense_pair(request):
    prob, mode = request.param
    data, cone = PROBLEMS[prob]()
    kw = dict(DENSE_KW, **DENSE_MODES[mode])
    sj = scs_tpu.SCS(data, cone, **kw)
    st = scs_tpu_torch.SCS(data, cone, **kw, **CPU)
    return {
        "sj": sj, "cj": sj.core, "ct": st.core, "st": st, "mode": mode,
        "mats_t": mats_from_numpy(_np(sj.mats)),
        "iter_j": jax.jit(sj.core._iter_body),
    }


def test_dense_mats_and_flags(dense_pair):
    sj, st, ct, cj = dense_pair["sj"], dense_pair["st"], dense_pair["ct"], dense_pair["cj"]
    assert (ct.indirect, ct.use_bell, ct.use_inverse, ct.refine_steps) == (
        cj.indirect, cj.use_bell, cj.use_inverse, cj.refine_steps)
    mt = dense_pair["mats_t"]
    assert mt.bell is None and mt.pbell is None and mt.A.is_contiguous()
    assert (mt.P is None) == (not cj.has_P)
    # the API's own host equilibration gives the same dense data
    _close(st.mats.A.numpy(), sj.mats.A)
    if cj.has_P:
        _close(st.mats.P.numpy(), sj.mats.P)
    for f in ("bn", "cn", "D", "E", "sc_b", "sc_c"):
        _close(getattr(st.mats, f).numpy(), getattr(sj.mats, f))


def test_dense_factorize_and_g_match(dense_pair):
    ct, mats_t = dense_pair["ct"], dense_pair["mats_t"]
    s0j = dense_pair["sj"]._state0
    before = ct.factorizations
    s0t = ct.init_state(mats_t)
    if dense_pair["mode"] == "indirect":
        assert tuple(s0t.L.shape) == (0, 0) == np.asarray(s0j.L).shape
        assert ct.factorizations == before
    else:
        assert ct.factorizations == before + 1
        _close(s0t.L.numpy(), s0j.L)  # the Cholesky factor, or S^-1
    _close(s0t.gx.numpy(), s0j.gx)
    _close(s0t.gy.numpy(), s0j.gy)
    # g from a given factor: no new factorization
    L_t = state_from_numpy(_np(s0j)).L
    gx, gy = ct._compute_g(mats_t, s0t.scale, L_t)
    assert ct.factorizations == before + (dense_pair["mode"] != "indirect")
    _close(gx.numpy(), s0j.gx)
    _close(gy.numpy(), s0j.gy)


def test_dense_lin_solve_matches(dense_pair):
    cj, ct = dense_pair["cj"], dense_pair["ct"]
    st_j = _advance(dense_pair, 5)
    st_t = state_from_numpy(_np(st_j))
    rng = np.random.RandomState(12)
    rhs = rng.randn(cj.n)
    tol = 1e-12 * np.linalg.norm(rhs)
    x_j, k_j = jax.jit(cj._lin_solve)(st_j, dense_pair["sj"].mats, rhs, tol)
    x_t, k_t = ct._lin_solve(st_t, dense_pair["mats_t"], torch.as_tensor(rhs),
                             torch.tensor(tol, dtype=torch.float64))
    _close(x_t.numpy(), x_j)
    if dense_pair["mode"] == "indirect":
        assert abs(k_t - int(k_j)) <= CG_STALL_WINDOW and k_t > 0
    else:
        assert k_t == int(k_j) == 0


def test_dense_refinement_pass_matches():
    """lin_refine_steps=2 in f64 (the auto policy gives 0 there): the
    refinement residual runs through the dense matvecs."""
    data, cone = _qp()
    kw = dict(DENSE_KW, solver_strategy="direct", direct_solver="inverse", lin_refine_steps=2)
    sj, st = scs_tpu.SCS(data, cone, **kw), scs_tpu_torch.SCS(data, cone, **kw, **CPU)
    assert st.core.refine_steps == sj.core.refine_steps == 2
    _close(st._state0.gx.numpy(), sj._state0.gx)
    out_j = jax.jit(sj.core._step)(sj._state0, sj.mats)
    out_t = st.core._step(state_from_numpy(_np(sj._state0)), mats_from_numpy(_np(sj.mats)))
    _close(out_t.w.numpy(), out_j.w)


def test_dense_iterations_with_aa_trials_match(dense_pair):
    ct, mats_t = dense_pair["ct"], dense_pair["mats_t"]
    k = 2 * dense_pair["cj"].interval
    st_j = _advance(dense_pair, k)
    st_t = state_from_numpy(_np(dense_pair["sj"]._state0))
    for _ in range(k):
        st_t = ct._iter_body(st_t, mats_t)
    assert st_t.it == int(st_j.it) == k
    assert st_t.aa.aa_iter == int(st_j.aa.aa_iter) == 2
    assert st_t.aa.n_accept == int(st_j.aa.n_accept)
    # CG at its floor stops by the stall rule, which compares noise-level
    # residuals (see CG_STALL_WINDOW): 20 such solves leave the indirect
    # iterates apart by a few 1e-12 absolute, past 1e-10 relative on the
    # LP's small entries. The direct modes hold rtol 1e-10.
    rtol = 1e-9 if dense_pair["mode"] == "indirect" else RTOL
    for f in ("w", "u", "v", "u_sum", "v_sum"):
        a, b = getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=f)


def test_dense_check_after_one_chunk(dense_pair):
    sj, ct = dense_pair["sj"], dense_pair["ct"]
    st_j = sj.core._jit_chunk(sj._state0, sj.mats)
    st_t = ct._chunk(state_from_numpy(_np(sj._state0)), dense_pair["mats_t"])
    assert st_t.it == int(st_j.it) == sj.stg.check_interval
    assert st_t.status == int(st_j.status)
    assert st_t.scale_updates == int(st_j.scale_updates)
    _close(st_t.scale.numpy(), st_j.scale)
    _close(st_t.w.numpy(), st_j.w)
    _close(st_t.L.numpy(), st_j.L)
    atol = RTOL * np.sqrt(sj.core.N)
    for f in Diag._fields:
        a, b = getattr(st_t.diag, f).numpy(), np.asarray(getattr(st_j.diag, f))
        if np.isinf(b):
            assert a == b, f
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=f)


def test_dense_rescale_refactorizes(dense_pair):
    """A forced rescale runs _setup at the new scale: a new factor (direct)
    and a new g, equal to scs_tpu's."""
    cj, ct = dense_pair["cj"], dense_pair["ct"]
    st_j = _advance(dense_pair, 5)
    st_t = state_from_numpy(_np(st_j))
    ratio = 3.0
    out_j = jax.jit(cj._apply_rescale)(st_j, dense_pair["sj"].mats, jnp_f64(ratio), True)
    before = ct.factorizations
    out_t = ct._apply_rescale(st_t, dense_pair["mats_t"], torch.tensor(ratio, dtype=torch.float64), True)
    assert ct.factorizations == before + (dense_pair["mode"] != "indirect")
    assert out_t.scale_updates == int(out_j.scale_updates) == 1
    for f in ("scale", "L", "gx", "gy", "v", "w", "v_sum"):
        _close(getattr(out_t, f).numpy(), getattr(out_j, f))


def jnp_f64(v):
    return jax.numpy.asarray(v, jax.numpy.float64)


@pytest.mark.parametrize("kw,hi_acc,refine", [
    # f32 below eps 3e-5 on a dense strategy: the compensated hi_acc mode
    (dict(solver_strategy="direct", dtype="float32", eps_abs=1e-6, eps_rel=1e-6), True, 2),
    (dict(solver_strategy="indirect", dtype="float32", eps_abs=1e-4, eps_rel=1e-5), True, 0),
    # f32 at eps 1e-4, f64 at eps 1e-6 and f32 bell at eps 1e-6 stay plain
    (dict(solver_strategy="direct", dtype="float32"), False, 1),
    (dict(solver_strategy="direct", dtype="float64", eps_abs=1e-6, eps_rel=1e-6), False, 0),
    (dict(solver_strategy="bell", bell_block_size=16, dtype="float32", eps_abs=1e-6,
          eps_rel=1e-6), False, 0),
])
def test_hi_acc_combination_resolves(kw, hi_acc, refine):
    """The core resolves hi_acc and its refinement passes as scs_tpu's does
    (f32, min(eps) < 3e-5, not bell; 2 passes under "direct"), and the
    dense configurations solve."""
    data, cone = _qp()
    sj = scs_tpu.SCS(data, cone, verbose=False, **kw)
    st = scs_tpu_torch.SCS(data, cone, verbose=False, **kw, **CPU)
    assert st.core.hi_acc == bool(sj.core.hi_acc) == hi_acc
    assert st.core.refine_steps == sj.core.refine_steps == refine
    if kw["solver_strategy"] != "bell":
        assert st.solve()["info"]["status"] == "solved"
