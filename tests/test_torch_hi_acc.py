"""The high-accuracy mode (Core.hi_acc): scs_tpu_torch against scs_tpu on
the same numpy inputs, on the CPU in float32.

f32 below eps 3e-5 on a dense strategy switches the residuals, the
refinement residuals and g to the compensated products of ops/df32.py.
What is compared: the flag and the refinement passes; the compensated
operators and the residual scalars at one state carried across by
convert.py (exact up to summation order: the operators to 1e-6 relative,
each residual to 1e-6 of the terms it is the sum of, since a residual near
convergence is a cancelling sum of f32 vectors); and the ports of
tests/test_hi_accuracy.py's end-to-end solves, through both packages, held
to what those tests hold scs_tpu to (status, objective to 5 decimals, f64
KKT). Iteration counts are chaotic in f32 and are not compared.
"""

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_almost_equal
from test_hi_accuracy import _qp

import scs_tpu
import scs_tpu.batch as jb
import scs_tpu_torch
from scs_tpu_torch.convert import batch_state_from_numpy, mats_from_numpy, state_from_numpy

CPU = dict(device="cpu")
HI = dict(dtype="float32", eps_abs=1e-6, eps_rel=1e-6, verbose=False)
OPS = 1e-6  # compensated operators, two summation orders
TERMS = 1e-6  # residuals, of the norms of their terms (||Ax||, ||Px||, |c'x|, ...)
NORMS = 1e-5  # the terms' norms themselves: f32 norms after the products


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def test_hi_acc_flag_resolution():
    data, _ = _qp(30, 20, seed=3)
    lo = scs_tpu_torch.SCS(data, {"l": 30}, verbose=False, dtype="float32", **CPU)
    assert not lo.core.hi_acc and lo.core.refine_steps == 1
    hi = scs_tpu_torch.SCS(data, {"l": 30}, **HI, **CPU)
    assert hi.core.hi_acc and hi.core.refine_steps == 2
    ref = scs_tpu.SCS(data, {"l": 30}, **HI)
    assert ref.core.hi_acc and ref.core.refine_steps == 2


@pytest.fixture(scope="module", params=["direct", "indirect"])
def single(request):
    """Both packages' SCS on one QP in hi_acc mode, scs_tpu's Mats and a
    state 30 iterations in carried across."""
    data, _ = _qp(60, 40, seed=5)
    kw = dict(HI, solver_strategy=request.param)
    sj = scs_tpu.SCS(data, {"l": 60}, **kw)
    stt = scs_tpu_torch.SCS(data, {"l": 60}, **kw, **CPU)
    assert sj.core.hi_acc and stt.core.hi_acc
    it = jax.jit(sj.core._iter_body)
    state = sj._state0
    for _ in range(30):
        state = it(state, sj.mats)
    return sj, stt.core, mats_from_numpy(_np(sj.mats)), state, state_from_numpy(_np(state))


@pytest.mark.parametrize("op", ["_Ax_hi", "_ATy_hi", "_Px_hi"])
def test_compensated_operators_match(single, op):
    sj, ct, mats_t, _, _ = single
    cj = sj.core
    v = np.random.RandomState(7).randn(cj.m if op == "_ATy_hi" else cj.n).astype(np.float32)
    out_j = getattr(cj, op)(sj.mats, jax.numpy.asarray(v))
    out_t = getattr(ct, op)(mats_t, torch.as_tensor(v))
    assert out_t.dtype == torch.float32
    _close(out_t.numpy(), out_j, OPS)


def test_compensated_solve_pieces_match(single):
    """_dot_hi, _matvec_S_hi and g (whose rhs, refinement and gy are
    compensated) at the carried state."""
    sj, ct, mats_t, st_j, st_t = single
    cj = sj.core
    a = np.random.RandomState(8).randn(2, cj.n).astype(np.float32)
    _close(ct._dot_hi(torch.as_tensor(a[0]), torch.as_tensor(a[1])).numpy(),
           cj._dot_hi(jax.numpy.asarray(a[0]), jax.numpy.asarray(a[1])), OPS)
    dy = 1.0 / cj._ry(st_j.scale)
    _close(ct._matvec_S_hi(mats_t, torch.as_tensor(np.array(dy)), torch.as_tensor(a[0])).numpy(),
           cj._matvec_S_hi(sj.mats, dy, jax.numpy.asarray(a[0])), OPS)
    if not cj.indirect:
        gx_j, gy_j = cj._compute_g(sj.mats, st_j.scale, st_j.L)
        gx_t, gy_t = ct._compute_g(mats_t, st_t.scale, st_t.L)
        _close(gx_t.numpy(), gx_j, 1e-5)
        _close(gy_t.numpy(), gy_j, 1e-5)


def _residuals_close(out_t, out_j):
    """Core._residuals' outputs of the two packages: the terms' norms and the
    objective terms to NORMS relative, each residual (primal, dual, gap,
    objectives) to TERMS of the largest of its terms, per problem."""
    (dt, denoms_t, scal_t), (dj, denoms_j, scal_j) = out_t, out_j
    for a, b in zip((*denoms_t, *scal_t), (*denoms_j, *scal_j)):
        _close(a.numpy(), b, NORMS)
    nAx, ns, nPx, nAty = (np.asarray(v, np.float64) for v in denoms_j)
    ctx, bty, xPx = (np.abs(np.asarray(v, np.float64)) for v in scal_j)
    pri, dual = np.maximum(nAx, ns), np.maximum(nPx, nAty)
    obj = np.maximum(np.maximum(ctx, bty), xPx)
    for f, scale in (("res_pri", pri), ("res_dual", dual), ("gap", obj), ("pobj", obj),
                     ("dobj", obj), ("ax_s_btau_2", pri), ("px_aty_ctau_2", dual)):
        a, b = getattr(dt, f).numpy().astype(np.float64), np.asarray(getattr(dj, f), np.float64)
        assert np.all(np.abs(a - b) <= TERMS * scale), (f, a, b, scale)


def test_residual_scalars_match(single):
    sj, ct, mats_t, st_j, st_t = single
    _residuals_close(ct._residuals(st_t, mats_t), sj.core._residuals(st_j, sj.mats))


@pytest.fixture(scope="module")
def batched():
    """Both packages' BatchedSCS on 3 QPs in hi_acc mode; scs_tpu's batched
    state after one chunk, carried across."""
    probs = [_qp(50, 30, seed=20 + i) for i in range(3)]
    A = np.stack([np.asarray(d["A"].todense()) for d, _ in probs])
    P = np.stack([_full(d["P"]) for d, _ in probs])
    data = {"A": A, "P": P, "b": np.stack([d["b"] for d, _ in probs]),
            "c": np.stack([d["c"] for d, _ in probs])}
    kw = dict(HI, check_interval=10)
    sj = jb.BatchedSCS({k: v.copy() for k, v in data.items()}, {"l": 50}, **kw)
    stt = scs_tpu_torch.BatchedSCS({k: v.copy() for k, v in data.items()}, {"l": 50}, **kw, **CPU)
    assert sj.core.hi_acc and stt.core.hi_acc
    assert stt.core.refine_steps == sj.core.refine_steps == 2
    state = jax.jit(jax.vmap(sj.core._chunk))(sj._states, sj.mats)
    return sj, stt.core, mats_from_numpy(_np(sj.mats)), state, batch_state_from_numpy(_np(state))


def _full(Pu):
    U = np.asarray(Pu.todense())
    return U + U.T - np.diag(np.diag(U))


@pytest.mark.parametrize("op", ["_Ax_hi", "_ATy_hi", "_Px_hi"])
def test_batched_compensated_operators_match(batched, op):
    sj, ct, mats_t, _, _ = batched
    cj = sj.core
    v = np.random.RandomState(9).randn(3, cj.m if op == "_ATy_hi" else cj.n).astype(np.float32)
    out_j = jax.vmap(getattr(cj, op))(sj.mats, jax.numpy.asarray(v))
    out_t = getattr(ct, op)(mats_t, torch.as_tensor(v))
    _close(out_t.numpy(), out_j, OPS)


def test_batched_residual_scalars_match(batched):
    sj, ct, mats_t, st_j, st_t = batched
    _residuals_close(ct._residuals(st_t, mats_t), jax.vmap(sj.core._residuals)(st_j, sj.mats))


def _kkt(data, sol):
    A = np.asarray(data["A"].todense(), np.float64)
    P = _full(data["P"])
    x, y, s = (np.asarray(sol[k], np.float64) for k in ("x", "y", "s"))
    rp = np.linalg.norm(A @ x + s - data["b"])
    rd = np.linalg.norm(P @ x + A.T @ y + data["c"])
    scale_p = 1 + max(np.linalg.norm(A @ x), np.linalg.norm(data["b"]))
    scale_d = 1 + max(np.linalg.norm(P @ x), np.linalg.norm(data["c"]))
    return rp / scale_p, rd / scale_d


@pytest.mark.parametrize("package", ["scs_tpu", "scs_tpu_torch"])
def test_qp_eps6_f32_matches_f64(package):
    """tests/test_hi_accuracy.py::test_qp_eps6_f32_matches_f64 through both
    packages: solved, the objective to 5 decimals of the f64 optimum, f64
    KKT on the raw data within 2e-6 of its scale."""
    data, p_star = _qp(150, 100, seed=7)
    kw = dict(HI, max_iters=50000)
    if package == "scs_tpu":
        sol = scs_tpu.solve(dict(data), {"l": 150}, **kw)
    else:
        sol = scs_tpu_torch.solve(dict(data), {"l": 150}, **kw, **CPU)
    assert sol["info"]["status"] == "solved"
    assert_almost_equal(sol["info"]["pobj"], p_star, decimal=5)
    rp, rd = _kkt(data, sol)
    assert rp < 2e-6 and rd < 2e-6, (rp, rd)


@pytest.mark.parametrize("package", ["scs_tpu", "scs_tpu_torch"])
def test_qp_eps6_f32_batched(package):
    """tests/test_hi_accuracy.py::test_qp_eps6_f32_batched through both
    packages: every problem certifies, objectives to 5 decimals."""
    probs = [_qp(60, 40, seed=10 + i) for i in range(4)]
    data = {
        "A": np.stack([np.asarray(d["A"].todense()) for d, _ in probs]),
        "P": np.stack([_full(d["P"]) for d, _ in probs]),
        "b": np.stack([d["b"] for d, _ in probs]),
        "c": np.stack([d["c"] for d, _ in probs]),
    }
    kw = dict(HI, max_iters=50000)
    if package == "scs_tpu":
        res = scs_tpu.solve_batch(data, {"l": 60}, **kw)
    else:
        res = scs_tpu_torch.solve_batch(data, {"l": 60}, **kw, **CPU)
    for (_, p_star), r in zip(probs, res):
        assert r["info"]["status"] == "solved"
        assert_almost_equal(r["info"]["pobj"], p_star, decimal=5)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["direct", "indirect"])
def test_hi_acc_solve_on_card(cuda_device, strategy):
    """The eps 1e-6 f32 QP on the card through D1: solved, the objective
    within 1e-5 of the optimum relative to 1 + |p*| (chip_smoke.py phase 7's
    gate: a solve at eps 1e-6 bounds the gap by eps times the objective's
    terms, ~10 here, not to 5 decimals absolute), f64 KKT; every compensated
    product launched the kernel."""
    from scs_tpu_torch.ops import df32

    data, p_star = _qp(150, 100, seed=7)
    before = (df32.mv.launches, df32.tv.launches)
    sol = scs_tpu_torch.solve(dict(data), {"l": 150}, **HI, max_iters=50000,
                              solver_strategy=strategy, device="cuda")
    assert df32.mv.launches > before[0] and df32.tv.launches > before[1]
    assert sol["info"]["status"] == "solved"
    assert abs(sol["info"]["pobj"] - p_star) <= 1e-5 * (1 + abs(p_star))
    rp, rd = _kkt(data, sol)
    assert rp < 2e-6 and rd < 2e-6, (rp, rd)
