"""Observability parity: scs_tpu_torch's CSV trace, instrumented loop
(phase_timing="always") and phase timers against scs_tpu's, on the CPU in
f64 — the cases of tests/test_observability.py over both packages.

The instrumented loop runs a check after every iteration, so its
trajectory is compared row by row: the same status, the same iteration
count, one CSV row per iteration in both, and the residual columns to
rtol 1e-8 (each column against its largest value over the trajectory, as
the other parity tests compare vectors). Two problems:

  * the 90 x 60 LP of test_observability.py's instrumented-loop test
    without AA (acceleration_lookback=0), capped at 300 iterations. Under
    AA this LP's trajectory is chaotic: the first AA trial turns the two
    packages' 1e-15 summation differences into 1e-10, and at eps 1e-7 the
    iteration counts part by hundreds (1085 against 1674 under "direct";
    still 1522 against 1418 at acceleration_regularization 1e-4), as
    scs_tpu's own count moves under a 1e-15 change of b. Without AA the
    two agree to 5e-12 over 2000 rows, but need 16,497 iterations to
    reach eps 1e-7, so the run is capped;
  * test_observability.py's QP (seed 1) at eps 1e-7 under the stabilising
    settings of the other parity tests (acceleration_regularization 1e-4,
    CG to its floor): solved in 253 iterations by both, under each
    strategy.

Wall-clock comparisons are no parity: test_observability.py's
auto/instrumented ratio holds the port's two timers to each other on its
900 x 600 QP, and runs here on the card
(test_auto_timers_within_20pct_of_instrumented_on_card, marked cuda), with
that test's bands and its one retry, as chip_smoke.py's phase 13 does.
"""

import csv

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import scs_tpu
import scs_tpu.batch as jb
import scs_tpu_torch
import scs_tpu_torch.batch as tb
from scs_tpu.io import CSV_COLUMNS as JAX_CSV_COLUMNS
from scs_tpu_torch.io import CSV_COLUMNS
from scs_tpu_torch.tools import timer_proto
from test_observability import _qp

# the port's entry points run on the card unless told otherwise
CPU = dict(device="cpu")

torch.set_num_threads(1)

RTOL = 1e-8
RESIDUAL_COLUMNS = [
    "res_pri", "res_dual", "gap",
    "ax_s_btau_nrm_inf", "px_aty_ctau_nrm_inf", "ax_s_btau_nrm_2", "px_aty_ctau_nrm_2",
    "res_infeas", "res_unbdd_a", "res_unbdd_p",
    "res_pri_normalized", "res_dual_normalized", "gap_normalized",
    "ax_s_btau_nrm_inf_normalized", "px_aty_ctau_nrm_inf_normalized",
    "ax_s_btau_nrm_2_normalized", "px_aty_ctau_nrm_2_normalized",
]
STAB = dict(acceleration_regularization=1e-4, cg_tol_factor=1e-12)


def _lp118():
    """test_observability.py's instrumented-loop LP (its line 118)."""
    rng = np.random.RandomState(7)
    m, n = 90, 60
    A = rng.randn(m, n) / np.sqrt(m)
    b = A @ rng.randn(n) + np.abs(rng.randn(m))
    c = -(A.T @ np.abs(rng.randn(m)))  # dual-feasible => bounded LP
    return {"A": sp.csc_matrix(A), "b": b, "c": c}, {"l": m}


# name -> (problem, settings)
CASES = {
    "lp118_no_aa": (_lp118, dict(acceleration_lookback=0, cg_tol_factor=1e-12, max_iters=300)),
    "qp_stab": (lambda: _qp(seed=1), dict(STAB, max_iters=2000)),
}
STRATEGIES = {"direct": {}, "indirect": {}, "bell": dict(bell_block_size=16)}


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _instrumented(pkg, dev, data, cone, path, **kw):
    solver = pkg.SCS(data, cone, eps_abs=1e-7, eps_rel=1e-7, verbose=False,
                     phase_timing="always", log_csv_filename=str(path), **kw, **dev)
    return solver.solve(warm_start=False), _rows(path)


def test_csv_columns_match_scs_tpu(tmp_path):
    assert list(CSV_COLUMNS) == list(JAX_CSV_COLUMNS)
    data, cone = _qp()
    heads = []
    for pkg, dev in ((scs_tpu, {}), (scs_tpu_torch, CPU)):
        path = tmp_path / f"{pkg.__name__}.csv"
        pkg.solve(data, cone, verbose=False, log_csv_filename=str(path),
                  max_iters=100, **dev)
        heads.append(path.read_text().splitlines()[0])
    assert heads[0] == heads[1]


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("case", list(CASES))
def test_instrumented_loop_matches_scs_tpu(tmp_path, case, strategy):
    make, kw = CASES[case]
    data, cone = make()
    kw = dict(kw, solver_strategy=strategy, **STRATEGIES[strategy])
    sj, rows_j = _instrumented(scs_tpu, {}, data, cone, tmp_path / "j.csv", **kw)
    st, rows_t = _instrumented(scs_tpu_torch, CPU, data, cone, tmp_path / "t.csv", **kw)
    ij, it = sj["info"], st["info"]
    assert it["status"] == ij["status"]
    assert it["iter"] == ij["iter"]
    assert len(rows_t) == len(rows_j) == it["iter"]
    iters = [int(r["iter"]) for r in rows_t]
    assert iters == list(range(1, it["iter"] + 1))
    for col in RESIDUAL_COLUMNS:
        a = np.array([float(r[col]) for r in rows_t])
        b = np.array([float(r[col]) for r in rows_j])
        fin = np.isfinite(b)
        scale = max(float(np.abs(b[fin]).max(initial=0.0)), 1e-300)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale, err_msg=col)
    # real accumulated timers, a subset of the wall
    assert it["lin_sys_time"] > 0 and it["cone_time"] > 0
    if it["aa_stats"]["iter"] > 0:
        assert it["accel_time"] > 0
    assert it["lin_sys_time"] + it["cone_time"] + it["accel_time"] < it["solve_time"]


def test_instrumented_phase_timers_and_per_iteration_csv(tmp_path):
    """test_observability.py's instrumented-loop test on the port, at the
    default settings."""
    data, cone = _lp118()
    path = str(tmp_path / "trace.csv")
    solver = scs_tpu_torch.SCS(
        data, cone, eps_abs=1e-7, eps_rel=1e-7, verbose=False,
        max_iters=2000, phase_timing="always", log_csv_filename=path, **CPU,
    )
    assert solver.stg.check_interval == 1  # as in scs_tpu
    info = solver.solve(warm_start=False)["info"]
    assert info["status"] == "solved"
    assert info["lin_sys_time"] > 0 and info["cone_time"] > 0
    total = info["lin_sys_time"] + info["cone_time"] + info["accel_time"]
    assert total < info["solve_time"]
    rows = _rows(path)
    iters = [int(r["iter"]) for r in rows]
    assert len(rows) == info["iter"]
    assert all(b - a == 1 for a, b in zip(iters, iters[1:]))
    info2 = solver.solve(warm_start=False)["info"]
    total2 = info2["lin_sys_time"] + info2["cone_time"] + info2["accel_time"]
    assert total2 > 0.2 * info2["solve_time"]


def test_instrumented_time_limit_matches_scs_tpu():
    """A time limit stops the instrumented loop after its first check, with
    the status scs_tpu gives."""
    data, cone = _qp(seed=1)
    kw = dict(verbose=False, phase_timing="always", time_limit_secs=1e-9, max_iters=100)
    ij = scs_tpu.solve(data, cone, **kw)["info"]
    it = scs_tpu_torch.solve(data, cone, **kw, **CPU)["info"]
    assert it["iter"] == ij["iter"] == 1
    assert it["status"] == ij["status"]


def test_instrumented_interrupt_keeps_last_state(monkeypatch):
    """Ctrl-C inside an iteration: the solve returns the state of the last
    completed iteration with the SIGINT status."""
    data, cone = _qp(seed=1)
    solver = scs_tpu_torch.SCS(data, cone, verbose=False, phase_timing="always", **CPU)
    core, calls = solver.core, []
    tail = core._iter_tail

    def interrupting_tail(state, st1, mats):
        calls.append(1)
        if len(calls) == 5:
            raise KeyboardInterrupt
        return tail(state, st1, mats)

    monkeypatch.setattr(core, "_iter_tail", interrupting_tail)
    sol = solver.solve()
    assert sol["info"]["status"] == "interrupted"
    assert sol["info"]["iter"] == 4
    assert np.all(np.isfinite(sol["x"]))


def test_phase_timers_off():
    data, cone = _qp(seed=2)
    for pkg, dev in ((scs_tpu, {}), (scs_tpu_torch, CPU)):
        info = pkg.SCS(data, cone, verbose=False, phase_timing="off",
                       eps_abs=1e-6, eps_rel=1e-6, **dev).solve()["info"]
        assert info["lin_sys_time"] == 0.0
        assert info["cone_time"] == 0.0
        assert info["accel_time"] == 0.0


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_auto_timers_sampled_along_the_solve_leave_it_unchanged(capsys, strategy):
    """The "auto" timers time rounds of the instrumented sequence during
    the pipelined solve (verbose switches them on from the first chunk):
    300 iterations are 12 chunks, rounds after chunks 1-4 weighted 1 and
    6-12 weighted 2; the iterates are those of phase_timing="off", bit for
    bit, and the timers the rounds' weighted mean times the counts."""
    data, cone = _lp118()
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, max_iters=300, verbose=True,
              **STRATEGIES[strategy], **CPU)
    off = scs_tpu_torch.SCS(data, cone, phase_timing="off", **kw).solve()
    solver = scs_tpu_torch.SCS(data, cone, phase_timing="auto", **kw)
    auto = solver.solve()
    capsys.readouterr()
    assert auto["info"]["iter"] == off["info"]["iter"] == 300
    for key in ("x", "y", "s"):
        assert np.array_equal(auto[key], off[key]), key
    samples = solver.core._phase_samples
    assert [w for w, _ in samples] == [1, 1, 1, 1, 2, 2, 2, 2]
    w = np.array([w for w, _ in samples], np.float64)
    mean = w @ np.stack([t for _, t in samples]) / w.sum()
    info = auto["info"]
    assert info["lin_sys_time"] == pytest.approx(mean[0] * 300, rel=1e-12)
    assert info["cone_time"] == pytest.approx(mean[1] * 300, rel=1e-12)
    assert info["accel_time"] == pytest.approx(
        mean[2] * info["aa_stats"]["iter"], rel=1e-12)
    assert min(mean) > 0


@pytest.mark.parametrize("phase_timing", ["auto", "always"])
def test_verbose_footer_shows_breakdown(capsys, phase_timing):
    data, cone = _qp(seed=3)
    footers = []
    for pkg, dev in ((scs_tpu, {}), (scs_tpu_torch, CPU)):
        pkg.SCS(data, cone, verbose=True, eps_abs=1e-6, eps_rel=1e-6,
                phase_timing=phase_timing, **dev).solve()
        out = capsys.readouterr().out
        assert "lin-sys:" in out and "cones:" in out and "accel:" in out
        footers.append([ln.split()[0] for ln in out.splitlines()[-6:]])
    assert footers[0] == footers[1]


def _dense_batch(B=3, m=40, n=25, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(B, m, n) / np.sqrt(m)
    G = rng.randn(B, n, 4)
    P = 0.1 * G @ G.transpose(0, 2, 1) + 1e-3 * np.eye(n)
    x0 = rng.randn(B, n)
    b = np.einsum("bmn,bn->bm", A, x0) + np.abs(rng.randn(B, m))
    c = rng.randn(B, n)
    return {"A": A, "P": P, "b": b, "c": c}, {"l": m}


def _bell_batch(B=3, m=48, n=32, seed=1):
    rng = np.random.RandomState(seed)
    As, bs, cs = [], [], []
    for _ in range(B):
        A = (sp.random(m, n, density=0.15, random_state=rng) + sp.eye(m, n)).tocsc()
        As.append(A)
        bs.append(A @ rng.randn(n) + np.abs(rng.randn(m)))
        cs.append(-(A.T @ np.abs(rng.randn(m))))
    return {"A": As, "b": np.stack(bs), "c": np.stack(cs)}, {"l": m}


BATCHES = {
    "dense": (_dense_batch, dict(solver_strategy="direct")),
    "bell": (_bell_batch, dict(solver_strategy="bell", bell_block_size=16)),
}


@pytest.mark.parametrize("kind", list(BATCHES))
def test_batched_always_fills_timers_and_keeps_iterates(kind):
    make, kw = BATCHES[kind]
    data, cone = make()
    kw = dict(kw, eps_abs=1e-5, eps_rel=1e-5, verbose=False, **CPU)
    auto = tb.BatchedSCS(data, cone, phase_timing="auto", **kw).solve()
    solver = tb.BatchedSCS(data, cone, phase_timing="always", **kw)
    always = solver.solve()
    pt = solver.phase_times()
    for ra, rw in zip(auto, always):
        assert rw["info"]["status"] == ra["info"]["status"] == "solved"
        assert rw["info"]["iter"] == ra["info"]["iter"]
        for k in ("x", "y", "s"):
            np.testing.assert_array_equal(rw[k], ra[k])
        it = rw["info"]["iter"]
        assert rw["info"]["lin_sys_time"] == pytest.approx(pt["lin_sys"] * it / len(always))
        assert rw["info"]["lin_sys_time"] > 0 and rw["info"]["cone_time"] > 0
        assert rw["info"]["accel_time"] > 0
        assert ra["info"]["lin_sys_time"] == 0.0  # "auto" stays off in a batch


@pytest.mark.parametrize("kind", list(BATCHES))
def test_batched_phase_times_keys(kind):
    make, kw = BATCHES[kind]
    data, cone = make()
    kw = dict(kw, eps_abs=1e-5, eps_rel=1e-5, verbose=False)
    pj = jb.BatchedSCS(data, cone, **kw).phase_times()
    solver = tb.BatchedSCS(data, cone, **kw, **CPU)
    pt = solver.phase_times()
    assert set(pt) == set(pj) == {"lin_sys", "cone", "accel_trial"}
    assert all(v > 0 for v in pt.values())
    assert solver.phase_times() is pt  # cached
    # states are cleared by a solve; phase_times re-creates them
    solver.solve()
    solver._phase_cache = None
    assert all(v > 0 for v in solver.phase_times().values())
    no_aa = tb.BatchedSCS(data, cone, **kw, acceleration_lookback=0, **CPU).phase_times()
    assert no_aa["accel_trial"] == 0.0 and no_aa["lin_sys"] > 0


@pytest.mark.cuda
def test_auto_timers_within_20pct_of_instrumented_on_card():
    """tests/test_observability.py:159 on the port, on the card (f32 at eps
    1e-5: the high-accuracy mode): per iteration, lin_sys + cone of the
    "auto" estimate within 20% of the instrumented loop's measurement, with
    one retry in the reference's load-tolerant band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the timers are compared on the card")
    data, m = timer_proto.qp_900x600()
    kw = dict(timer_proto.QP_KW, device="cuda")
    ratio, _, auto = timer_proto.ratio(data, m, **kw)
    assert auto["lin_sys_time"] + auto["cone_time"] > 0, "auto timers not populated"
    if not (0.8 < ratio < 1.25):
        ratio, _, _ = timer_proto.ratio(data, m, **kw)
        assert 0.7 < ratio < 1.43, ratio
