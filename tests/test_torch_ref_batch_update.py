"""scs_tpu's tests/test_batch_update.py, run against the port on the CPU.

Every case of the reference module runs its own test function, with its
own tolerances, seeds and sizes, through the CPU facade of scs_tpu_torch
(`tests/torch_ref_facade.py`), except the cases of TABLE; each has a
counterpart below that checks the same property through the port's own
internals.

SLOW: test_batched_update_tracks_optima re-solves a batch of three whose
third problem runs to max_iters = 100,000 in both packages after its
second update (scs_tpu too); the port's eager CPU loop takes ~1 ms an
iteration there, so the case alone takes ~370 s on the CPU. It runs in
the slow tier.

test_compaction_ladder_correctness passes in scs_tpu because its
compacted trajectory of problem 7 happens to converge. Its stand-ins
here: the two packages' batched trajectories on its 64 problems, which
agree until type-I Anderson acceleration (regularization 1e-8) blows a
last-bit difference up (the chaos of ROADMAP's Queue 3; without AA they
agree to rounding over hundreds of iterations, rescales included), and
the property the test is about, the compaction ladder, on the port.
"""

import numpy as np
import pytest
import torch

import oracle
import scs_tpu
import test_batch_update as ref
from scs_tpu_torch import polish as polish_mod
from scs_tpu_torch.bench_cli import gen_batch
from torch_ref_facade import BatchedSCS, count_calls, ref_cases, run_ref_case

TABLE = {
    "test_batched_update_path_has_no_cholesky":
        "reads the jaxprs of scs_tpu's BatchedSCS._vfactorize and _vg",
    "test_batched_interrupt_keeps_partial_results":
        "patches scs_tpu's BatchedSCS._vrun_seg, the jitted segment program",
    "test_polish_initial_solve_correct_without_refinement":
        "feeds jax.numpy arrays to scs_tpu.polish.polish_batch",
    "test_compaction_ladder_correctness":
        "its pass rests on scs_tpu's trajectory of a nearly degenerate "
        "problem (7), which type-I AA makes chaotic: the port's trajectory "
        "agrees until AA amplifies a last-bit difference, then problem 7 "
        "stalls to max_iters (as it does in scs_tpu without compaction)",
}
SLOW = {"test_batched_update_tracks_optima"}


@pytest.mark.parametrize("case", ref_cases(ref, table=TABLE, slow=SLOW))
def test_ref(case, monkeypatch, request):
    run_ref_case(ref, case, monkeypatch, request)


# -- counterparts of TABLE ---------------------------------------------------


def test_batched_update_path_has_no_cholesky(monkeypatch):
    """The batched update path reuses the cached factor: the setup
    factorizes once, the g program (reset) and update() run no Cholesky
    and leave the factor object untouched, and the re-solve factorizes
    only where a rescale refactorizes its rows."""
    chol = count_calls(monkeypatch, torch.linalg, "cholesky_ex")
    A, b, c, _ = ref._gen_batch(2, seed=31)
    solver = BatchedSCS({"A": A.copy(), "b": b, "c": c}, ref.K, verbose=False)
    core = solver.core
    assert core.factorizations == 1 and chol["n"] == 1
    L_before = solver._L
    solver.reset()
    solver.update(b=b + 1.0)
    assert chol["n"] == 1 and core.factorizations == 1
    assert solver._L is L_before
    refac = count_calls(monkeypatch, core, "_refactorize_rows")
    res = solver.solve()
    assert core.factorizations - 1 == refac["n"]
    assert all(r["info"]["status"] == "solved" for r in res)


def test_batched_interrupt_keeps_partial_results(monkeypatch):
    """A KeyboardInterrupt mid-batch (from the port's segment runner)
    returns every problem, 'interrupted', with finite iterates."""
    A, b, c, _ = ref._gen_batch(2, seed=51)
    solver = BatchedSCS(
        {"A": A.copy(), "b": b, "c": c}, ref.K,
        eps_abs=0.0, eps_rel=0.0, max_iters=10_000_000, check_interval=10,
        verbose=False,
    )
    real = solver.core.run_seg
    calls = {"n": 0}

    def boom(*args, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise KeyboardInterrupt
        return real(*args, **kw)

    monkeypatch.setattr(solver.core, "run_seg", boom)
    res = solver.solve()
    assert all(r is not None for r in res)
    assert all(r["info"]["status"] == "interrupted" for r in res)
    assert all(np.isfinite(r["x"]).all() for r in res)


def test_polish_initial_solve_correct_without_refinement():
    """With refine=0 the initial masked-KKT solve alone gives a
    near-feasible point of the normalized problem; the active masks are
    built with numpy from the results, as the reference builds them."""
    B, mm, nn = 4, 60, 40
    A, P, b, c, _ = gen_batch(B, mm, nn, seed=13, dtype=np.float64, return_opt=True)
    s = BatchedSCS(
        {"A": A.astype(np.float32), "P": P.astype(np.float32), "b": b, "c": c},
        {"l": mm}, dtype="float32", eps_abs=1e-4, eps_rel=1e-4,
        max_iters=20000, verbose=False,
    )
    res = s.solve()
    zm = np.zeros(mm, bool)
    d = np.stack(
        [zm | (np.asarray(r["y"]) > np.asarray(r["s"])) for r in res]
    ).astype(np.float32)
    mats = s.mats
    xh, yh, sh, ok = polish_mod.polish_batch(
        mats.A, mats.P, mats.bn, mats.cn, torch.as_tensor(d), zm, refine=0
    )
    rp, _, _ = polish_mod.kkt_errors(mats.A, mats.P, mats.bn, mats.cn, xh, yh, sh)
    assert (rp.numpy() < 3e-2).all(), rp


# -- test_compaction_ladder_correctness --------------------------------------

KQ = {"l": 10, "q": [4]}
# the reference case's settings
LADDER = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, check_interval=10,
              batch_compact_interval=1)


def _ladder_batch():
    """The reference case's 64 problems, made as it makes them."""
    rng = np.random.RandomState(77)
    As, bs, cs, stars = [], [], [], []
    for _ in range(64):
        data, p_star, _ = oracle.gen_feasible(KQ, n=ref.n, density=0.5, rng=rng)
        As.append(np.asarray(data["A"].todense()))
        bs.append(data["b"])
        cs.append(data["c"])
        stars.append(p_star)
    return np.stack(As), np.stack(bs), np.stack(cs), np.array(stars)


def _gaps(segments, **settings):
    """Run both packages' batches segment by segment, in the solve loop's
    order (one segment ahead; a rescale recorded at a check applied to the
    next state), compaction off. Per check: the largest relative gap of
    (u, v) and of the scale per problem, and whether both packages read
    the same statuses, iteration counts, rescale triggers and scale
    updates."""
    A, b, c, _ = _ladder_batch()
    kw = dict(LADDER, batch_compaction=False, max_iters=100_000, **settings)
    J = scs_tpu.BatchedSCS({"A": A.copy(), "b": b, "c": c}, KQ, **kw)
    T = BatchedSCS({"A": A.copy(), "b": b, "c": c}, KQ, **kw)
    J.reset()
    mi = kw["max_iters"]
    js = J._vrun_seg(J._states, J.mats, mi, 1)
    ts = T.core.run_seg(T._states, T.mats, mi, 1)

    def rel(a, b):
        a, b = np.asarray(a), b.numpy()
        return np.abs(a - b).max(-1) / np.maximum(np.abs(a).max(-1), 1e-300)

    gaps, same = [], []
    for _ in range(segments):
        jn = J._vrun_seg(js, J.mats, mi, 1)
        tn = T.core.run_seg(ts, T.mats, mi, 1)
        gaps.append(np.maximum.reduce([
            rel(js.u, ts.u), rel(js.v, ts.v), rel(js.scale[:, None], ts.scale[:, None])]))
        same.append(all(
            np.array_equal(np.asarray(getattr(js, k)), getattr(ts, k).numpy())
            for k in ("status", "it", "rescale_trigger", "scale_updates")))
        trig_j, trig_t = bool(np.asarray(js.rescale_trigger).any()), bool(ts.rescale_trigger.any())
        js, ts = jn, tn
        if trig_j:
            js = J._vrescale(js, J.mats)
        if trig_t:
            ts = T.core.rescale_step(ts, T.mats)
    return np.array(gaps), same


def test_compaction_case_trajectories():
    """The two packages' batched states on the 64 problems, compaction
    off. Without AA they agree to rounding over 300 iterations, the
    rescales of 40-odd problems included: the DR map, the checks and the
    rescale schedule are the same. Under the case's own settings (type-I
    AA, regularization 1e-8) problem 7 agrees to the last bits over its
    first two checks (4e-15 and 8e-15 where measured), until AA
    extrapolates from a full memory; past that (iteration 30 where
    measured) the gap grows to O(1), and in both packages problem 7 then
    stalls to max_iters without compaction (ROADMAP, Queue 3)."""
    gaps, same = _gaps(30, acceleration_lookback=0)
    assert all(same)
    assert gaps.max() < 1e-6 and np.median(gaps) < 1e-10
    gaps, same = _gaps(2)
    assert all(same)
    assert gaps[:, 7].max() < 1e-12


def test_compaction_ladder_keeps_retired_results(monkeypatch):
    """The compaction ladder on the port, on the 64 problems at the case's
    settings: every problem that retired before the first compaction
    returns, at its original position, the iterates it returns without
    compaction, bit for bit; every solved problem is within the case's
    tolerance of its p*. max_iters is cut to 2,000 (the case's 100,000 is
    ~5 min of the port's CPU loop at bucket 32), so the problems the case
    needs longer for end solved_inaccurate, and only the solved are held to
    p*."""
    A, b, c, stars = _ladder_batch()
    runs, retired = {}, {}
    for compact in (True, False):
        solver = BatchedSCS({"A": A.copy(), "b": b, "c": c}, KQ, **LADDER,
                            max_iters=2000, batch_compaction=compact)
        assert solver.stg.batch_compaction == compact
        real = solver._compact
        kept = []

        def recording(states, mats, idx, kept=kept, real=real):
            kept.append(set(idx.tolist()))
            return real(states, mats, idx)

        monkeypatch.setattr(solver, "_compact", recording)
        runs[compact] = solver.solve()
        retired[compact] = set(range(64)) - kept[0] if kept else set()
        assert len(runs[compact]) == 64
    assert not retired[False] and retired[True]
    for i in retired[True]:
        on, off = runs[True][i], runs[False][i]
        assert on["info"]["status"] == off["info"]["status"]
        assert on["info"]["iter"] == off["info"]["iter"]
        for k in ("x", "y", "s"):
            np.testing.assert_array_equal(on[k], off[k])
    for res in runs.values():
        for i, r in enumerate(res):
            if r["info"]["status"] == "solved":
                np.testing.assert_allclose(c[i] @ r["x"], stars[i], rtol=1e-3, atol=1e-3)
