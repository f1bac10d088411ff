"""The batched bell path: scs_tpu_torch's BatchedSCS against scs_tpu's.

B sparse problems of one shape (tests/test_batch_bell.py's generator, m 96,
n 64, bs 32, f64) go through both packages. scs_tpu runs them as
jax.vmap(Core) over a stacked block-ELL pack; the port runs one batched
core (batch_core.BatchedCore) in masked lockstep. convert.py carries
scs_tpu's batched Mats and State across, so both cores start from
identical numbers.

Tolerances, and why:
  * packs and block-column ids are compared exactly, scalings to 1e-12;
  * one chunk from identical state agrees to rtol 1e-10 under the
    stabilising settings of tests/test_torch_core.py (CG to its floor,
    acceleration_regularization 1e-4). On the LP a 50-iteration chunk
    amplifies summation-order noise past 1e-10 even between scs_tpu's own
    runs, so its chunk is check_interval 10 (one AA trial); the QP runs the
    default 50. CG counts may differ within the 12-step stall window;
  * end to end, the default settings must give equal statuses and pobj
    within eps (relative to 1 + |pobj|); the stabilising settings, on the
    QP batch where they are stable, equal iteration counts.
"""

import jax
import numpy as np
import pytest
import torch
from test_batch_bell import _gen_sparse_batch

import scs_tpu.batch as jb
import scs_tpu_torch as st
from scs_tpu import bench_cli
from scs_tpu_torch import batch as tb
from scs_tpu_torch import bench_cli as torch_bench_cli
from scs_tpu_torch import batch_core
from scs_tpu_torch.convert import batch_state_from_numpy, mats_from_numpy
from scs_tpu_torch.solver import AAState, Core, Diag, Mats, State

# the port's entry points run on the card unless told otherwise
CPU = dict(device="cpu")

torch.set_num_threads(1)

M, N = 96, 64
RTOL = 1e-10
CG_STALL_WINDOW = 12
BASE = dict(solver_strategy="bell", bell_block_size=32, dtype="float64", verbose=False)
STAB = dict(cg_tol_factor=1e-12, acceleration_regularization=1e-4)

# name -> (with_P, B, seed, settings)
CASES = {
    "lp": (False, 4, 3, dict(BASE, **STAB, eps_abs=1e-6, eps_rel=1e-6, check_interval=10)),
    "qp": (True, 4, 11, dict(BASE, **STAB, eps_abs=1e-6, eps_rel=1e-6)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=RTOL, err_msg=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1e-300)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=err_msg)


@pytest.fixture(scope="module")
def pairs():
    """Both packages' BatchedSCS on each case, built once per module."""
    out = {}
    for name, (with_P, B, seed, kw) in CASES.items():
        data, _ = _gen_sparse_batch(B, M, N, seed=seed, with_P=with_P)
        sj = jb.BatchedSCS(dict(data), {"l": M}, **kw)
        out[name] = {
            "sj": sj,
            "st": st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU),
            "mats_t": mats_from_numpy(_np(sj.mats)),
            "vchunk": jax.jit(jax.vmap(sj.core._chunk)),
        }
    return out


@pytest.fixture(scope="module")
def ragged_pair():
    """Both packages' BatchedSCS on 3 QPs of 100 x 70 at block size 32
    (ragged edge tiles in both orientations), and scs_tpu's Mats carried
    across."""
    data, _ = _gen_sparse_batch(3, 100, 70, seed=5, with_P=True)
    kw = dict(BASE, **STAB, eps_abs=1e-6, eps_rel=1e-6)
    sj = jb.BatchedSCS(dict(data), {"l": 100}, **kw)
    return sj, st.BatchedSCS(dict(data), {"l": 100}, **kw, **CPU), mats_from_numpy(_np(sj.mats))


# -- (a) the batched pack ------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_bell_mats_matches_scs_tpu(pairs, case):
    mj, mt = _np(pairs[case]["sj"].mats), pairs[case]["st"].mats
    exact = [(mt.bell.A_blocks, mj.bell.A_blocks), (mt.bell.A_cols, mj.bell.A_cols),
             (mt.bell.At_blocks, mj.bell.At_blocks), (mt.bell.At_cols, mj.bell.At_cols)]
    if mt.pbell is not None:
        exact += [(mt.pbell.blocks, mj.pbell.blocks), (mt.pbell.cols, mj.pbell.cols)]
    for a, b in exact:
        assert tuple(a.shape) == b.shape and a.shape[0] == CASES[case][1]
        np.testing.assert_array_equal(a.numpy(), b)
    assert mt.bell.A_cols.dtype == torch.int32
    for f in ("bn", "cn", "D", "E", "sc_b", "sc_c", "norm_b", "norm_c"):
        np.testing.assert_allclose(getattr(mt, f).numpy(), getattr(mj, f), rtol=1e-12, err_msg=f)
    for f in ("colsq_all", "colsq_zero"):
        np.testing.assert_allclose(getattr(mt.bell, f).numpy(), getattr(mj.bell, f), rtol=1e-12, err_msg=f)
    assert (mt.pbell is None) == (mj.pbell is None)
    if mt.pbell is not None:
        np.testing.assert_allclose(mt.pbell.diag.numpy(), mj.pbell.diag, rtol=1e-12)


def test_setup_g_matches_scs_tpu(pairs):
    for name, p in pairs.items():
        s0j, s0t = p["sj"]._states, p["st"]._states
        _close(s0t.gx.numpy(), s0j.gx, err_msg=name)
        _close(s0t.gy.numpy(), s0j.gy, err_msg=name)


@pytest.mark.parametrize("op", ["_Ax", "_ATy", "_Px"])
def test_batched_operators_match_scs_tpu(ragged_pair, op):
    """BatchedCore._Ax/_ATy/_Px on (B, n) / (B, m) vectors of the true
    lengths (no multiples of the block size: the port pads nothing before
    the product), contiguous and as column slices of a wider tensor,
    against scs_tpu's operators under jax.vmap."""
    sj, s_t, mats_t = ragged_pair
    cj, ct = sj.core, s_t.core
    B = 3
    assert cj.n % 32 and cj.m % 32
    k = cj.m if op == "_ATy" else cj.n
    v = np.random.RandomState(17).randn(B, k + 4)
    out_j = jax.vmap(getattr(cj, op))(sj.mats, jax.numpy.asarray(v[:, :k]))
    for vt in (torch.as_tensor(v[:, :k].copy()), torch.as_tensor(v)[:, :k]):
        out_t = getattr(ct, op)(mats_t, vt)
        assert tuple(out_t.shape) == out_j.shape == (B, cj.m if op == "_Ax" else cj.n)
        _close(out_t.numpy(), out_j)


# -- (b) one batched chunk against jax.vmap(core._chunk) -----------------------


def _assert_states_match(st_t, st_j, N_):
    for f in ("it", "status", "scale_updates", "since_rescale", "rescale_trigger"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f)), f)
    for f in ("n_accept", "n_reject_nonfinite", "n_reject_weight_cap", "n_safeguard_reject",
              "count", "aa_iter"):
        np.testing.assert_array_equal(getattr(st_t.aa, f).numpy(), np.asarray(getattr(st_j.aa, f)), f)
    assert np.all(np.abs(st_t.cg_iters.numpy() - np.asarray(st_j.cg_iters)) <= CG_STALL_WINDOW)
    for i in range(st_t.w.shape[0]):  # per problem: scales differ across the batch
        # u and v are w's split at the cone (v = w - u): w's scale is theirs
        w_scale = float(np.max(np.abs(np.asarray(st_j.w)[i])))
        for f in ("w", "u", "v", "u_sum", "v_sum", "px_warm", "gx", "gy"):
            a, b = getattr(st_t, f)[i].numpy(), np.asarray(getattr(st_j, f))[i]
            if f in ("u", "v"):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * w_scale, err_msg=f"{f}[{i}]")
            else:
                _close(a, b, err_msg=f"{f}[{i}]")
    for f in ("scale", "avg_cnt"):
        _close(getattr(st_t, f).numpy(), getattr(st_j, f), err_msg=f)
    # residuals: differences of terms linear in the iterate, renormalized to
    # norm sqrt(N) (see tests/test_torch_core.py)
    atol = RTOL * np.sqrt(N_)
    for f in Diag._fields:
        a, b = getattr(st_t.diag, f).numpy(), np.asarray(getattr(st_j.diag, f))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=f)
        np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=atol, err_msg=f)
    # the rescale ratio sqrt(rp_rel / rd_rel) is a ratio of residuals: its
    # relative error is half the sum of theirs, atol / res each
    rp, rd = np.asarray(st_j.diag.res_pri), np.asarray(st_j.diag.res_dual)
    ratio = np.asarray(st_j.rescale_ratio)
    bound = (RTOL + 0.5 * (atol / rp + atol / rd)) * ratio
    assert np.all(np.abs(st_t.rescale_ratio.numpy() - ratio) <= bound)


@pytest.mark.parametrize("case,chunks_before", [("lp", 0), ("qp", 0), ("qp", 2)])
def test_batched_chunk_matches_vmap(pairs, case, chunks_before):
    """One chunk from identical state. With two chunks before, the check
    at it 150 tests the ergodic average (avg_cnt 100 > 50) and records
    rescale decisions."""
    p = pairs[case]
    sj = p["sj"]
    state = sj._states
    for _ in range(chunks_before):
        state = p["vchunk"](state, sj.mats)
    out_j = p["vchunk"](state, sj.mats)
    out_t = p["st"].core._chunk(batch_state_from_numpy(_np(state)), p["mats_t"])
    _assert_states_match(out_t, out_j, sj.core.N)
    cg = np.asarray(out_j.cg_iters) - np.asarray(state.cg_iters)
    assert len(set(cg.tolist())) > 1  # the problems hit different CG counts
    assert np.all(np.asarray(out_j.aa.aa_iter) > np.asarray(state.aa.aa_iter))  # AA trials ran
    if chunks_before:
        assert np.asarray(out_j.rescale_trigger).any()


def test_rescale_step_matches_vmap(pairs):
    """rescale_step applies the decisions _check recorded, per problem,
    and undoes the extra since_rescale increment of the others."""
    p = pairs["qp"]
    sj = p["sj"]
    state = sj._states
    for _ in range(2):
        state = p["vchunk"](state, sj.mats)
    assert np.asarray(state.rescale_trigger).all()
    # every problem drifted by it 100; keep the decision of two of them
    trig = np.array([True, False, False, True])
    state = state._replace(rescale_trigger=jax.numpy.asarray(trig))
    out_j = jax.jit(jax.vmap(sj.core.rescale_step))(state, sj.mats)
    out_t = p["st"].core.rescale_step(batch_state_from_numpy(_np(state)), p["mats_t"])
    _assert_states_match(out_t, out_j, sj.core.N)
    np.testing.assert_array_equal(
        np.asarray(out_j.scale_updates) - np.asarray(state.scale_updates), trig.astype(np.int32)
    )


# -- (c) the batched core against the single core, problem by problem ---------


def _row(tree, b):
    """Problem b of a batched NamedTuple tree."""
    if isinstance(tree, tuple):
        return type(tree)(*(_row(t, b) for t in tree))
    return None if tree is None else tree[b]


def _single_state(bs_state, b):
    """Row b of a batch_core.State as a solver.State (host-int counters)."""
    r = _row(bs_state, b)
    aa = AAState(**{
        f: int(getattr(r.aa, f)) if getattr(r.aa, f).dtype == torch.int32 else getattr(r.aa, f)
        for f in AAState._fields
    })
    kw = {}
    for f in State._fields:
        if f == "L":
            kw[f] = torch.zeros((0, 0), dtype=torch.float64)
        elif f == "aa":
            kw[f] = aa
        elif f == "diag":
            kw[f] = r.diag
        elif f == "avg_cnt":
            kw[f] = float(r.avg_cnt)
        elif getattr(r, f).dtype == torch.int32:
            kw[f] = int(getattr(r, f))
        else:
            kw[f] = getattr(r, f)
    return State(**kw)


@pytest.mark.parametrize("with_P", [False, True])
def test_batched_chunks_equal_single_core_per_problem(with_P):
    """Two chunks of the batched core equal the single-problem Core's two
    chunks on every problem: the masks (CG, AA trial) are exact, and what
    differs is the order of summation (a batched row sum against
    torch.dot). adaptive_scale off: the single core rescales in the
    chunk, the batched one between segments. check_interval 10, as for
    the LP above."""
    data, _ = _gen_sparse_batch(4, M, N, seed=3, with_P=with_P)
    kw = dict(BASE, **STAB, eps_abs=1e-6, eps_rel=1e-6, adaptive_scale=False, check_interval=10)
    sb = st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU)
    core1 = Core(M, N, with_P, sb.spec, sb.stg)
    batched = sb._states
    for _ in range(2):
        batched = sb.core._chunk(batched, sb.mats)
    for b in range(sb.B):
        mats_b = _row(sb.mats, b)
        s = _single_state(sb._states, b)
        for _ in range(2):
            s = core1._chunk(s, Mats(*mats_b))
        assert s.it == int(batched.it[b]) == 20
        assert s.status == int(batched.status[b])
        assert s.aa.aa_iter == int(batched.aa.aa_iter[b]) == 2
        assert s.aa.n_accept == int(batched.aa.n_accept[b])
        assert abs(s.cg_iters - int(batched.cg_iters[b])) <= CG_STALL_WINDOW
        w_scale = float(s.w.abs().max())
        for f in ("w", "u", "v"):
            np.testing.assert_allclose(getattr(batched, f)[b].numpy(), getattr(s, f).numpy(),
                                       rtol=RTOL, atol=RTOL * w_scale, err_msg=f"{f}[{b}]")
        for f in ("u_sum", "v_sum"):
            _close(getattr(batched, f)[b].numpy(), getattr(s, f).numpy(), err_msg=f"{f}[{b}]")
        np.testing.assert_allclose(batched.diag.res_pri[b].numpy(), s.diag.res_pri.numpy(),
                                   rtol=RTOL, atol=RTOL * np.sqrt(sb.core.N))


def test_in_chunk_rescale_batch_equals_single_solves():
    """With rescale_in_chunk=True the batched path rescales inside the
    check, as the single path does, and every problem's iteration count
    equals its single solve's, pobj to eps. (The default defers the
    rescale to the segment boundary, one speculative segment late: that,
    not the batching, is why batched and single counts differ.)"""
    data, _ = _gen_sparse_batch(4, M, N, seed=11)
    kw = dict(BASE, eps_abs=1e-4, eps_rel=1e-4, max_iters=3000)
    res = st.solve_batch(dict(data), {"l": M}, rescale_in_chunk=True, **kw, **CPU)
    for i, r in enumerate(res):
        one = {"A": data["A"][i], "b": data["b"][i], "c": data["c"][i]}
        s = st.solve(one, {"l": M}, check_interval=50, **kw, **CPU)["info"]
        assert r["info"]["status"] == s["status"] == "solved"
        assert r["info"]["iter"] == s["iter"]
        assert r["info"]["scale_updates"] == s["scale_updates"]
        assert abs(r["info"]["pobj"] - s["pobj"]) <= 1e-4 * (1 + abs(s["pobj"]))


# -- (d) end to end against scs_tpu's BatchedSCS --------------------------------


def _infos(res):
    return [r["info"] for r in res]


def test_end_to_end_default_settings_lp():
    data, p_star = _gen_sparse_batch(3, M, N, seed=7)
    kw = dict(BASE, eps_abs=1e-4, eps_rel=1e-4, max_iters=3000)
    it_t = _infos(st.solve_batch(dict(data), {"l": M}, **kw, **CPU))
    it_j = _infos(jb.solve_batch(dict(data), {"l": M}, **kw))
    assert [i["status"] for i in it_t] == [i["status"] for i in it_j] == ["solved"] * 3
    for a, b, ps in zip(it_t, it_j, p_star):
        assert abs(a["pobj"] - b["pobj"]) <= 1e-4 * (1 + abs(b["pobj"]))
        assert abs(a["pobj"] - ps) <= 1e-2 * (1 + abs(ps))


@pytest.fixture(scope="module")
def qp8():
    """Eight QPs of mixed difficulty (150 to 300 iterations) under the
    stabilising settings, solved by scs_tpu without compaction."""
    data, p_star = _gen_sparse_batch(8, M, N, seed=11, with_P=True)
    kw = dict(BASE, **STAB, eps_abs=1e-5, eps_rel=1e-5, max_iters=3000)
    sj = jb.BatchedSCS(dict(data), {"l": M}, **kw)
    return data, p_star, kw, _infos(sj.solve()), sj.device_prob_iters


def test_end_to_end_stabilised_iteration_counts(qp8):
    data, p_star, kw, it_j, _ = qp8
    sol = st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU)
    it_t = _infos(sol.solve())
    assert [i["status"] for i in it_t] == [i["status"] for i in it_j] == ["solved"] * 8
    assert [i["iter"] for i in it_t] == [i["iter"] for i in it_j]
    assert len({i["iter"] for i in it_t}) > 2  # mixed difficulty
    assert [i["scale_updates"] for i in it_t] == [i["scale_updates"] for i in it_j]
    for a, b in zip(it_t, it_j):
        assert abs(a["pobj"] - b["pobj"]) <= 1e-6 * (1 + abs(b["pobj"]))
        assert a["aa_stats"]["n_accept"] == b["aa_stats"]["n_accept"]


# -- (e) retirement and compaction ---------------------------------------------


def test_compaction_matches_scs_tpu(qp8, monkeypatch):
    data, p_star, kw, it_plain, _ = qp8
    monkeypatch.setattr(jb.BatchedSCS, "_MIN_BUCKET", 2)
    monkeypatch.setattr(tb.BatchedSCS, "_MIN_BUCKET", 2)
    sizes = []
    compact = tb.BatchedSCS._compact

    def spy(states, mats, idx):
        sizes.append(len(idx))
        return compact(states, mats, idx)

    monkeypatch.setattr(tb.BatchedSCS, "_compact", staticmethod(spy))
    sj = jb.BatchedSCS(dict(data), {"l": M}, **kw)
    it_j = _infos(sj.solve())
    sol = st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU)
    it_t = _infos(sol.solve())
    assert sizes and sizes[-1] < 8  # retirement compacted the batch
    assert sol.device_prob_iters == sj.device_prob_iters < 8 * max(i["iter"] for i in it_t)
    for a, b, c in zip(it_t, it_j, it_plain):
        assert a["status"] == b["status"] == c["status"] == "solved"
        assert a["iter"] == b["iter"] == c["iter"]
        assert abs(a["pobj"] - b["pobj"]) <= 1e-6 * (1 + abs(b["pobj"]))
        assert a["solve_time"] <= max(i["solve_time"] for i in it_t)


# -- (f) a QP with sparse P, default settings ----------------------------------


@pytest.fixture(scope="module")
def qp3():
    data, p_star = _gen_sparse_batch(3, M, N, seed=21, with_P=True)
    kw = dict(BASE, eps_abs=1e-5, eps_rel=1e-5, max_iters=3000)
    return data, p_star, kw


def test_qp_sparse_P_default_settings(qp3):
    data, p_star, kw = qp3
    res = st.solve_batch(dict(data), {"l": M}, **kw, **CPU)
    it_j = _infos(jb.solve_batch(dict(data), {"l": M}, **kw))
    for r, b, ps, A, P, bb, c in zip(res, it_j, p_star, data["A"], data["P"], data["b"], data["c"]):
        a = r["info"]
        assert a["status"] == b["status"] == "solved"
        assert abs(a["pobj"] - b["pobj"]) <= 1e-5 * (1 + abs(b["pobj"]))
        assert abs(a["pobj"] - ps) <= 1e-3 * (1 + abs(ps))
        x, y, s = r["x"], r["y"], r["s"]
        assert np.linalg.norm(A @ x + s - bb) <= 1e-3 * (1 + np.linalg.norm(bb))
        assert np.linalg.norm(P @ x + A.T @ y + c) <= 1e-3 * (1 + np.linalg.norm(c))
        # s and y lie in the cone up to the DR residual (v is not projected)
        assert min(s.min(), y.min()) >= -5e-5 * max(np.linalg.norm(s), np.linalg.norm(y), 1.0)


# -- (g) reset and update --------------------------------------------------------


def test_reset_resolves_bit_for_bit_and_update_equals_fresh(qp3):
    data, _, kw = qp3
    sol = st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU)
    r1 = sol.solve()
    sol.reset()
    r2 = sol.solve()
    for a, b in zip(r1, r2):
        assert a["info"]["iter"] == b["info"]["iter"]
        assert a["info"]["pobj"] == b["info"]["pobj"]
        np.testing.assert_array_equal(a["x"], b["x"])
    b2 = 1.1 * np.asarray(data["b"])
    sol.update(b=b2)
    r3 = sol.solve()
    fresh = st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU)
    fresh.update(b=b2)
    r4 = fresh.solve()
    sj = jb.BatchedSCS(dict(data), {"l": M}, **kw)
    sj.update(b=b2)
    r5 = _infos(sj.solve())
    for a, b, c, orig in zip(r3, r4, r5, r1):
        assert a["info"]["iter"] == b["info"]["iter"]
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["info"]["status"] == c["status"] == "solved"
        assert abs(a["info"]["pobj"] - c["pobj"]) <= 1e-5 * (1 + abs(c["pobj"]))
        assert abs(a["info"]["pobj"] - orig["info"]["pobj"]) > 1e-9


# -- (h) limits and refusals ------------------------------------------------------


def test_time_limit_gives_inaccurate(qp3):
    data, _, kw = qp3
    res = st.solve_batch(dict(data), {"l": M}, **dict(kw, time_limit_secs=1e-9), **CPU)
    for r in res:
        assert r["info"]["status"].endswith("_inaccurate"), r["info"]["status"]
        assert r["info"]["iter"] <= 100  # one segment, then the speculative one


def test_keyboard_interrupt_reports_sigint(qp3, monkeypatch):
    """Ctrl-C in the second segment: the in-flight state is finalized and
    every unfinished problem reports 'interrupted' with its iterates."""
    data, _, kw = qp3
    sol = st.BatchedSCS(dict(data), {"l": M}, **kw, **CPU)
    run_seg = sol.core.run_seg
    calls = []

    def interrupt_second(*args):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return run_seg(*args)

    monkeypatch.setattr(sol.core, "run_seg", interrupt_second)
    res = sol.solve()
    for r in res:
        assert r["info"]["status"] == "interrupted"
        assert r["info"]["iter"] == 50 and np.all(np.isfinite(r["x"]))


def test_dense_input_under_bell_raises_same_valueerror():
    rng = np.random.RandomState(0)
    data = {"A": rng.randn(2, 8, 4), "b": rng.randn(2, 8), "c": rng.randn(2, 4)}
    msgs = []
    for cls, dev in ((jb.BatchedSCS, {}), (tb.BatchedSCS, CPU)):
        with pytest.raises(ValueError, match="list of scipy sparse") as e:
            cls(dict(data), {"l": 8}, solver_strategy="bell", verbose=False, **dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw,item", [
    (dict(solver_strategy="bell", phase_timing="always"), "item 6"),
    (dict(solver_strategy="auto", phase_timing="always"), "item 6"),  # auto: direct
])
def test_unported_strategies_raise(kw, item):
    """These raised NotImplementedError naming ROADMAP.md Queue 1 `item`
    until the batched phase timers were ported; now the batch solves and
    every problem's timers are filled from phase_times()."""
    data, _ = _gen_sparse_batch(2, M, N, seed=1)
    solver = st.BatchedSCS(data, {"l": M}, verbose=False, bell_block_size=32, **kw, **CPU)
    res = solver.solve()
    pt = solver.phase_times()
    for r in res:
        assert r["info"]["status"] == "solved"
        assert r["info"]["lin_sys_time"] == pytest.approx(pt["lin_sys"] * r["info"]["iter"] / 2)
        assert r["info"]["cone_time"] > 0


def test_hi_acc_batch_resolves_and_solves():
    """f32 below eps 3e-5 on a dense batch is the compensated hi_acc mode,
    resolved as under scs_tpu's vmapped Core (2 refinement passes), and
    every problem certifies."""
    data = _gen_dense_batch(2, DM, DN, seed=4)
    kw = dict(solver_strategy="direct", dtype="float32", eps_abs=1e-6, eps_rel=1e-6,
              max_iters=50000, verbose=False)
    sj, stt = jb.BatchedSCS(_copy(data), {"l": DM}, **kw), st.BatchedSCS(_copy(data), {"l": DM}, **kw, **CPU)
    assert stt.core.hi_acc and sj.core.hi_acc
    assert stt.core.refine_steps == sj.core.refine_steps == 2
    for r in stt.solve():
        assert r["info"]["status"] == "solved"


def test_convert_batch_state_types(pairs):
    s = batch_state_from_numpy(_np(pairs["qp"]["sj"]._states))
    assert isinstance(s, batch_core.State)
    B = CASES["qp"][1]
    assert s.it.dtype == torch.int32 and tuple(s.it.shape) == (B,)
    assert s.aa.count.dtype == torch.int32 and s.aa.count.tolist() == [-1] * B
    assert s.rescale_trigger.dtype == torch.bool and not s.rescale_trigger.any()
    assert s.rescale_ratio.dtype == torch.float64 and tuple(s.w.shape) == (B, N + M + 1)


# -- (i) the bench cell's generator ---------------------------------------------


def test_chip_smoke_batch_generator_matches_bench_cli(monkeypatch):
    from test_torch_api import _load_chip_smoke

    captured = {}

    class Stop(Exception):
        pass

    class Capture:
        def __init__(self, data, cone, **kw):
            captured.update(data=data, cone=cone, kw=kw)
            raise Stop

    monkeypatch.setattr(jb, "BatchedSCS", Capture)
    with pytest.raises(Stop):
        bench_cli._bell_batch_submetric(B=3, m=700, n=500, density=0.01, width=6)
    ref = captured["data"]
    assert _load_chip_smoke().gen_bell_batch is torch_bench_cli.gen_bell_batch
    ours = torch_bench_cli.gen_bell_batch(3, 700, 500, 0.01, width=6, seed=11)
    assert captured["cone"] == {"l": 700}
    for a, b in zip(ours["A"], ref["A"]):
        assert (a != b).nnz == 0 and a.shape == b.shape
    np.testing.assert_array_equal(ours["b"], ref["b"])
    np.testing.assert_array_equal(ours["c"], ref["c"])


def test_package_exports_batched_api():
    assert st.BatchedSCS is tb.BatchedSCS and st.solve_batch is tb.solve_batch


# -- (j) the dense batched path -------------------------------------------------
#
# A dense (B, m, n) batch under "direct" (the batched default
# direct_solver="inverse", and "cholesky") and "indirect", against scs_tpu's
# BatchedSCS, f64. acceleration_regularization=1e-4 keeps type-I AA from
# amplifying last-bit differences (see tests/test_torch_api.py); the
# indirect case also runs CG to its floor. Tolerances as above: data to
# 1e-12 (the same operations in the same order), states to rtol 1e-10.
# What was found: from a cold start a 50-iteration chunk (five AA trials)
# carries summation-order noise to ~1e-9 in w on these batches too, so the
# chunks compared from the first iterations are 10 long (one trial), and
# the default 50 is compared from iteration 100 on, where it holds 1e-10.

DM, DN = 40, 30
DENSE_BASE = dict(dtype="float64", verbose=False, eps_abs=1e-6, eps_rel=1e-6,
                  acceleration_regularization=1e-4)
CK10 = dict(DENSE_BASE, check_interval=10)
DENSE_CASES = {
    "qp_inverse": (True, dict(CK10, solver_strategy="direct")),
    "qp_inverse_ck50": (True, dict(DENSE_BASE, solver_strategy="direct")),
    "qp_cholesky": (True, dict(CK10, solver_strategy="direct", direct_solver="cholesky")),
    "lp_inverse": (False, dict(CK10, solver_strategy="direct")),
    "qp_indirect": (True, dict(CK10, solver_strategy="indirect", cg_tol_factor=1e-12)),
}


def _gen_dense_batch(B, m, n, seed=0, with_P=True):
    """B dense feasible problems over the nonnegative cone (the bench
    recipe, scs_tpu.bench_cli.gen_batch, at a small size)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(B, m, n) / np.sqrt(m)
    z = rng.randn(B, m)
    y = np.maximum(z, 0)
    x = rng.randn(B, n)
    data = {"A": A, "b": np.einsum("bmn,bn->bm", A, x) + (y - z)}
    c = -np.einsum("bmn,bm->bn", A, y)
    if with_P:
        G = rng.randn(B, n, 5)
        data["P"] = 0.1 * G @ G.transpose(0, 2, 1) + 1e-3 * np.eye(n)
        c = c - np.einsum("bij,bj->bi", data["P"], x)
    data["c"] = c
    return data


def _copy(data):
    return {k: v.copy() for k, v in data.items()}


@pytest.fixture(scope="module")
def dense_pairs():
    out = {}
    for name, (with_P, kw) in DENSE_CASES.items():
        data = _gen_dense_batch(4, DM, DN, seed=5, with_P=with_P)
        sj = jb.BatchedSCS(_copy(data), {"l": DM}, **kw)
        out[name] = {
            "data": data,
            "sj": sj,
            "st": st.BatchedSCS(_copy(data), {"l": DM}, **kw, **CPU),
            "mats_t": mats_from_numpy(_np(sj.mats)),
            "vchunk": jax.jit(jax.vmap(sj.core._chunk)),
        }
    return out


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_prep_and_setup_match_scs_tpu(dense_pairs, case):
    p = dense_pairs[case]
    mj, mt = _np(p["sj"].mats), p["st"].mats
    assert mt.bell is None and mt.pbell is None
    assert mt.A.is_contiguous() and tuple(mt.A.shape) == (4, DM, DN)
    assert (mt.P is None) == (not DENSE_CASES[case][0])
    for f in ("A", "P", "bn", "cn", "D", "E", "sc_b", "sc_c", "norm_b", "norm_c", "bl", "bu"):
        a = getattr(mt, f)
        if a is None:
            continue
        assert tuple(a.shape) == getattr(mj, f).shape, f
        np.testing.assert_allclose(a.numpy(), getattr(mj, f), rtol=1e-12, err_msg=f)
    core_t, core_j = p["st"].core, p["sj"].core
    assert (core_t.use_inverse, core_t.indirect, core_t.refine_steps, core_t.rescale_in_chunk) == (
        core_j.use_inverse, core_j.indirect, core_j.refine_steps, core_j.rescale_in_chunk)
    s0j, s0t = p["sj"]._states, p["st"]._states
    assert tuple(s0t.L.shape) == np.asarray(s0j.L).shape
    assert s0t.L is p["st"]._L  # the cached factor, not a copy
    for i in range(4):
        _close(s0t.L[i].numpy(), np.asarray(s0j.L)[i], err_msg=f"L[{i}]")
        _close(s0t.gx[i].numpy(), np.asarray(s0j.gx)[i], err_msg=f"gx[{i}]")
        _close(s0t.gy[i].numpy(), np.asarray(s0j.gy)[i], err_msg=f"gy[{i}]")
    sb = p["st"].setup_breakdown
    assert set(sb) == set(p["sj"].setup_breakdown) and all(v >= 0 for v in sb.values())
    assert (sb["factorize"] > 0) and (sb["transfer"] > 0)


def _assert_dense_states_match(st_t, st_j, N_):
    _assert_states_match(st_t, st_j, N_)
    for i in range(st_t.w.shape[0]):
        _close(st_t.L[i].numpy(), np.asarray(st_j.L)[i], err_msg=f"L[{i}]")


@pytest.mark.parametrize("case,chunks_before", [
    ("qp_inverse", 0), ("qp_inverse_ck50", 2), ("qp_cholesky", 0),
    # the LP from its second chunk on: in its cold-start chunk the
    # unboundedness ratio, a quotient by a small -c'x, is off by 1.8e-10
    ("lp_inverse", 1), ("lp_inverse", 5),
    ("qp_indirect", 0),
])
def test_dense_batched_chunk_matches_vmap(dense_pairs, case, chunks_before):
    p = dense_pairs[case]
    sj = p["sj"]
    state = sj._states
    for _ in range(chunks_before):
        state = p["vchunk"](state, sj.mats)
    out_j = p["vchunk"](state, sj.mats)
    out_t = p["st"].core._chunk(batch_state_from_numpy(_np(state)), p["mats_t"])
    _assert_dense_states_match(out_t, out_j, sj.core.N)
    assert np.all(np.asarray(out_j.aa.aa_iter) > np.asarray(state.aa.aa_iter))  # AA trials ran


@pytest.mark.parametrize("case", ["qp_inverse", "qp_cholesky"])
def test_dense_rescale_step_refactorizes_triggered_rows(dense_pairs, case):
    """rescale_step gives the rows that trigger a new factor and g at
    their new scale and leaves the other rows' factor as it was."""
    p = dense_pairs[case]
    sj, core = p["sj"], p["st"].core
    state = sj._states
    for _ in range(2):
        state = p["vchunk"](state, sj.mats)
    trig = np.array([True, False, False, True])
    state = state._replace(
        rescale_trigger=jax.numpy.asarray(trig),
        rescale_ratio=jax.numpy.asarray([3.0, 3.0, 0.2, 0.2]),
    )
    out_j = jax.jit(jax.vmap(sj.core.rescale_step))(state, sj.mats)
    st_t = batch_state_from_numpy(_np(state))
    before = core.factorizations
    out_t = core.rescale_step(st_t, p["mats_t"])
    assert core.factorizations == before + 1
    _assert_dense_states_match(out_t, out_j, sj.core.N)
    assert torch.equal(out_t.L[1], st_t.L[1]) and torch.equal(out_t.L[2], st_t.L[2])
    assert not torch.equal(out_t.L[0], st_t.L[0])
    # no row triggers: no factorization, the same factor tensor
    quiet = st_t._replace(rescale_trigger=torch.zeros(4, dtype=torch.bool))
    assert core.rescale_step(quiet, p["mats_t"]).L is quiet.L
    assert core.factorizations == before + 1


def test_dense_masked_chunk_carries_factor_and_g(dense_pairs):
    p = dense_pairs["qp_inverse"]
    core, mats = p["st"].core, p["st"].mats
    s0 = p["st"]._states
    s1 = core.masked_chunk(s0, mats, 10**6)
    assert s1.L is s0.L and s1.gx is s0.gx and s1.gy is s0.gy
    frozen = core.masked_chunk(s0, mats, 0)  # every row at its cap
    assert torch.equal(frozen.w, s0.w) and frozen.it.tolist() == [0] * 4


@pytest.mark.parametrize("case", ["qp_inverse", "qp_cholesky", "qp_indirect"])
def test_dense_end_to_end_matches_scs_tpu(dense_pairs, case):
    p = dense_pairs[case]
    rj, rt = p["sj"].solve(), p["st"].solve()
    for i, (a, b) in enumerate(zip(rt, rj)):
        assert a["info"]["status"] == b["info"]["status"] == "solved", i
        assert a["info"]["iter"] == b["info"]["iter"], i
        assert abs(a["info"]["pobj"] - b["info"]["pobj"]) <= 1e-6 * (1 + abs(b["info"]["pobj"]))
        for k in ("x", "y", "s"):  # two solves to eps 1e-6 of one problem
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5, err_msg=f"{k}[{i}]")
        assert set(a["info"]) == set(b["info"])
    assert p["st"].bucket_ladder == [4] and p["st"].device_prob_iters > 0


def test_dense_lp_default_settings_solves_like_scs_tpu():
    """Default settings (type-I AA at regularization 1e-8) on an LP batch:
    iteration counts are chaotic in both packages, so the pair is held to
    equal statuses and objectives within 10 eps."""
    data = _gen_dense_batch(5, DM, DN, seed=8, with_P=False)
    kw = dict(dtype="float64", eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    rj = jb.solve_batch(_copy(data), {"l": DM}, **kw)
    rt = st.solve_batch(_copy(data), {"l": DM}, **kw, **CPU)
    for a, b in zip(rt, rj):
        assert a["info"]["status"] == b["info"]["status"] == "solved"
        assert abs(a["info"]["pobj"] - b["info"]["pobj"]) <= 1e-5 * (1 + abs(b["info"]["pobj"]))


def test_dense_in_chunk_rescale_batch_equals_single_solves():
    """With rescale_in_chunk=True the batched core is the single core row
    by row: each problem takes exactly its single-solve iteration count
    (the single path equilibrates on the host in numpy, the batch on the
    device in torch: the same operations)."""
    data = _gen_dense_batch(4, DM, DN, seed=5)
    kw = dict(DENSE_BASE, solver_strategy="direct", direct_solver="inverse",
              check_interval=25, max_iters=20000)
    res = st.BatchedSCS(_copy(data), {"l": DM}, rescale_in_chunk=True, **kw, **CPU).solve()
    from scipy import sparse

    for i, r in enumerate(res):
        one = {"A": sparse.csc_matrix(data["A"][i]), "P": sparse.csc_matrix(np.triu(data["P"][i])),
               "b": data["b"][i], "c": data["c"][i]}
        single = st.solve(one, {"l": DM}, **kw, **CPU)
        assert r["info"]["status"] == single["info"]["status"] == "solved"
        assert r["info"]["iter"] == single["info"]["iter"], i
        assert r["info"]["scale_updates"] == single["info"]["scale_updates"]
        np.testing.assert_allclose(r["x"], single["x"], rtol=1e-6, atol=1e-9)


def test_dense_compaction_matches_scs_tpu():
    """B = 64 = 2 x _MIN_BUCKET: compaction is on at the real ladder floor;
    the factor slot L rides through the gather with every other leaf."""
    B, m, n = 64, 20, 12
    data = _gen_dense_batch(B, m, n, seed=2)
    kw = dict(DENSE_BASE, solver_strategy="direct", max_iters=4000)
    sj = jb.BatchedSCS(_copy(data), {"l": m}, **kw)
    stt = st.BatchedSCS(_copy(data), {"l": m}, **kw, **CPU)
    rj, rt = sj.solve(), stt.solve()
    assert stt.bucket_ladder[0] == 64 and stt.bucket_ladder[-1] == 32
    iters_j = np.array([r["info"]["iter"] for r in rj])
    iters_t = np.array([r["info"]["iter"] for r in rt])
    assert len(set(iters_j.tolist())) > 1  # problems retire at different times
    np.testing.assert_array_equal(iters_t, iters_j)
    assert [r["info"]["status"] for r in rt] == [r["info"]["status"] for r in rj]
    pj = np.array([r["info"]["pobj"] for r in rj])
    pt = np.array([r["info"]["pobj"] for r in rt])
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-6)
    # without compaction: the same answers in one bucket
    flat = st.BatchedSCS(_copy(data), {"l": m}, batch_compaction=False, **kw, **CPU)
    rf = flat.solve()
    assert flat.bucket_ladder == [64]
    np.testing.assert_array_equal([r["info"]["iter"] for r in rf], iters_t)
    assert flat.device_prob_iters > stt.device_prob_iters


def test_dense_update_and_reset_reuse_the_factor():
    data = _gen_dense_batch(4, DM, DN, seed=5)
    kw = dict(DENSE_BASE, solver_strategy="direct")
    keep = _copy(data)
    solver = st.BatchedSCS(data, {"l": DM}, **kw, **CPU)
    for k in data:  # the caller's arrays are never scaled in place
        np.testing.assert_array_equal(data[k], keep[k])
    core = solver.core
    assert core.factorizations == 1
    first = solver.solve()
    n_first = core.factorizations
    solver.reset()
    assert core.factorizations == n_first
    again = solver.solve()
    # a rescale refactorizes its rows between segments; reset() does not
    assert (n_first > 1) == any(r["info"]["scale_updates"] for r in first)
    for a, b in zip(first, again):
        assert a["info"]["iter"] == b["info"]["iter"]
        np.testing.assert_array_equal(a["x"], b["x"])
    n_before = core.factorizations
    rng = np.random.RandomState(3)
    b2 = data["b"] + 0.05 * np.abs(rng.randn(4, DM))
    c2 = data["c"] + 0.05 * rng.randn(4, DN)
    solver.update(b=b2, c=c2)
    assert core.factorizations == n_before  # g only, against the cached factor
    assert solver._states.L is solver._L
    upd = solver.solve()
    sj = jb.BatchedSCS(_copy(data), {"l": DM}, **kw)
    sj.update(b=b2, c=c2)
    ref = sj.solve()
    for a, b in zip(upd, ref):
        assert a["info"]["status"] == b["info"]["status"] == "solved"
        assert a["info"]["iter"] == b["info"]["iter"]
        # two solves to eps 1e-6 of one problem
        np.testing.assert_allclose(a["x"], b["x"], rtol=1e-4, atol=1e-5)


def test_dense_input_forms_and_validation():
    from scipy import sparse

    data = _gen_dense_batch(3, 16, 10, seed=1)
    kw = dict(DENSE_BASE, solver_strategy="direct")
    ref = st.solve_batch(_copy(data), {"l": 16}, **kw, **CPU)
    as_lists = dict(data, A=[sparse.csc_matrix(a) for a in data["A"]], P=list(data["P"]))
    as_tensors = {k: torch.as_tensor(v) for k, v in data.items()}
    for other in (as_lists, as_tensors):
        res = st.solve_batch(other, {"l": 16}, **kw, **CPU)
        for a, b in zip(res, ref):
            np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(as_tensors["A"].numpy(), data["A"])  # untouched
    auto = st.BatchedSCS(_copy(data), {"l": 16}, dtype="float64", **CPU)  # eps 1e-4
    assert auto.stg.solver_strategy == "direct" and auto.stg.direct_solver == "inverse"
    assert auto.stg.lin_refine_steps == 0 and auto.core.refine_steps == 0
    tight = st.BatchedSCS(_copy(data), {"l": 16}, dtype="float64", eps_abs=1e-6, eps_rel=1e-5, **CPU)
    assert tight.stg.lin_refine_steps == -1
    for cls, dev in ((jb.BatchedSCS, {}), (tb.BatchedSCS, CPU)):
        with pytest.raises(ValueError, match=r"shape \(B, m, n\)"):
            cls(dict(data, A=data["A"][0]), {"l": 16}, **kw, **dev)
        with pytest.raises(ValueError, match="cone dimensions incompatible"):
            cls(_copy(data), {"l": 15}, **kw, **dev)
    res, mask = auto.polish(auto.solve())
    assert len(res) == 3 and not mask.any()


def test_dense_f32_batch_solves_at_eps():
    """The flagship's settings at a small size on the CPU: f32, eps 1e-4,
    the inverse apply without refinement; objectives against the f64 run."""
    data = _gen_dense_batch(6, DM, DN, seed=13)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, max_iters=20000)
    s32 = st.BatchedSCS(_copy(data), {"l": DM}, dtype="float32", **kw, **CPU)
    assert s32.mats.A.dtype == torch.float32 and s32._L.dtype == torch.float32
    assert s32.core.use_inverse and s32.core.refine_steps == 0
    r32 = s32.solve()
    r64 = st.solve_batch(_copy(data), {"l": DM}, dtype="float64", **kw, **CPU)
    for a, b in zip(r32, r64):
        assert a["info"]["status"] == b["info"]["status"] == "solved"
        assert a["x"].dtype == np.float32
        assert abs(a["info"]["pobj"] - b["info"]["pobj"]) <= 1e-3 * (1 + abs(b["info"]["pobj"]))
