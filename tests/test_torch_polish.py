"""Active-set polish (scs_tpu_torch/polish.py and BatchedSCS.polish) against
scs_tpu's on the same numpy inputs, on the CPU in float32.

What is compared: the batched polish on a fixed active mask against
scs_tpu's `_polish_one` problem by problem (x, y, s to 1e-5 relative, the
sign verdict and the number of active-set repair rounds each problem ran
equal: the host loop over a live mask must freeze a row exactly where
vmap's while_loop does); kkt_errors; the four tests of tests/test_polish.py
through both packages; and the bench generator the polish cell runs on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scs_tpu
import scs_tpu.polish as jpolish
import scs_tpu_torch
from scs_tpu.bench_cli import gen_batch as jax_gen_batch
from scs_tpu_torch import polish
from scs_tpu_torch.tools.flagship import gen_batch

CPU = dict(device="cpu")
PACKAGES = ["scs_tpu", "scs_tpu_torch"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_polish_rows(A, P, b, c, d, zero_mask, monkeypatch, refine=3):
    """scs_tpu's _polish_one on each problem, eagerly, with the number of
    repair rounds its while_loop ran (its final counter)."""
    rounds = []
    loop = jax.lax.while_loop

    def counted(cond, body, init):
        out = loop(cond, body, init)
        rounds.append(int(out[-1]))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    outs = []
    with jax.disable_jit():
        for i in range(A.shape[0]):
            outs.append([np.asarray(t) for t in jpolish._polish_one(
                jnp.asarray(A[i]), jnp.asarray(P[i]), jnp.asarray(b[i]), jnp.asarray(c[i]),
                jnp.asarray(d[i]), 1e-6, refine, zero_mask)])
    return [np.stack(t) for t in zip(*outs)], np.array(rounds)


def _planted_batch(B=4, m=40, n=60, seed=3, wrong=0):
    """B QPs in f32 with a planted optimum (x*, y*, s*) and a well
    conditioned KKT system (P = G G'/k + I/2, fewer rows than columns: the
    bench's P, 0.1 G G'/k + 1e-4 I, at m > n leaves x determined only to
    ~1e4 f32 roundings on the null space of the active rows at this size,
    where two summation orders differ by 1e-4); the first 5 rows are
    zero-cone rows. d is the planted active set (y* > s*)
    with, per problem, the `wrong` most clearly active rows released and the
    `wrong` most clearly inactive ones bound."""
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((B, m, n)) / np.sqrt(m)
    G = rng.standard_normal((B, n, n // 4))
    P = G @ G.transpose(0, 2, 1) / (n // 4) + 0.5 * np.eye(n)
    z = rng.standard_normal((B, m))
    zero_mask = np.zeros(m, bool)
    zero_mask[:5] = True
    y = np.where(zero_mask, z, np.maximum(z, 0))
    s = np.where(zero_mask, 0.0, y - z)
    x = rng.standard_normal((B, n))
    c = -(A.transpose(0, 2, 1) @ y[..., None])[..., 0] - (P @ x[..., None])[..., 0]
    b = (A @ x[..., None])[..., 0] + s
    d = (z > 0) | zero_mask
    if wrong:
        order = np.argsort(np.where(zero_mask, 0.0, z), axis=1)
        rows = np.arange(B)[:, None]
        d[rows, order[:, -wrong:]] = False  # the largest multipliers, released
        d[rows, order[:, :wrong]] = True  # the largest slacks, bound
    A, P, b, c = (a.astype(np.float32) for a in (A, P, b, c))
    return A, P, b, c, d.astype(np.float32), zero_mask


def test_polish_batch_matches_scs_tpu_per_problem(monkeypatch):
    """Two rows of each problem's active set wrong each way: 5-10 repair
    rounds, then the planted active set; the same rounds and verdicts as
    scs_tpu, x, y and s to 1e-5."""
    A, P, b, c, d, zero_mask = _planted_batch(wrong=2)
    (xj, yj, sj, okj), rounds_j = _jax_polish_rows(A, P, b, c, d, zero_mask, monkeypatch)
    t = [torch.as_tensor(a) for a in (A, P, b, c, d)]
    xt, yt, st, okt, rounds_t = polish._polish(*t[:4], t[4], torch.as_tensor(zero_mask))
    assert xt.dtype == torch.float32 and tuple(xt.shape) == xj.shape
    assert rounds_t.tolist() == rounds_j.tolist()
    assert rounds_j.max() > 1  # the flipped rows made repair rounds run
    np.testing.assert_array_equal(okt.numpy(), okj)
    for i in range(A.shape[0]):
        for out_t, out_j in ((xt, xj), (yt, yj), (st, sj)):
            assert _rel(out_t[i].numpy(), out_j[i]) < 1e-5, i
    # the public form returns scs_tpu's four outputs
    pub = polish.polish_batch(*t[:4], t[4], zero_mask)
    assert len(pub) == 4 and torch.equal(pub[0], xt)


def test_polish_far_mask_and_no_P(monkeypatch):
    """Six rows wrong each way: the same repair rounds (the cap is 25) and
    verdicts as scs_tpu. Without P (an LP: Pt = 1e-6 I, too ill-posed to
    compare two summation orders), None and a (B, 0, 0) P are the same
    solve and stay within the cap."""
    A, P, b, c, d, zero_mask = _planted_batch(wrong=6)
    (_, _, _, okj), rounds_j = _jax_polish_rows(A, P, b, c, d, zero_mask, monkeypatch)
    t = [torch.as_tensor(a) for a in (A, P, b, c, d)]
    zm = torch.as_tensor(zero_mask)
    _, _, _, okt, rounds_t = polish._polish(*t, zm)
    assert rounds_t.tolist() == rounds_j.tolist()
    np.testing.assert_array_equal(okt.numpy(), okj)
    lp = polish._polish(t[0], None, *t[2:], zm)
    lp0 = polish._polish(t[0], torch.zeros((4, 0, 0)), *t[2:], zm)
    for a, b_ in zip(lp, lp0):
        assert torch.equal(a, b_)
    assert int(lp[4].max()) <= polish.MAX_ROUNDS


def test_kkt_errors_match():
    A, P, b, c, d, _ = _planted_batch()
    rng = np.random.RandomState(5)
    x = rng.randn(*c.shape).astype(np.float32)
    y, s = (rng.randn(*b.shape).astype(np.float32) for _ in range(2))
    wr, wc = (np.abs(rng.randn(*v.shape)).astype(np.float32) + 0.5 for v in (b, c))
    out_j = jpolish.kkt_errors(*(jnp.asarray(a) for a in (A, P, b, c, x, y, s)),
                               wr=jnp.asarray(wr), wc=jnp.asarray(wc))
    out_t = polish.kkt_errors(*(torch.as_tensor(a) for a in (A, P, b, c, x, y, s)),
                              wr=torch.as_tensor(wr), wc=torch.as_tensor(wc))
    for a, b_ in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-6)
    A_t, *vecs = (torch.as_tensor(a) for a in (A, b, c, x, y, s))
    plain = polish.kkt_errors(A_t, None, *vecs)
    ref = jpolish.kkt_errors(*(jnp.asarray(a) for a in (A, np.zeros((4, 0, 0), np.float32),
                                                        b, c, x, y, s)))
    for a, b_ in zip(plain, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-6)


def test_gen_batch_is_the_bench_generator():
    for kw in (dict(seed=1234), dict(seed=4321, return_opt=True)):
        ours, theirs = gen_batch(3, 30, 20, **kw), jax_gen_batch(3, 30, 20, **kw)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


# -- tests/test_polish.py through both packages ---------------------------------


def _batched(package, data, cone, **kw):
    if package == "scs_tpu":
        return scs_tpu.BatchedSCS(data, cone, **kw)
    return scs_tpu_torch.BatchedSCS(data, cone, **kw, **CPU)


def _solve_and_polish(package, B=8, m=150, n=100, seed=5):
    A, P, b, c, p_star = gen_batch(B, m, n, seed=seed, return_opt=True)
    s = _batched(package, {"A": A.astype(np.float32), "P": P.astype(np.float32), "b": b, "c": c},
                 {"l": m}, dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iters=20000,
                 verbose=False)
    res = s.solve()
    pre = [dict(x=r["x"].copy(), pobj=r["info"]["pobj"]) for r in res]
    res, mask = s.polish(res)
    return A, P, b, c, p_star, res, mask, pre


@pytest.mark.parametrize("package", PACKAGES)
def test_polish_reaches_high_accuracy(package):
    A, P, b, c, p_star, res, mask, _ = _solve_and_polish(package)
    assert mask.sum() >= len(res) // 2, f"only {mask.sum()} polished"
    for i, r in enumerate(res):
        if not mask[i]:
            continue
        x, y, s = r["x"], r["y"], r["s"]
        rp = np.linalg.norm(A[i] @ x + s - b[i])
        rd = np.linalg.norm(P[i] @ x + A[i].T @ y + c[i])
        assert rp < 1e-5 and rd < 1e-5, (i, rp, rd)
        assert abs(r["info"]["pobj"] - p_star[i]) < 1e-5
        assert (s > -5e-5).all() and (y > -5e-5).all()
        assert r["info"]["status"] == "solved"


@pytest.mark.parametrize("package", PACKAGES)
def test_polish_improves_objective_error(package):
    _, _, _, _, p_star, res, mask, pre = _solve_and_polish(package, seed=9)
    for i, r in enumerate(res):
        if not mask[i]:
            continue
        before = abs(pre[i]["pobj"] - p_star[i])
        after = abs(r["info"]["pobj"] - p_star[i])
        assert after <= max(before, 1e-6), (i, before, after)


@pytest.mark.parametrize("package", PACKAGES)
def test_polish_keeps_unqualified_results(package):
    """Non-(zero + nonneg) cones: polish is a no-op that returns the results
    untouched; so is an indirect core."""
    rng = np.random.RandomState(2)
    B, m, n = 2, 12, 6
    A = rng.randn(B, m, n)
    x0 = rng.randn(B, n)
    b = np.einsum("bmn,bn->bm", A, x0) + np.abs(rng.randn(B, m))
    c = -np.einsum("bmn,bm->bn", A, np.abs(rng.randn(B, m)))
    for cone, kw in (({"l": m - 3, "q": [3]}, {}), ({"l": m}, {"solver_strategy": "indirect"})):
        s = _batched(package, {"A": A, "b": b, "c": c}, cone, dtype="float32", max_iters=5000,
                     verbose=False, **kw)
        res = s.solve()
        xs = [r["x"].copy() for r in res]
        res, mask = s.polish(res)
        assert not mask.any()
        for r, x_old in zip(res, xs):
            assert np.array_equal(r["x"], x_old)


@pytest.mark.parametrize("package", PACKAGES)
def test_polish_lp_no_P_safe(package):
    """LP (no P): polish either verifies or falls back — never corrupts."""
    rng = np.random.RandomState(4)
    B, m, n = 4, 30, 20
    A = rng.randn(B, m, n)
    x0 = rng.randn(B, n)
    b = np.einsum("bmn,bn->bm", A, x0) + np.abs(rng.randn(B, m))
    c = -np.einsum("bmn,bm->bn", A, np.abs(rng.randn(B, m)))
    s = _batched(package, {"A": A, "b": b, "c": c}, {"l": m}, dtype="float32", max_iters=20000,
                 verbose=False)
    res, _ = s.polish(s.solve())
    for i, r in enumerate(res):
        rp = np.linalg.norm(A[i] @ r["x"] + r["s"] - b[i])
        assert rp < 1e-2 * (1 + np.linalg.norm(b[i])), (i, rp)


def test_polish_reads_the_full_batch_after_compaction():
    """Polish indexes problems by their position in the original batch: after
    a solve that compacted (B = 64 retires to 32), it reads the solver's
    full-B equilibrated data, and every polished problem still certifies."""
    A, P, b, c, p_star = gen_batch(64, 30, 20, seed=11, return_opt=True)
    s = scs_tpu_torch.BatchedSCS(
        {"A": A.astype(np.float32), "P": P.astype(np.float32), "b": b, "c": c}, {"l": 30},
        dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iters=20000, verbose=False, **CPU)
    res = s.solve()
    assert len(s.bucket_ladder) > 1 and s.mats.A.shape[0] == 64
    res, mask = s.polish(res)
    # a problem polished against another's data would miss by O(1); at this
    # size the bench's P leaves polished points at ~1e-4 (1e-5 at 150 x 100)
    assert mask.sum() >= 48
    for i in np.flatnonzero(mask):
        r = res[i]
        assert np.linalg.norm(A[i] @ r["x"] + r["s"] - b[i]) < 1e-3 * (1 + np.linalg.norm(b[i]))
        assert abs(r["info"]["pobj"] - p_star[i]) < 1e-3 * (1 + abs(p_star[i]))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_polish_on_card(cuda_device):
    """The eps 1e-4 batch polished on the card: the refinement and the
    verification through D1, every polished point at high accuracy."""
    from scs_tpu_torch.ops import df32

    A, P, b, c, p_star = gen_batch(8, 150, 100, seed=5, return_opt=True)
    s = scs_tpu_torch.BatchedSCS(
        {"A": A.astype(np.float32), "P": P.astype(np.float32), "b": b, "c": c}, {"l": 150},
        dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iters=20000, verbose=False,
        device="cuda")
    res = s.solve()
    before = (df32.mv.launches, df32.tv.launches)
    res, mask = s.polish(res)
    assert df32.mv.launches > before[0] and df32.tv.launches > before[1]
    assert mask.all()
    for i, r in enumerate(res):
        assert np.linalg.norm(A[i] @ r["x"] + r["s"] - b[i]) < 1e-5
        assert np.linalg.norm(P[i] @ r["x"] + A[i].T @ r["y"] + c[i]) < 1e-5
        assert abs(r["info"]["pobj"] - p_star[i]) < 1e-5
