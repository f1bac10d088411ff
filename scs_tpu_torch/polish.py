"""Active-set solution polishing — the port of scs_tpu/polish.py.

At eps <= 1e-6 the f32 DR iteration's last decade crawls along the f32
iterate-quantization floor. Polishing sidesteps the crawl: converge at
eps = 1e-4, read off the active set, and solve the equality-constrained KKT
system directly — one batched factorization and compensated refinement
passes (ops/df32.py) reach ~f32-ulp KKT residuals. The result is verified
(sign conditions here, residuals in BatchedSCS.polish) and the unpolished
solution is kept when verification fails.

    active d_i = 1 for zero-cone rows and nonneg rows with y_i > s_i
    minimize 0.5 x'Px + c'x  s.t.  (Ax - b)_i = 0 for active i

    KKT:  P x + A' D lam = -c,   D A x = D b      (D = diag(d))
    range-space solve with static regularization eps_reg:
      Pt = P + regP I,  W = Pt^-1 A',  G = A W
      M  = D G D + regM I + (1 - d) I           (inactive lam -> 0)
      lam = M^-1 (D A Pt^-1 (-c) - D b),  x = Pt^-1 (-c - A' D lam)
    then iterative refinement against the true (unregularized) KKT with
    compensated residuals, reusing the two Cholesky factors.

scs_tpu vmaps one problem's polish; here every step carries the batch axis.
Its active-set repair `lax.while_loop` becomes a host loop over a (B,) live
mask, one device read per round: round 0 runs for every row, and after it a
row goes on only while its own condition holds (fewer than 25 rounds and a
violation beyond the noise tolerance); a row whose condition fails is
frozen, which is what vmap of the while_loop computes. Cholesky factors
come from the library (`cholesky_ex`: a failed row turns NaN, as
jnp.linalg.cholesky's does, where `cholesky` would raise); G = A W is one
full-f32 `torch.bmm` (TF32 off), as scs_tpu leaves that product to XLA; every
matvec goes through ops/dense.py (G1/G2 on CUDA) and every refinement
residual through ops/df32.py (D1 on CUDA).

Supported cones: zero + nonneg. Other cones keep the unpolished solution
(BatchedSCS.polish decides).
"""

from __future__ import annotations

import math

import torch

from .ops import df32
from .ops.dense import gemv_cols, gemv_rows
from .solver import _no_tf32

MAX_ROUNDS = 25  # the repair loop's cap, rounds counted from 0


def _trace(M):
    return M.diagonal(dim1=-2, dim2=-1).sum(-1)


def _cholesky(M):
    """The lower Cholesky factor of every matrix of the batch; a matrix that
    is not positive definite in the working precision gives NaN."""
    L, info = torch.linalg.cholesky_ex(M)
    return L.masked_fill_((info != 0)[..., None, None], math.nan)


def _chol_solve(L, r):
    """L L' x = r for (B, k) right-hand sides."""
    return torch.cholesky_solve(r[..., None], L)[..., 0]


def _polish(A, P, b, c, d, zero_mask, eps_reg=1e-6, refine=3):
    """Batched polish. A (B, m, n), P (B, n, n) or None, b (B, m), c (B, n),
    d (B, m) active masks in A's dtype, zero_mask (m,) bool tensor. Returns
    (x, y, s, lam_ok, rounds), rounds (B,) int the repair rounds each row
    ran (round 0 included)."""
    B, m, n = A.shape
    dev, dtype = A.device, A.dtype
    zm = zero_mask.to(device=dev, dtype=torch.bool)
    has_P = P is not None and P.numel() > 0
    P0 = P if has_P else torch.zeros((B, n, n), dtype=dtype, device=dev)
    # scale-aware static regularization (relative to the operator
    # magnitudes, with an absolute floor): f32 Cholesky needs cond(Pt),
    # cond(M) well under ~1e7
    regP = eps_reg * (1.0 + _trace(P0) / n)
    Pt = P0.clone()
    Pt.diagonal(dim1=-2, dim2=-1).add_(regP[:, None])
    cholP = _cholesky(Pt)
    del Pt

    def p_solve(r):
        return _chol_solve(cholP, r)

    # W = Pt^-1 A' (n, m); G = A W (m, m): mask-independent, computed once
    # and reused by every repair round
    with _no_tf32():
        W = torch.cholesky_solve(A.mT, cholP)
        G = torch.bmm(A, W)
    del W
    regM = eps_reg * (1.0 + _trace(G) / m)

    def solve_with_mask(d):
        M = d[:, :, None] * G * d[:, None, :]
        M.diagonal(dim1=-2, dim2=-1).add_(regM[:, None] + (1.0 - d))
        cholM = _cholesky(M)
        del M

        def kkt_solve(r1, r2):
            """Regularized masked KKT solve for (dx, dlam) given residuals
            r1 (B, n) of the x-row and r2 (B, m) of the lam-row."""
            t = gemv_rows(A, p_solve(r1))
            lam = _chol_solve(cholM, d * t - r2)
            x = p_solve(r1 - gemv_cols(A, d * lam))
            return x, lam

        # the lam-row convention is r2 = D b (kkt_solve computes d*t - r2),
        # matching the refinement calls, which pass -r2 = d*(b - Ax)
        x, lam = kkt_solve(-c, d * b)
        # refinement against the true KKT (P, not Pt; the exact mask), with
        # compensated residuals so the correction targets ~1 ulp
        for _ in range(refine):
            Px = df32.mv(P, x) if has_P else torch.zeros_like(x)
            r1 = -c - Px - df32.tv(A, d * lam)
            r2 = d * (df32.mv(A, x) - b)
            dx, dlam = kkt_solve(r1, -r2)
            x, lam = x + dx, lam + dlam
        return x, lam, b - df32.mv(A, x)

    def viols(d, lam, s_raw):
        """Beyond-noise active-set violations per row: active nonneg rows
        with clearly negative multipliers (release) and inactive rows with
        clearly negative slacks (bind), at 1e-6 of the RMS magnitude."""
        tol_l = 1e-6 * (1.0 + torch.sqrt(torch.mean(lam * lam, -1, keepdim=True)))
        tol_s = 1e-6 * (1.0 + torch.sqrt(torch.mean(s_raw * s_raw, -1, keepdim=True)))
        rel = (d > 0.5) & ~zm & (lam < -tol_l)
        bind = (d < 0.5) & (s_raw < -tol_s)
        return rel, bind

    x = torch.zeros((B, n), dtype=dtype, device=dev)
    lam = torch.zeros((B, m), dtype=dtype, device=dev)
    s_raw = torch.zeros((B, m), dtype=dtype, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)  # round 0: every row
    while bool(live.any()):
        # flip on the raw sign (the loop's exit uses the noise tolerance):
        # the fine flips drive the iterate to the exact active set
        on = (k > 0)[:, None]
        rel = on & (d > 0.5) & ~zm & (lam < 0.0)
        bind = on & (d < 0.5) & (s_raw < 0.0)
        d_new = torch.where(zm, 1.0, torch.where(rel, 0.0, torch.where(bind, 1.0, d)))
        x_new, lam_new, s_new = solve_with_mask(d_new)
        rows = live[:, None]
        d = torch.where(rows, d_new, d)
        x = torch.where(rows, x_new, x)
        lam = torch.where(rows, lam_new, lam)
        s_raw = torch.where(rows, s_new, s_raw)
        k = k + live
        rel_t, bind_t = viols(d, lam, s_raw)
        live = (k < MAX_ROUNDS) & (rel_t.any(-1) | bind_t.any(-1))

    # no blanket clamp into the cone: zeroing every noise-level negative
    # multiplier adds a measurable ||A' dy|| to the dual residual
    y_pol = d * lam
    s_pol = torch.where(zm, 0.0, (1.0 - d) * s_raw)
    # sign conditions, tolerances relative to the iterate magnitudes:
    # multipliers of active nonneg rows >= 0, slacks of inactive rows >= 0
    tol_l = 1e-5 * (1.0 + lam.abs().amax(-1, keepdim=True))
    tol_s = 1e-5 * (1.0 + s_raw.abs().amax(-1, keepdim=True))
    lam_ok = torch.all(zm | (d < 0.5) | (lam >= -tol_l), -1) & torch.all(
        (d > 0.5) | (s_raw >= -tol_s), -1
    )
    return x, y_pol, s_pol, lam_ok, k


def polish_batch(A, P, b, c, d, zero_mask, *, eps_reg=1e-6, refine=3):
    """Batched polish: A (B, m, n), P (B, n, n) or None / (B, 0, 0), b (B, m),
    c (B, n), d (B, m) active masks, zero_mask (m,) bool (numpy or tensor).
    Returns (x, y, s, lam_ok) batched."""
    zm = torch.as_tensor(zero_mask, dtype=torch.bool)
    return _polish(A, P, b, c, d, zm, eps_reg=eps_reg, refine=int(refine))[:4]


def kkt_errors(A, P, b, c, x, y, s, wr=None, wc=None):
    """Compensated-f32 KKT residual norms per problem (B,): primal
    ||wr * (Ax + s - b)||, dual ||wc * (Px + A'y + c)||, |comp slack|.

    wr (B, m) / wc (B, n) are optional per-row weights; the inverse
    equilibration (1/(D sc_b), 1/(E sc_c)) gives the exact original-unit
    residual norms of normalized-space iterates."""
    rp = df32.mv(A, x) + s - b
    Px = df32.mv(P, x) if P is not None and P.numel() > 0 else torch.zeros_like(x)
    rd = Px + df32.tv(A, y) + c
    if wr is not None:
        rp = rp * wr
    if wc is not None:
        rd = rd * wc
    return (
        torch.linalg.vector_norm(rp, dim=-1),
        torch.linalg.vector_norm(rd, dim=-1),
        df32.dot(s, y).abs(),
    )
