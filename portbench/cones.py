"""Plain PyTorch cone geometry for the benchmark's generators and reference.

Batched projections onto the cones the benchmark's configurations use, in
SCS's row order: zero (z), nonnegative (l), second-order (q), PSD (s, the
lower triangle by columns, off-diagonal entries scaled by sqrt 2),
exponential (ep), dual exponential (ed) and power / dual power (p, a
negative a for the dual cone). Every function takes a (B, m) float tensor
and works on whatever device it lies on.

This is the benchmark's own copy of the geometry of the repository's test
oracle (the upstream scs-python `test/gen_random_cone_prob.py` recipe),
written out over a batch. It imports nothing of the solver under test. The
exponential-cone projection is the same point by another route: bisection
on Friberg's univariate function (Projection onto the exponential cone: a
univariate root-finding problem, Optim. Methods Softw. 2023), whose root
gives the projection and its Moreau complement on the two rays of the
boundary, in place of the oracle's nested scalar search, which does not
vectorise. The power-cone projection solves the oracle's equation for the
radius by bisection, in a form that does not cancel near the axes.
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)


def sd_size(n: int) -> int:
    return n * (n + 1) // 2


def cone_dims(K: dict) -> int:
    """Rows of the cone K (the kinds of this module)."""
    return int(
        K.get("z", 0)
        + K.get("l", 0)
        + sum(K.get("q", []))
        + sum(sd_size(n) for n in K.get("s", []))
        + 3 * K.get("ep", 0)
        + 3 * K.get("ed", 0)
        + 3 * len(K.get("p", []))
    )


def check_kinds(K: dict) -> None:
    extra = set(K) - {"z", "l", "q", "s", "ep", "ed", "p"}
    if extra:
        raise ValueError(f"cone kinds {sorted(extra)} have no plain projection here")


def proj_soc(v):
    """(B, q) rows onto the second-order cone {(t, x): ||x|| <= t}."""
    if v.shape[1] == 1:
        return v.clamp_min(0.0)
    t, x = v[:, 0], v[:, 1:]
    nx = torch.linalg.vector_norm(x, dim=1)
    coef = 0.5 * (1.0 + t / torch.where(nx > 0, nx, 1.0))
    edge = torch.cat([(coef * nx)[:, None], coef[:, None] * x], dim=1)
    out = torch.where((nx <= -t)[:, None], torch.zeros_like(v), edge)
    return torch.where((nx <= t)[:, None], v, out)


def _tri_index(n, device):
    """Row and column of each packed entry: lower triangle by columns."""
    rows = [i for j in range(n) for i in range(j, n)]
    cols = [j for j in range(n) for _ in range(j, n)]
    return (torch.tensor(rows, device=device), torch.tensor(cols, device=device))


def _off_diag(rows, cols, off, dtype):
    """Per packed entry: 1 on the diagonal, `off` off it, in `dtype`."""
    one = torch.ones(rows.shape, dtype=dtype, device=rows.device)
    return torch.where(rows == cols, one, one * off)


def unpack_sym(z, n):
    rows, cols = _tri_index(n, z.device)
    scale = _off_diag(rows, cols, 1.0 / SQRT2, z.dtype)
    M = torch.zeros((z.shape[0], n, n), dtype=z.dtype, device=z.device)
    M[:, rows, cols] = z * scale
    M[:, cols, rows] = z * scale
    return M


def pack_sym(M):
    n = M.shape[-1]
    rows, cols = _tri_index(n, M.device)
    scale = _off_diag(rows, cols, SQRT2, M.dtype)
    return M[:, rows, cols] * scale


def proj_psd(z, n):
    """(B, n(n+1)/2) packed rows onto the PSD cone of order n."""
    if n == 1:
        return z.clamp_min(0.0)
    w, V = torch.linalg.eigh(unpack_sym(z, n))
    return pack_sym((V * w.clamp_min(0.0)[:, None, :]) @ V.mT)


def _tol(v):
    """Membership slack of a row: points of a cone's boundary computed in
    floating point land on either side of it."""
    return 1e-13 * (1.0 + v.abs().amax(-1))


def in_exp(v):
    r, s, t = v.unbind(-1)
    tol = _tol(v)
    inside = (s > 0) & (t >= s * torch.exp(r / torch.where(s > 0, s, 1.0)) - tol)
    return inside | ((s.abs() <= tol) & (r <= tol) & (t >= -tol))


def in_exp_dual(v):
    """K_exp* = cl{(u, v, w): u < 0, -u exp(v / u) <= e w}."""
    u, vv, w = v.unbind(-1)
    tol = _tol(v)
    neg = u < 0
    inside = neg & (-u * torch.exp(vv / torch.where(neg, u, -1.0)) <= math.e * w + tol)
    return inside | ((u.abs() <= tol) & (vv >= -tol) & (w >= -tol))


def proj_exp(v, steps=200):
    """(N, 3) rows (r, s, t) onto K_exp = cl{s > 0, s exp(r / s) <= t}.

    Outside K, its polar and the quadrant r, s <= 0, the projection is
    p = alpha (rho, 1, e^rho) and p - v = beta (-1, rho - 1, e^-rho), on the
    boundary rays of K and K*, alpha, beta > 0. With alpha(rho) =
    ((rho - 1) r + s) / (rho^2 - rho + 1) and beta(rho) = (r - rho s) /
    (rho^2 - rho + 1), the third coordinate fixes rho as the root of
    g(rho) = alpha e^rho - beta e^-rho - t on the interval where both are
    positive; g is below 0 at the end where alpha vanishes and above 0 at
    the end where beta vanishes exactly when v lies outside K and its polar.
    Near either end one of the two numerators cancels: p is taken from the
    other one.

    An r or s below 1e-100 of the other is taken as 0 first: the ends of
    the interval, s / r and r / s, would otherwise overflow rho^2. The
    projection is 1-Lipschitz, so that moves p by no more than it moves v.
    """
    r0, s0, t0 = v.unbind(-1)
    r0, s0 = (torch.where(r0.abs() <= 1e-100 * s0.abs(), 0.0, r0),
              torch.where(s0.abs() <= 1e-100 * r0.abs(), 0.0, s0))

    def above(rho):
        """g(rho) > 0, from g e^-|rho| (rho^2 - rho + 1), which overflows
        nowhere."""
        e1, e2 = torch.exp(-rho.abs()), torch.exp(-2.0 * rho.abs())
        l1, l2 = (rho - 1.0) * r0 + s0, r0 - rho * s0
        q = rho * rho - rho + 1.0
        pos = l1 - l2 * e2 - q * t0 * e1
        neg = l1 * e2 - l2 - q * t0 * e1
        return torch.where(rho >= 0, pos, neg) > 0

    # the interval: alpha > 0 above 1 - s / r where r > 0, beta > 0 below
    # r / s where s > 0; an open end is pushed out until g changes sign
    lo_end, hi_end = r0 > 0, s0 > 0
    lo = torch.where(lo_end, 1.0 - s0 / torch.where(lo_end, r0, 1.0), torch.zeros_like(r0))
    hi = torch.where(hi_end, r0 / torch.where(hi_end, s0, 1.0), torch.zeros_like(r0))
    lo = torch.where(lo_end, lo, -2.0 * (hi.abs() + 1.0))
    hi = torch.where(hi_end, hi, 2.0 * (lo.abs() + 1.0))
    for _ in range(64):
        lo = torch.where(~lo_end & above(lo), 2.0 * lo, lo)
        hi = torch.where(~hi_end & ~above(hi), 2.0 * hi, hi)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        up = above(mid)
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid)
    rho = 0.5 * (lo + hi)
    q = rho * rho - rho + 1.0
    l1, l2 = (rho - 1.0) * r0 + s0, r0 - rho * s0
    one = torch.ones_like(rho)
    p1 = (l1 / q)[:, None] * torch.stack([rho, one, torch.exp(rho.clamp_max(700.0))], dim=-1)
    p2 = v + (l2 / q)[:, None] * torch.stack([-one, rho - 1.0, torch.exp((-rho).clamp_max(700.0))], dim=-1)
    p = torch.where((l1.abs() / ((rho - 1.0).abs() * r0.abs() + s0.abs())
                     >= l2.abs() / (r0.abs() + (rho * s0).abs()))[:, None], p1, p2)
    quad = torch.stack([r0, torch.zeros_like(r0), t0.clamp_min(0.0)], dim=-1)
    p = torch.where(((r0 <= 0) & (s0 <= 0))[:, None], quad, p)
    p = torch.where(in_exp_dual(-v)[:, None], torch.zeros_like(v), p)
    return torch.where(in_exp(v)[:, None], v, p)


def in_pow(v, a):
    x, y, z = v.unbind(-1)
    tol = _tol(v)
    return (x >= -tol) & (y >= -tol) & (
        x.clamp_min(0) ** a * y.clamp_min(0) ** (1 - a) >= z.abs() - tol
    )


def in_pow_dual(v, a):
    u, w, z = v.unbind(-1)
    tol = _tol(v)
    return (u >= -tol) & (w >= -tol) & (
        (u.clamp_min(0) / a) ** a * (w.clamp_min(0) / (1 - a)) ** (1 - a) >= z.abs() - tol
    )


def proj_pow(v, a, steps=128):
    """(N, 3) rows onto the power cones {x^a y^(1-a) >= |z|, x, y >= 0}, a
    (N,) in (0, 1).

    Outside the cone and its polar, the projection is (x(r), y(r), sign(z)
    r), where x(r) = (x0 + sqrt(x0^2 + 4 a r (|z0| - r))) / 2, y(r) alike
    with 1 - a, and r in (0, |z0|) is the one root of x^a y^(1-a) = r
    (Hien, Differential properties of Euclidean projection onto power
    cone, 2015): above 0 below it, below 0 above it. The root is found by
    bisection on the sign in logarithms, and x(r) is taken where x0 < 0
    as 2 a r (|z0| - r) / (sqrt(...) - x0), which does not cancel. (The
    oracle's Newton iteration on the same root, its iterate clipped to
    [0, |z0|] and x, y held above 1e-12, lands up to ~1e-3 off it for
    points on the boundary with one coordinate near 0.)"""
    xh, yh, zh = v.unbind(-1)
    rh = zh.abs()

    def cx(r, h, aa):
        d = 4.0 * aa * (rh - r) * r
        root = torch.sqrt(h * h + d)
        return torch.where(h >= 0, 0.5 * (h + root), 0.5 * d / torch.where(h < 0, root - h, 1.0))

    lo, hi = torch.zeros_like(rh), rh
    for _ in range(steps):
        r = 0.5 * (lo + hi)
        up = a * torch.log(cx(r, xh, a)) + (1 - a) * torch.log(cx(r, yh, 1 - a)) > torch.log(r)
        lo, hi = torch.where(up, r, lo), torch.where(up, hi, r)
    r = 0.5 * (lo + hi)
    p = torch.stack([cx(r, xh, a), cx(r, yh, 1 - a), torch.sign(zh) * r], dim=-1)
    p = torch.where(in_pow_dual(-v, a)[:, None], torch.zeros_like(v), p)
    return torch.where(in_pow(v, a)[:, None], v, p)


def proj_cone(w, K):
    """Project each row of the (B, m) slack w onto the cone K."""
    check_kinds(K)
    B = w.shape[0]
    out = torch.empty_like(w)
    i = K.get("z", 0)
    out[:, :i] = 0.0
    n_l = K.get("l", 0)
    out[:, i : i + n_l] = w[:, i : i + n_l].clamp_min(0.0)
    i += n_l
    for q in K.get("q", []):
        if q:
            out[:, i : i + q] = proj_soc(w[:, i : i + q])
        i += q
    for n in K.get("s", []):
        k = sd_size(n)
        if k:
            out[:, i : i + k] = proj_psd(w[:, i : i + k], n)
        i += k
    ep = K.get("ep", 0)
    if ep:
        v = w[:, i : i + 3 * ep].reshape(-1, 3)
        out[:, i : i + 3 * ep] = proj_exp(v).reshape(B, -1)
        i += 3 * ep
    ed = K.get("ed", 0)
    if ed:  # Moreau: the projection onto K_exp* is v + proj_exp(-v)
        v = w[:, i : i + 3 * ed].reshape(-1, 3)
        out[:, i : i + 3 * ed] = (v + proj_exp(-v)).reshape(B, -1)
        i += 3 * ed
    ps = K.get("p", [])
    if ps:
        a = torch.tensor(ps, dtype=w.dtype, device=w.device).repeat(B)
        v = w[:, i : i + 3 * len(ps)].reshape(-1, 3)
        dual = (a < 0)[:, None]
        p = proj_pow(torch.where(dual, -v, v), a.abs())
        out[:, i : i + 3 * len(ps)] = torch.where(dual, v + p, p).reshape(B, -1)
        i += 3 * len(ps)
    if i != w.shape[1]:
        raise ValueError(f"cone K has {i} rows, the slack {w.shape[1]}")
    return out


def proj_dual_cone(w, K):
    """Moreau: the projection onto K* is w + proj_K(-w)."""
    return w + proj_cone(-w, K)
