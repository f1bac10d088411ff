"""Cone projections, on tensors — the port of scs_tpu/ops/projections.py.

Every cone kind of ConeSpec has its projection here: zero, nonnegative, box,
second-order, real and complex PSD, exponential and its dual, power and its
dual, and the spectral cones (ell1, nuclear, sum-of-largest, logdet). The
projector factory keeps scs_tpu's signature, proj(z, bl=None, bu=None), and
its Moreau dual, Pi_K*(z) = z + Pi_K(-z).

The projectors act on the last axis: a (m,) slack vector, or a (B, m) batch
of them (the batched path), projected row by row. All ragged layout work
happens when the projector is built: segments are bucketed by cone kind and
size, a bucket of `count` cones is projected as one (B*count, size) batch,
and index tensors are built once per device.

Five projections are scalar iterations per cone (nested Newton and
bisection loops with fixed counts) that XLA fused into one program in
scs_tpu. In eager PyTorch each line of each loop pass would be a kernel
launch (tens of thousands per call), so on a CUDA tensor they run as the
hand-written kernels of csrc/cone_proj.cu and csrc/spectral_proj.cu, one
launch per call with every loop in registers:

  * _proj_exp_batch(v, sign=None)    — rows of (k, 3) onto the exponential
                                       cone, or (sign < 0) its dual cone
  * _proj_pow_batch(v, a, sign=None) — rows onto the power cones K_a[row]
  * _proj_box(v, bl, bu)             — (t, s) onto the box cone, per problem
  * _proj_logdet_vec_batch(t0, v0, w0)  — the logdet cone's vector part,
                                          after eigh
  * _proj_sl_vec_batch(t0, w0, k)    — the sum-of-k-largest cone's vector
                                       part, after eigh

Each counts its launches in `.launches`; a failed build or launch raises,
and nothing falls back. On a CPU tensor they are the plain versions beside
them (_proj_exp_batch_ref, _proj_pow_batch_ref, _proj_box_ref,
_proj_logdet_vec_batch_ref, _proj_sl_vec_batch_ref), which keep scs_tpu's
operations in scs_tpu's order (one deliberate difference: the power cone's
Newton step halves towards a bound instead of clipping onto it, without
which f32 stalls on ~2% of ordinary rows). The other projections, and the
eigh and rebuild around the spectral ones, are plain tensor code around one
library call (eigh, svd, sort), as in scs_tpu.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from .. import trace
from ..cones import ConeSpec
from .dense import _launch

# fixed iteration counts of the scalar iterations (scs_tpu's)
EXP_NEWTON_ITERS = 40
LOGDET_V_BISECTIONS = 60  # the logdet cone's root in v, as scs_tpu's
EXP_DOUBLINGS = 30
EXP_BISECTIONS = 64
POW_NEWTON_ITERS = 40
BOX_NEWTON_ITERS = 100

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _tiny(x):
    """Smallest normal positive value of x's dtype. Guards for log/division
    must be dtype-aware: a literal 1e-300 silently underflows to 0.0 in
    float32, turning the guard into log(0) = -inf -> NaN."""
    return torch.finfo(x.dtype).tiny


def _explim(x):
    """Largest safe argument to exp() in x's dtype (~709 f64, ~87 f32)."""
    return 0.99 * float(np.log(np.finfo(_NP_DTYPE[x.dtype]).max))


def _where_rows(mask, a, b):
    return torch.where(mask[:, None], a, b)


# ---------------------------------------------------------------------------
# Elementwise cones
# ---------------------------------------------------------------------------


def _proj_nonneg(x):
    return torch.clamp_min(x, 0.0)


# ---------------------------------------------------------------------------
# The kernels of csrc/cone_proj.cu
# ---------------------------------------------------------------------------


_CONE_FNS = {}  # (name, dtype) -> the C entry point


def _cone_symbol(name, dtype, source="cone_proj"):
    """The C entry point of csrc/<source>.cu for `name` and `dtype`, built,
    loaded and looked up once."""
    fn = _CONE_FNS.get((name, dtype))
    if fn is None:
        from . import _kernels  # noqa: PLC0415

        lib = _kernels.load(source)
        fn = _CONE_FNS[(name, dtype)] = getattr(
            lib, name + ("_f32" if dtype == torch.float32 else "_f64"))
    return fn


def _check_rows(who, v, width=3):
    """v: float32 or float64 rows (k, width); width None: any width >= 1."""
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: rows must be float32 or float64, got {v.dtype}")
    if v.dim() != 2 or (v.shape[1] != width if width else v.shape[1] < 1):
        shape = f"(k, {width})" if width else "(k, n), n >= 1"
        raise ValueError(f"{who}: rows must have shape {shape}, got {tuple(v.shape)}")


def _check_like(who, name, t, v, shape):
    if t.dtype != v.dtype or t.device != v.device or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{who}: {name} must be {v.dtype} on {v.device} of shape {tuple(shape)}, "
            f"got {t.dtype} on {t.device} of shape {tuple(t.shape)}"
        )


def _check_counts(who, counts, n, device):
    """The optional output of a kernel's pass counts: int32, n of them."""
    if counts is not None and (
        counts.dtype != torch.int32 or counts.device != device or counts.numel() != n
        or not counts.is_contiguous()
    ):
        raise ValueError(f"{who}: the counts' output must be a contiguous int32 ({n},) on {device}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _signed(fn, v, sign):
    """Rows with sign < 0 are projected onto the dual cone by Moreau,
    v + Pi(-v); the others onto the cone itself."""
    if sign is None:
        return fn(v)
    res = fn(v * sign[:, None])
    return torch.where((sign < 0)[:, None], v + res, res)


# ---------------------------------------------------------------------------
# Box cone:  K = {(t, s) : t >= 0, bl*t <= s <= bu*t}
# (reference: cones.c box projection, "Newton on t"; homogeneous (t,s) block)
# ---------------------------------------------------------------------------


def _proj_box_ref(v, bl, bu, n_iters=BOX_NEWTON_ITERS):
    """Project (t, s) = (v[..., 0], v[..., 1:]) onto the box cone.

    Minimizes (t - t0)^2 + ||clip(s0, bl*t, bu*t) - s0||^2 over t >= 0 by
    Newton on the (piecewise-linear, monotone) stationarity condition; for
    fixed t the slack part is the elementwise clip. v is (bsize,) or
    (B, bsize); bl and bu are (bsize-1,), shared, or (B, bsize-1).
    """
    t0 = v[..., :1]
    s0 = v[..., 1:]
    fin_l = torch.isfinite(bl)
    fin_u = torch.isfinite(bu)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    bl_f = torch.where(fin_l, bl, zero)
    bu_f = torch.where(fin_u, bu, zero)

    t = torch.clamp_min(t0, 0.0)
    for _ in range(n_iters):
        up_active = fin_u & (s0 > bu_f * t)
        lo_active = fin_l & (s0 < bl_f * t)
        g = (
            (t - t0)
            + torch.where(up_active, bu_f * (bu_f * t - s0), zero).sum(-1, keepdim=True)
            + torch.where(lo_active, bl_f * (bl_f * t - s0), zero).sum(-1, keepdim=True)
        )
        h = (
            1.0
            + torch.where(up_active, bu_f * bu_f, zero).sum(-1, keepdim=True)
            + torch.where(lo_active, bl_f * bl_f, zero).sum(-1, keepdim=True)
        )
        t_new = torch.clamp_min(t - g / h, 0.0)
        if torch.equal(t_new, t):  # a fixed point: every later step repeats it
            break
        t = t_new
    lo = torch.where(fin_l, bl_f * t, -math.inf)
    hi = torch.where(fin_u, bu_f * t, math.inf)
    s = torch.minimum(torch.maximum(s0, lo), hi)
    return torch.cat([t, s], dim=-1)


def _proj_box(v, bl, bu, iters_out=None, cycles_out=None):
    """Box-cone projection; shapes as _proj_box_ref. On CUDA: the proj_box
    kernel, one warp per problem of up to 512 bounds, else one thread block.
    `iters_out` and `cycles_out`, int32 (B,) tensors, receive the Newton
    steps each problem ran and 1 where it left on a cycle."""
    dev = v.device
    if dev.type == "cpu":
        return _proj_box_ref(v, bl, bu)
    if dev.type != "cuda":
        raise ValueError(f"_proj_box: unsupported device {dev}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"_proj_box: v must be float32 or float64, got {v.dtype}")
    if v.dim() not in (1, 2) or v.shape[-1] < 2:
        raise ValueError(f"_proj_box: v must be (bsize,) or (B, bsize), got {tuple(v.shape)}")
    v2 = (v[None] if v.dim() == 1 else v).contiguous()
    B, bsize = v2.shape
    nb = bsize - 1
    per_row = bl.dim() == 2
    _check_like("_proj_box", "bl", bl, v2, (B, nb) if per_row else (nb,))
    _check_like("_proj_box", "bu", bu, v2, bl.shape)
    bl, bu = bl.contiguous(), bu.contiguous()
    _check_counts("_proj_box", iters_out, B, dev)
    _check_counts("_proj_box", cycles_out, B, dev)
    out = torch.empty_like(v2)
    _launch("proj_box", dev, _cone_symbol("proj_box", v2.dtype),
            v2.data_ptr(), bl.data_ptr(), bu.data_ptr(), out.data_ptr(),
            _ptr(iters_out), _ptr(cycles_out), B, nb, nb if per_row else 0)
    _proj_box.launches += 1
    return out[0] if v.dim() == 1 else out


_proj_box.launches = 0  # kernel launches since the last reset


# ---------------------------------------------------------------------------
# Second-order cone (batched over equal-size cones)
# ---------------------------------------------------------------------------


def _proj_soc_batch(z):
    """z: (k, q). Project each row onto the SOC {(t, x): ||x|| <= t}."""
    t = z[:, 0]
    x = z[:, 1:]
    nx = torch.linalg.vector_norm(x, dim=1)
    # three regimes: inside (nx <= t) -> identity; polar (nx <= -t) -> 0;
    # else boundary scaling.
    coef = torch.clamp_min(0.5 * (1.0 + t / torch.clamp_min(nx, _tiny(z))), 0.0)
    inside = nx <= t
    new_t = torch.where(inside, t, coef * nx)
    scale_x = torch.where(inside, 1.0, coef)
    out = torch.cat([new_t[:, None], scale_x[:, None] * x], dim=1)
    return _where_rows(nx <= -t, torch.zeros((), dtype=z.dtype, device=z.device), out)


# ---------------------------------------------------------------------------
# Real PSD cone, packed triangle with sqrt(2) off-diagonal scaling. The
# packed <-> full maps are one gather and one scaling each, by index
# tensors built once per (n, device, dtype).
# ---------------------------------------------------------------------------


def _psd_unpack_indices(n):
    """Row/col indices of the packed lower-triangle-by-columns layout."""
    iu = np.triu_indices(n)
    rows, cols = iu[1], iu[0]
    return rows, cols


@functools.lru_cache(maxsize=256)
def _sym_layout(n, device, dtype):
    """Index tensors of the packed triangle of an n x n symmetric matrix:
    `full` (n*n,) the packed position of each entry of the full matrix,
    `is_diag` over the full matrix, `pick` (n(n+1)/2,) the flat position in
    the full matrix of each packed entry, `pick_diag` over the packed."""
    rows, cols = _psd_unpack_indices(n)
    pos = np.zeros((n, n), np.int64)
    pos[rows, cols] = np.arange(len(rows))
    pos[cols, rows] = np.arange(len(rows))
    t = functools.partial(torch.as_tensor, device=device)
    return {
        "full": t(pos.reshape(-1)),
        "is_diag": t(np.eye(n, dtype=bool).reshape(-1)),
        "pick": t(rows * n + cols),
        "pick_diag": t(rows == cols),
        "dtype": dtype,
    }


def _scales(lay, key, mask_key, on_diag, off_diag):
    """A cached scaling vector: `on_diag` where lay[mask_key], else
    `off_diag`."""
    if key not in lay:
        mask = lay[mask_key]
        lay[key] = torch.where(
            mask,
            torch.tensor(on_diag, dtype=lay["dtype"], device=mask.device),
            torch.tensor(off_diag, dtype=lay["dtype"], device=mask.device),
        )
    return lay[key]


def _sym_unpack_true(z, n):
    """Packed vector -> the true symmetric matrix X (isometric layout:
    diag entries stored as-is, off-diag stored as sqrt(2)*X_ij).
    z: (k, n(n+1)/2) -> (k, n, n)."""
    lay = _sym_layout(n, z.device, z.dtype)
    sqrt2 = float(np.sqrt(2.0))
    # scs_tpu: scatter, add the transpose (diag doubled), / sqrt2, diag *
    # sqrt2/2 — the doubling folded into the last factor, which is exact
    a = z[:, lay["full"]] / sqrt2
    a = a * _scales(lay, "unpack_true", "is_diag", 2.0 * (sqrt2 / 2.0), 1.0)
    return a.reshape(z.shape[0], n, n)


def _sym_pack_true(X):
    """(k, n, n) symmetric -> packed (k, n(n+1)/2) with the isometric
    sqrt(2) off-diagonal scaling."""
    n = X.shape[-1]
    lay = _sym_layout(n, X.device, X.dtype)
    scale = _scales(lay, "pack_true", "pick_diag", 1.0, float(np.sqrt(2.0)))
    return X.reshape(X.shape[0], n * n)[:, lay["pick"]] * scale


def _eig_rebuild(v, w):
    """sum_j w_j v_j v_j^H over a batch: (k, n, n), (k, n) -> (k, n, n)."""
    return (v * w[:, None, :].to(v.dtype)) @ v.mH


def _proj_psd_batch(z, n):
    """z: (k, n(n+1)/2). Batched PSD projection via eigh."""
    lay = _sym_layout(n, z.device, z.dtype)
    inv_sqrt2 = 1.0 / float(np.sqrt(2.0))
    # scs_tpu: scatter, add the transpose (diag doubled), diag * 1/sqrt2
    a = z[:, lay["full"]] * _scales(lay, "psd_in", "is_diag", 2.0 * inv_sqrt2, 1.0)
    w, v = torch.linalg.eigh(a.reshape(z.shape[0], n, n))
    a = _eig_rebuild(v, torch.clamp_min(w, 0.0))
    scale = _scales(lay, "psd_out", "pick_diag", inv_sqrt2, 1.0)
    return a.reshape(z.shape[0], n * n)[:, lay["pick"]] * scale


# ---------------------------------------------------------------------------
# Complex PSD cone ('cs'): n^2 reals per cone. Layout: lower triangle by
# columns; diagonal entries real; off-diagonal entries (re, im) pairs scaled
# by sqrt(2).
# ---------------------------------------------------------------------------


def _csd_layout(n):
    """Positions in the packed vector for a column-major lower triangle."""
    diag_pos = []
    off_pos = []  # (pos_re, pos_im, row, col)
    pos = 0
    for j in range(n):
        diag_pos.append((pos, j))
        pos += 1
        for i in range(j + 1, n):
            off_pos.append((pos, pos + 1, i, j))
            pos += 2
    assert pos == n * n
    return diag_pos, off_pos


@functools.lru_cache(maxsize=256)
def _csd_index(n, device, dtype):
    """Gather maps of the complex PSD layout: for each entry of the full
    Hermitian matrix the packed positions of its real and imaginary part
    with their factors, and for each packed entry its position in the
    (n, n, 2) real view of the matrix with its factor."""
    diag_pos, off_pos = _csd_layout(n)
    sqrt2 = np.sqrt(2.0)
    re_idx = np.zeros((n, n), np.int64)
    im_idx = np.zeros((n, n), np.int64)
    re_div = np.ones((n, n))
    im_mul = np.zeros((n, n))
    out_idx = np.zeros(n * n, np.int64)
    out_mul = np.ones(n * n)
    for p, j in diag_pos:
        re_idx[j, j] = p
        out_idx[p] = (j * n + j) * 2
    for pr, pi, i, j in off_pos:
        re_idx[i, j] = re_idx[j, i] = pr
        im_idx[i, j] = im_idx[j, i] = pi
        re_div[i, j] = re_div[j, i] = sqrt2
        im_mul[i, j], im_mul[j, i] = 1.0, -1.0
        out_idx[pr] = (i * n + j) * 2
        out_idx[pi] = (i * n + j) * 2 + 1
        out_mul[pr] = out_mul[pi] = sqrt2
    t = functools.partial(torch.as_tensor, device=device)
    return (
        t(re_idx.reshape(-1)), t(im_idx.reshape(-1)),
        t(re_div.reshape(-1), dtype=dtype), t(im_mul.reshape(-1), dtype=dtype),
        t(out_idx), t(out_mul, dtype=dtype),
    )


def _proj_csd_batch(z, n):
    """z: (k, n*n). Batched complex (Hermitian) PSD projection."""
    k = z.shape[0]
    re_idx, im_idx, re_div, im_mul, out_idx, out_mul = _csd_index(n, z.device, z.dtype)
    H = torch.complex(
        z[:, re_idx] / re_div, z[:, im_idx] * im_mul / float(np.sqrt(2.0))
    ).reshape(k, n, n)
    w, v = torch.linalg.eigh(H)
    Hp = _eig_rebuild(v, torch.clamp_min(w, 0.0))
    return torch.view_as_real(Hp).reshape(k, 2 * n * n)[:, out_idx] * out_mul


# ---------------------------------------------------------------------------
# Exponential cone (batched): bisection on rho with an inner Newton, fixed
# iteration counts.  Kexp = cl{(r, s, t): s > 0, t >= s*exp(r/s)}
# ---------------------------------------------------------------------------


def _exp_newton_onz(rho, y_hat, z_hat, w, n_iters=EXP_NEWTON_ITERS):
    """Inner 1-D Newton (oracle newton_exp_onz), vectorized over cones.

    f32-robust formulation: f and fp are multiplied through by rho^2 (the
    Newton step f/fp is invariant), so no term needs 1/rho^2 — which
    overflows f32 once the outer bisection drives rho below ~1e-19 — and
    log(t) - log(rho) replaces log(t/rho), whose quotient can overflow
    first. An overshoot past the t > 0 domain boundary HALVES t (oracle
    inner_z semantics)."""
    t = torch.clamp_min(torch.maximum(w - z_hat, -z_hat), 1e-6)
    r2 = rho * rho
    log_rho = torch.log(rho)
    ry = rho * y_hat
    for _ in range(n_iters):
        f = t * (t + z_hat) - ry + r2 * (torch.log(t) - log_rho + 1.0)
        fp = 2.0 * t + z_hat + r2 / t
        t_new = t - f / fp
        t_new = torch.where(t_new > 0, t_new, 0.5 * t)
        if torch.equal(t_new, t):  # a fixed point: every later step repeats it
            break
        t = t_new
    return t


def _exp_solve_with_rho(v, rho, w):
    zb = _exp_newton_onz(rho, v[:, 1], v[:, 2], w)
    x2 = zb + v[:, 2]
    x1 = (1.0 / rho) * zb * x2
    x0 = v[:, 0] - rho
    return torch.stack([x0, x1, x2], dim=1)


def _exp_calc_grad(v, rho, warm):
    x = _exp_solve_with_rho(v, rho, warm)
    tiny = _tiny(x)
    safe = torch.clamp_min(x[:, 1], tiny)
    g = torch.where(
        x[:, 1] <= 1e-12,
        x[:, 0],
        x[:, 0] + x[:, 1] * torch.log(safe / torch.clamp_min(x[:, 2], tiny)),
    )
    return g, x


def _proj_exp_batch_ref(v, n_doubling=EXP_DOUBLINGS, n_bisect=EXP_BISECTIONS):
    """v: (k, 3). Batched projection onto the exponential cone — the plain
    version, scs_tpu's operations in scs_tpu's order. A loop ends early only
    where every later pass would change nothing."""
    r, s, t = v[:, 0], v[:, 1], v[:, 2]
    zero = torch.zeros((), dtype=v.dtype, device=v.device)

    # Case 1: already in Kexp
    tiny = _tiny(v)
    in_cone = (
        (s > 0) & (t > 0)
        & (r <= s * torch.log(torch.clamp_min(t, tiny) / torch.clamp_min(s, tiny)))
    ) | ((r <= 0) & (s == 0) & (t >= 0))
    # Case 2: -v in Kexp^* -> projection is 0
    lim = _explim(v)
    exp_r = torch.exp(torch.clamp(s / torch.where(r != 0, r, 1.0), -lim, lim))
    in_polar = ((-r < 0) & (r * exp_r <= -math.e * t)) | ((r == 0) & (-s >= 0) & (-t >= 0))
    # Case 3: analytical (r < 0, s < 0)
    analytic = (r < 0) & (s < 0)

    # Case 4: bisection on rho; upper bound by doubling (oracle get_rho_ub)
    lb = torch.zeros_like(r)
    rho = torch.full_like(r, 2.0**-3)
    x = v
    for _ in range(n_doubling):
        g, x_new = _exp_calc_grad(v, rho, x[:, 1])
        grow = g > 0
        if not bool(grow.any()):  # no row moves: every later pass repeats this one
            break
        lb = torch.where(grow, rho, lb)
        rho = torch.where(grow, rho * 2.0, rho)
        x = _where_rows(grow, x_new, x)
    ub = rho

    # stop refining once the bracket shrinks below dtype resolution: past
    # that point the inner Newton's root t differs from -z_hat by less than
    # one ulp, so x2 - v2 cancels to 0 and the recovered x is garbage
    eps_dt = torch.finfo(v.dtype).eps
    bis_tol = 8.0 * eps_dt
    for _ in range(n_bisect):
        live = (ub - lb) > bis_tol * torch.clamp_min(ub, 1.0)
        if not bool(live.any()):  # every bracket is frozen for good
            break
        rho = 0.5 * (lb + ub)
        g, x_new = _exp_calc_grad(v, rho, x[:, 1])
        lb = torch.where(live & (g > 0), rho, lb)
        ub = torch.where(live & (g <= 0), rho, ub)
        x = _where_rows(live, x_new, x)
    lb_f, ub_f = lb, ub

    # Final polish at the converged rho: recover (x1, x2) from the
    # stationarity equation  zb*x2/rho^2 - y_hat/rho + log(zb/rho) + 1 = 0
    # instead of the direct x2 = zb + z_hat, which loses all precision to
    # cancellation when the root sits at zb ~= -z_hat (optimal rho near 0).
    rho_f = 0.5 * (lb_f + ub_f)
    zb_f = _exp_newton_onz(rho_f, s, t, x[:, 1])
    x1s = s - rho_f * (torch.log(zb_f) - torch.log(rho_f) + 1.0)
    x2s = rho_f * x1s / zb_f
    stable = torch.stack([r - rho_f, x1s, x2s], dim=1)
    # trust the recovery ONLY where the direct sum visibly cancelled:
    # everywhere else the loop iterate is at least as accurate, and the
    # recovery has its own complementary cancellation
    x2d = zb_f + t
    cancel = torch.abs(x2d) < 64.0 * eps_dt * torch.abs(t)
    use = (
        torch.isfinite(x1s) & torch.isfinite(x2s) & (x1s >= 0) & (x2s >= 0)
        & (rho_f > 0) & cancel
    )
    out = _where_rows(use, stable, x)

    # Degenerate rho -> 0 rows: g < 0 for every rho, so the bisection
    # collapses onto lb = 0, where x is garbage. The true limit is the
    # boundary point at s = s0:  p = (r0, s0, s0*exp(r0/s0)).
    collapsed = (lb_f == 0) & (ub_f <= 2.0 * bis_tol)
    s_pos = torch.clamp_min(s, 0.0)
    t_lim = s_pos * torch.exp(torch.clamp(r / torch.clamp_min(s_pos, tiny), -lim, lim))
    out = _where_rows(
        collapsed, torch.stack([r, s_pos, torch.clamp_min(t_lim, 0.0)], dim=1), out
    )
    out = _where_rows(
        analytic, torch.stack([r, torch.zeros_like(s), torch.clamp_min(t, 0.0)], dim=1), out
    )
    out = _where_rows(in_polar, zero, out)
    out = _where_rows(in_cone, v, out)
    return out


# Lanes per cone of the proj_exp kernel (csrc/cone_proj.cu): more lanes
# shorten a cone's chain of solves, but the bisection tree's nodes that are
# evaluated and not taken multiply the work. exp_group takes the largest G
# of EXP_GROUPS with k * G <= EXP_FILL_THREADS, which on the rows the solver
# hands the kernel (tools/cone_proto.py --groups) is the fastest G at each
# of the wide batch's and the mixed_cone cell's counts: 32 lanes at
# 640-1280 cones, 8 at 9,600, 4 at 19,200, one at 38,400.
EXP_GROUPS = (32, 16, 8, 4, 1)
EXP_FILL_THREADS = 80 * 1024


def exp_group(k):
    """The lanes per cone proj_exp takes for k cones."""
    return next(g for g in EXP_GROUPS if g == 1 or k * g <= EXP_FILL_THREADS)


def _proj_exp_batch(v, sign=None, evals_out=None, steps_out=None, cycles_out=None):
    """Rows of v (k, 3) onto the exponential cone; rows with sign[row] < 0
    onto its dual by Moreau (sign: (k,) of +-1, or None for all +1). On
    CUDA: the proj_exp kernel, exp_group(k) lanes per cone. `evals_out`,
    `steps_out` and `cycles_out`, int32 (k,) tensors, receive per row the
    inner Newton solves on the serial loop's path (the plain version's
    count), their Newton steps, and the solves that left on a cycle."""
    dev = v.device
    if dev.type == "cpu":
        return _signed(_proj_exp_batch_ref, v, sign)
    if dev.type != "cuda":
        raise ValueError(f"_proj_exp_batch: unsupported device {dev}")
    _check_rows("_proj_exp_batch", v)
    v = v.contiguous()
    k = v.shape[0]
    if sign is not None:
        _check_like("_proj_exp_batch", "sign", sign, v, (k,))
        sign = sign.contiguous()
    for counts in (evals_out, steps_out, cycles_out):
        _check_counts("_proj_exp_batch", counts, k, dev)
    out = torch.empty_like(v)
    _launch("proj_exp", dev, _cone_symbol("proj_exp", v.dtype),
            v.data_ptr(), _ptr(sign), out.data_ptr(), _ptr(evals_out), _ptr(steps_out),
            _ptr(cycles_out), k, exp_group(k), _explim(v))
    _proj_exp_batch.launches += 1
    return out


_proj_exp_batch.launches = 0  # kernel launches since the last reset


# ---------------------------------------------------------------------------
# Power cone (batched): damped Newton, mirrors oracle proj_pow.
# K_a = {(x,y,z): x,y>=0, x^a y^(1-a)>=|z|}
# ---------------------------------------------------------------------------


def _pow_calc_x(r, xh, aa, rh):
    """x (or y) on the power cone's boundary curve at |z| = r."""
    return torch.clamp_min(0.5 * (xh + torch.sqrt(xh * xh + 4.0 * aa * (rh - r) * r)), 1e-12)


def _pow_safe_pow(base, e):
    return torch.exp(e * torch.log(torch.clamp_min(base, _tiny(base))))


def _pow_newton_step(r, x0, y0, a, rh):
    """One safeguarded Newton step on r of the power-cone projection: a
    function of r alone (x0, y0, a and rh = |z0| are fixed per row), so the
    iteration's iterates repeat for good once one repeats. A row with
    |f| < 1e-12 keeps its r: a fixed point."""
    b = 1 - a
    x = _pow_calc_x(r, x0, a, rh)
    y = _pow_calc_x(r, y0, b, rh)
    xy = _pow_safe_pow(x, a) * _pow_safe_pow(y, b)
    f = xy - r
    dxdr = a * (rh - 2.0 * r) / (2.0 * x - x0)
    dydr = b * (rh - 2.0 * r) / (2.0 * y - y0)
    fp = xy * (a * dxdr / x + b * dydr / y) - 1.0
    # A step past an end of [0, rh] goes half way to that end and not onto
    # it. (scs_tpu clips onto the end. At r = rh, x or y sits on its 1e-12
    # floor, fp is ~1e9 and the next steps are ~1e-9: f64 crawls back in a
    # dozen steps, f32 cannot represent the step and stays on r = rh for
    # good, which is no projection; batches with a hundred power cones a
    # problem then never converge in f32.)
    step = r - f / fp
    r_new = torch.where(step > rh, 0.5 * (r + rh), torch.where(step < 0, 0.5 * r, step))
    return torch.where(torch.abs(f) < 1e-12, r, r_new)


def _pow_cases(v, a):
    """The rows of v (k, 3) inside K_a and inside its polar cone: those the
    projection returns without a Newton step."""
    x0, y0, z0 = v[:, 0], v[:, 1], v[:, 2]
    b = 1 - a
    in_cone = (x0 >= 0) & (y0 >= 0) & (
        _pow_safe_pow(x0, a) * _pow_safe_pow(y0, b) >= torch.abs(z0))
    in_polar = (
        (x0 <= 0) & (y0 <= 0)
        & (_pow_safe_pow(-x0 / a, a) * _pow_safe_pow(-y0 / b, b) >= torch.abs(z0))
    )
    return in_cone, in_polar


def _proj_pow_batch_ref(v, a, n_iters=POW_NEWTON_ITERS):
    """v: (k, 3), a: (k,) power parameters in (0, 1) — the plain version:
    scs_tpu's operations in scs_tpu's order, but for the Newton step's
    safeguard (_pow_newton_step)."""
    x0, y0, z0 = v[:, 0], v[:, 1], v[:, 2]
    b = 1 - a
    in_cone, in_polar = _pow_cases(v, a)
    rh = torch.abs(z0)
    r = rh / 2.0
    for _ in range(n_iters):
        r_new = _pow_newton_step(r, x0, y0, a, rh)
        if torch.equal(r_new, r):  # a fixed point: every later step repeats it
            break
        r = r_new
    x = _pow_calc_x(r, x0, a, rh)
    y = _pow_calc_x(r, y0, b, rh)
    z = torch.sign(z0) * r
    out = torch.stack([x, y, z], dim=1)
    out = _where_rows(in_polar, torch.zeros((), dtype=v.dtype, device=v.device), out)
    out = _where_rows(in_cone, v, out)
    return out


def _proj_pow_batch(v, a, sign=None, iters_out=None):
    """Rows of v (k, 3) onto the power cones K_a[row], a (k,) in (0, 1);
    rows with sign[row] < 0 onto the dual cone by Moreau. On CUDA: the
    proj_pow kernel, one thread per cone; taking a per row, one launch
    projects every power cone of a slack vector. `iters_out`, an int32 (k,)
    tensor, receives the Newton steps each row ran."""
    dev = v.device
    if dev.type == "cpu":
        return _signed(lambda w: _proj_pow_batch_ref(w, a), v, sign)
    if dev.type != "cuda":
        raise ValueError(f"_proj_pow_batch: unsupported device {dev}")
    _check_rows("_proj_pow_batch", v)
    v = v.contiguous()
    k = v.shape[0]
    _check_like("_proj_pow_batch", "a", a, v, (k,))
    a = a.contiguous()
    if sign is not None:
        _check_like("_proj_pow_batch", "sign", sign, v, (k,))
        sign = sign.contiguous()
    _check_counts("_proj_pow_batch", iters_out, k, dev)
    out = torch.empty_like(v)
    _launch("proj_pow", dev, _cone_symbol("proj_pow", v.dtype),
            v.data_ptr(), a.data_ptr(), _ptr(sign), out.data_ptr(), _ptr(iters_out), k)
    _proj_pow_batch.launches += 1
    return out


_proj_pow_batch.launches = 0  # kernel launches since the last reset


# ---------------------------------------------------------------------------
# ell1-norm cone: {(t, x): ||x||_1 <= t}
# ---------------------------------------------------------------------------


def _proj_ell1_batch(z):
    """z: (k, n+1) rows (t, x). Exact sort-based epigraph projection."""
    t0 = z[:, 0]
    x0 = z[:, 1:]
    n = x0.shape[1]
    ax = torch.abs(x0)
    l1 = ax.sum(dim=1)
    inside = l1 <= t0
    linf = ax.amax(dim=1) if n > 0 else torch.zeros_like(t0)
    in_polar = t0 <= -linf
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    # Find lam >= 0 with sum(max(|x|-lam,0)) = t0 + lam via the sorted
    # cumulative-sum characterization (waterfilling).
    srt = torch.sort(ax, dim=1, descending=True).values
    csum = torch.cumsum(srt, dim=1)
    j1 = torch.arange(2, n + 2, dtype=z.dtype, device=z.device)
    # candidate lam if exactly top-j entries stay active:
    lam_j = (csum - t0[:, None]) / j1[None, :]
    # valid when srt_j > lam_j >= srt_{j+1}
    nxt = torch.cat([srt[:, 1:], torch.full_like(srt[:, :1], -math.inf)], dim=1)
    valid = (lam_j < srt) & (lam_j >= nxt) & (lam_j >= 0)
    # pick the first valid j (exactly one exists when not inside/polar)
    lam = torch.where(valid, lam_j, -math.inf).amax(dim=1)
    lam = torch.clamp_min(lam, 0.0)

    x = torch.sign(x0) * torch.clamp_min(ax - lam[:, None], 0.0)
    t = t0 + lam
    out = torch.cat([t[:, None], x], dim=1)
    out = _where_rows(in_polar, zero, out)
    return _where_rows(inside, z, out)


# ---------------------------------------------------------------------------
# Nuclear-norm cone: {(t, X): ||X||_* <= t}, X is m x n column-major.
# SVD + ell1-epigraph projection of the singular values.
# ---------------------------------------------------------------------------


def _proj_nuc_batch(z, mn):
    mm, nn = mn
    t0 = z[:, :1]
    X = z[:, 1:].reshape(-1, nn, mm).transpose(1, 2)  # column-major unpack
    U, sig, Vh = torch.linalg.svd(X, full_matrices=False)
    proj = _proj_ell1_batch(torch.cat([t0, sig], dim=1))
    t = proj[:, :1]
    sig_p = proj[:, 1:]
    Xp = (U * sig_p[:, None, :]) @ Vh
    return torch.cat([t, Xp.transpose(1, 2).reshape(z.shape[0], -1)], dim=1)


# ---------------------------------------------------------------------------
# Sum-of-k-largest-eigenvalues cone: {(t, X): sum_k-largest eig(X) <= t}.
# Spectral reduction + epigraph projection via nested bisection:
#   prox_{mu*s_k}(w) = w - mu * Pi_Y(w / mu),  Y = {y in [0,1]^n, 1'y = k}
# On CUDA the vector part is the proj_sl_vec kernel (C5).
# ---------------------------------------------------------------------------


def _bisect_step(lo, mid, hi, up):
    """A bisection pass's new bracket: lo = mid where `up`, else hi = mid."""
    return torch.where(up, mid, lo), torch.where(up, hi, mid)


def _frozen(lo, hi, lo_new, hi_new):
    """Whether a bisection pass left every row's bracket as it was: the
    pass is a function of (lo, hi) alone, so every later pass repeats it."""
    return torch.equal(lo_new, lo) and torch.equal(hi_new, hi)


def _still_moving(live, lo, hi, lo_new, hi_new):
    """Rows whose bracket every bisection pass so far has moved: a row's
    bracket, once a pass leaves it as it was, stays so (the plain map's
    count of a row's passes is the passes before it froze)."""
    return live & ((lo_new != lo) | (hi_new != hi))


def _proj_capped_simplex(w, k_val, n_bisect=60, passes=None):
    """Project rows of w onto {y: 0 <= y <= 1, sum(y) = k}. `passes`, an
    int64 (k,) tensor, receives per row the bisection passes before its
    bracket froze."""
    lo = w.amin(dim=1) - 1.0
    hi = w.amax(dim=1)
    live = torch.ones_like(lo, dtype=torch.bool)
    moved = torch.zeros_like(lo, dtype=torch.int64)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ssum = torch.clamp(w - mid[:, None], 0.0, 1.0).sum(dim=1)
        lo_new, hi_new = _bisect_step(lo, mid, hi, ssum > k_val)
        if passes is not None:
            live = _still_moving(live, lo, hi, lo_new, hi_new)
            moved += live
        if _frozen(lo, hi, lo_new, hi_new):
            break
        lo, hi = lo_new, hi_new
    if passes is not None:
        passes.copy_(moved)
    tau = 0.5 * (lo + hi)
    return torch.clamp(w - tau[:, None], 0.0, 1.0)


def _sum_k_largest(w, k_val):
    srt = torch.sort(w, dim=1, descending=True).values
    return srt[:, : int(k_val)].sum(dim=1)


class _PlainCounts:
    """Per row, the passes a plain version's nested bisections needed, for
    its `counts` output: each evaluation of the outer function that the
    row's answer needs (tally(needed, inner passes, inner bisection
    passes)) adds one outer pass, its inner passes, and raises the most
    inner bisection passes."""

    def __init__(self, like):
        zero = lambda: torch.zeros_like(like, dtype=torch.int64)  # noqa: E731
        self.outer, self.inner, self.outer_bisect, self.inner_bisect = (zero() for _ in range(4))

    def tally(self, needed, inner, inner_bisect):
        self.outer += needed
        self.inner += torch.where(needed, inner, 0)
        self.inner_bisect = torch.maximum(self.inner_bisect, torch.where(needed, inner_bisect, 0))

    def report(self, counts, inside):
        """Into the dict `counts`, 0 for the rows already inside: their
        answer depends on no pass."""
        for key in ("outer", "inner", "outer_bisect", "inner_bisect"):
            counts[key] = torch.where(inside, 0, getattr(self, key))


def _proj_sl_vec_batch_ref(t0, w0, k_val, n_bisect=60, counts=None):
    """Project (t, w) onto {(t, w): sum of k largest w_i <= t} — the plain
    version. A bisection ends early only where every later pass would
    change nothing. `counts`, a dict, receives per row (int64 (k,)) the
    plain map's passes, those before each bracket froze (0 for a row
    already inside): "outer" the evaluations of h(mu) (the bisection's and
    the final one), "inner" the capped simplex's bisection passes they
    need, "outer_bisect" the outer bisection's passes and "inner_bisect"
    the most any capped simplex took. The bisections cut at a row's
    "outer_bisect" / "inner_bisect" give its answer bit for bit."""
    sk = _sum_k_largest(w0, k_val)
    inside = sk <= t0
    tally = _PlainCounts(t0) if counts is not None else None
    passes = torch.zeros_like(t0, dtype=torch.int64) if counts is not None else None

    def h(mu):
        y = _proj_capped_simplex(w0 / torch.clamp_min(mu, _tiny(mu))[:, None], k_val,
                                 passes=passes)
        w = w0 - mu[:, None] * y
        return _sum_k_largest(w, k_val) - t0 - mu, w

    # mu in [0, ub]: at mu = ub = (sk - t0) (clipped positive), h(ub) <= 0
    lo = torch.zeros_like(t0)
    hi = torch.clamp_min(sk - t0, 1e-12)
    live = torch.ones_like(inside)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        val, _ = h(mid)
        lo_new, hi_new = _bisect_step(lo, mid, hi, val > 0)
        if tally is not None:
            live = _still_moving(live, lo, hi, lo_new, hi_new)
            tally.outer_bisect += live
            tally.tally(live, passes, passes)
        if _frozen(lo, hi, lo_new, hi_new):
            break
        lo, hi = lo_new, hi_new
    mu = 0.5 * (lo + hi)
    _, w = h(mu)
    if tally is not None:
        tally.tally(torch.ones_like(inside), passes, passes)
        tally.report(counts, inside)
    t = torch.where(inside, t0, t0 + mu)
    w = _where_rows(inside, w0, w)
    return t, w


def _check_spectral(who, w0, *vecs):
    """w0: float32 or float64 eigenvalue rows (k, n), n >= 1; each of vecs
    (k,) of w0's type on w0's device."""
    _check_rows(who, w0, width=None)
    for name, t in zip(("t0", "v0"), vecs):
        _check_like(who, name, t, w0, w0.shape[:1])


def _proj_sl_vec_batch(t0, w0, k_val, inner_out=None, outer_out=None):
    """Rows (t0 (k,), w0 (k, n)) onto {(t, w): sum of the k_val largest w_i
    <= t}, k_val in 1..n; returns (t, w). On CUDA: the proj_sl_vec kernel
    (csrc/spectral_proj.cu), a cluster of two blocks a cone, its bisections
    multisected across warps and lane groups. `inner_out` and `outer_out`,
    int32 (k,) tensors, receive per row the kernel's serial passes: the
    capped simplex's along the cone's chain, and the passes of the root in
    mu with its final evaluation."""
    _check_spectral("_proj_sl_vec_batch", w0, t0)
    k, n = w0.shape
    kk = int(k_val)
    if kk != k_val or not 1 <= kk <= n:
        raise ValueError(f"_proj_sl_vec_batch: k must be an integer in 1..{n}, got {k_val!r}")
    dev = w0.device
    if dev.type == "cpu":
        return _proj_sl_vec_batch_ref(t0, w0, k_val)
    if dev.type != "cuda":
        raise ValueError(f"_proj_sl_vec_batch: unsupported device {dev}")
    for counts in (inner_out, outer_out):
        _check_counts("_proj_sl_vec_batch", counts, k, dev)
    t0, w0 = t0.contiguous(), w0.contiguous()
    t, w = torch.empty_like(t0), torch.empty_like(w0)
    if k == 0:
        return t, w
    _launch("proj_sl_vec", dev, _cone_symbol("proj_sl_vec", w0.dtype, "spectral_proj"),
            t0.data_ptr(), w0.data_ptr(), t.data_ptr(), w.data_ptr(), _ptr(inner_out),
            _ptr(outer_out), k, n, kk)
    _proj_sl_vec_batch.launches += 1
    return t, w


_proj_sl_vec_batch.launches = 0  # kernel launches since the last reset


def _proj_sl_batch(z, nk):
    nn, kk = nk
    t0 = z[:, 0]
    X = _sym_unpack_true(z[:, 1:], nn)
    w, v = torch.linalg.eigh(X)
    t, wp = _proj_sl_vec_batch(t0, w, kk)
    Xp = _eig_rebuild(v, wp)
    return torch.cat([t[:, None], _sym_pack_true(Xp)], dim=1)


# ---------------------------------------------------------------------------
# Log-determinant cone: K = cl{(t, v, X): v > 0, X PSD, t <= v*logdet(X/v)}
# (dim = sd_cone_size(n) + 2). Spectral reduction + nested bisection on the
# 2-variable KKT system. On CUDA the vector part is the proj_logdet_vec
# kernel (C4).
# ---------------------------------------------------------------------------


def _proj_logdet_vec_batch_ref(t0, v0, w0, n_outer=80, counts=None):
    """Project (t, v, w) onto cl{(t,v,w): v>0, w>0, t <= v*sum(log(w/v))} —
    the plain version.

    KKT with multiplier mu >= 0 of g = t - v*sum(log(w/v)) <= 0:
      t   = t0 - mu
      w_i = (w0_i + sqrt(w0_i^2 + 4*mu*v)) / 2
      v   = v0 + mu*(sum(log(w_i/v)) - n)          [phi(v) = 0, phi' > 1]
      root equation  h(mu) = v*slog - (t0 - mu) = 0  (h increasing).

    The projection is one of three candidates (uniqueness of projection +
    facet decomposition of the boundary):
      A: (t0, v0, w0) itself when already in the cone;
      C: the active-constraint KKT point with v > 0 (nested bisection);
      D: the projection onto the v = 0 facet {t <= 0, w >= 0}.
    We return the feasible candidate with minimal distance. A loop ends
    early only where every later pass would change nothing.

    `counts`, a dict, receives per row (int64 (k,)) the plain map's passes,
    those each row needs (0 for a row already inside): "outer" the
    evaluations of h(mu) (growth until the root is bracketed, the
    bisection's passes before its bracket froze, the final one), "inner"
    the evaluations of slog(v) they need (the same three parts of each
    root in v), "outer_bisect" the outer bisection's passes and
    "inner_bisect" the most any root in v took. The bisections cut at a
    row's "outer_bisect" / "inner_bisect" give its answer bit for bit.
    """
    fn = float(w0.shape[1])
    tiny = _tiny(w0)
    w0_sq = w0 * w0
    track = counts is not None

    def solve_v(mu):
        """Inner 1-D bisection on phi(v) = v - v0 - mu*(slog(v) - n);
        with the row's slog evaluations and bisection passes."""
        four_mu = 4.0 * mu[:, None]

        def slog_of(vv):
            w = 0.5 * (w0 + torch.sqrt(w0_sq + four_mu * vv[:, None]))
            return (
                torch.log(torch.clamp_min(w, tiny)).sum(dim=1)
                - fn * torch.log(torch.clamp_min(vv, tiny)),
                w,
            )

        lo = torch.full_like(v0, 1e-30)
        hi = torch.clamp_min(torch.abs(v0), 1.0)
        evals = bis = torch.zeros_like(v0, dtype=torch.int64) if track else None
        live = torch.ones_like(v0, dtype=torch.bool)
        for _ in range(40):
            slog, _ = slog_of(hi)
            phi = hi - v0 - mu * (slog - fn)
            need = phi < 0  # root above hi
            if track:
                evals = evals + live
                live = live & need
            if not bool(need.any()):
                break
            lo = torch.where(need, hi, lo)
            hi = torch.where(need, hi * 4.0, hi)
        live = torch.ones_like(live)
        for _ in range(LOGDET_V_BISECTIONS):
            mid = 0.5 * (lo + hi)
            slog, _ = slog_of(mid)
            phi = mid - v0 - mu * (slog - fn)
            lo_new, hi_new = _bisect_step(lo, mid, hi, phi < 0)
            if track:
                live = _still_moving(live, lo, hi, lo_new, hi_new)
                bis = bis + live
            if _frozen(lo, hi, lo_new, hi_new):
                break
            lo, hi = lo_new, hi_new
        v = 0.5 * (lo + hi)
        slog, w = slog_of(v)
        return v, w, slog, (evals + bis + 1, bis) if track else None

    tally = _PlainCounts(t0) if track else None

    def h_of(mu):
        v, w, slog, passes = solve_v(mu)
        return v * slog - t0 + mu, v, w, passes

    # outer bisection on mu: h increasing, root where constraint active
    lo = torch.zeros_like(t0)
    hi = torch.ones_like(t0)
    live = torch.ones_like(t0, dtype=torch.bool)
    for _ in range(40):
        h, _, _, passes = h_of(hi)
        need = h < 0
        if track:
            tally.tally(live, *passes)
            live = live & need
        if not bool(need.any()):
            break
        lo = torch.where(need, hi, lo)
        hi = torch.where(need, hi * 4.0, hi)
    live = torch.ones_like(live)
    for _ in range(n_outer):
        mid = 0.5 * (lo + hi)
        h, _, _, passes = h_of(mid)
        lo_new, hi_new = _bisect_step(lo, mid, hi, h < 0)
        if track:
            live = _still_moving(live, lo, hi, lo_new, hi_new)
            tally.outer_bisect += live
            tally.tally(live, *passes)
        if _frozen(lo, hi, lo_new, hi_new):
            break
        lo, hi = lo_new, hi_new
    mu = 0.5 * (lo + hi)
    _, vC, wC, passes = h_of(mu)
    if track:
        tally.tally(torch.ones_like(live), *passes)
    tC = t0 - mu

    # candidate D: v = 0 facet
    tD = torch.clamp_max(t0, 0.0)
    vD = torch.zeros_like(v0)
    wD = torch.clamp_min(w0, 0.0)

    def dist2(t, v, w):
        return (t - t0) ** 2 + (v - v0) ** 2 + ((w - w0) ** 2).sum(dim=1)

    use_D = dist2(tD, vD, wD) < dist2(tC, vC, wC)
    t = torch.where(use_D, tD, tC)
    v = torch.where(use_D, vD, vC)
    w = _where_rows(use_D, wD, wC)

    # candidate A: already inside (closure-aware test)
    w_pos = (w0 >= 0).all(dim=1)
    slog0 = torch.log(torch.clamp_min(w0, tiny)).sum(dim=1) - fn * torch.log(
        torch.clamp_min(v0, tiny)
    )
    inside = torch.where(
        v0 > 0,
        w_pos & (t0 <= v0 * slog0),
        (v0 == 0) & w_pos & (t0 <= 0),
    )
    if track:
        tally.report(counts, inside)
    t = torch.where(inside, t0, t)
    v = torch.where(inside, v0, v)
    w = _where_rows(inside, w0, w)
    return t, v, w


def _proj_logdet_vec_batch(t0, v0, w0, inner_out=None, outer_out=None):
    """Rows (t0 (k,), v0 (k,), w0 (k, n)) onto the logdet cone's vector form
    cl{(t, v, w): v > 0, w > 0, t <= v sum(log(w / v))}; returns (t, v, w).
    On CUDA: the proj_logdet_vec kernel (csrc/spectral_proj.cu), a cluster
    of two blocks a cone, its bisections multisected across warps and lane
    groups. `inner_out` and `outer_out`, int32 (k,) tensors, receive per row
    the kernel's serial passes: those of the roots in v along the cone's chain
    (each a sum over the row), and the passes of the root in mu with its
    final evaluation."""
    _check_spectral("_proj_logdet_vec_batch", w0, t0, v0)
    dev = w0.device
    if dev.type == "cpu":
        return _proj_logdet_vec_batch_ref(t0, v0, w0)
    if dev.type != "cuda":
        raise ValueError(f"_proj_logdet_vec_batch: unsupported device {dev}")
    k, n = w0.shape
    for counts in (inner_out, outer_out):
        _check_counts("_proj_logdet_vec_batch", counts, k, dev)
    t0, v0, w0 = t0.contiguous(), v0.contiguous(), w0.contiguous()
    t, v, w = torch.empty_like(t0), torch.empty_like(v0), torch.empty_like(w0)
    if k == 0:
        return t, v, w
    _launch("proj_logdet_vec", dev, _cone_symbol("proj_logdet_vec", w0.dtype, "spectral_proj"),
            t0.data_ptr(), v0.data_ptr(), w0.data_ptr(), t.data_ptr(), v.data_ptr(), w.data_ptr(),
            _ptr(inner_out), _ptr(outer_out), k, n)
    _proj_logdet_vec_batch.launches += 1
    return t, v, w


_proj_logdet_vec_batch.launches = 0  # kernel launches since the last reset


def _proj_logdet_batch(z, nn):
    t0 = z[:, 0]
    v0 = z[:, 1]
    X = _sym_unpack_true(z[:, 2:], nn)
    w, vec = torch.linalg.eigh(X)
    t, v, wp = _proj_logdet_vec_batch(t0, v0, w)
    Xp = _eig_rebuild(vec, wp)
    return torch.cat([t[:, None], v[:, None], _sym_pack_true(Xp)], dim=1)


# ---------------------------------------------------------------------------
# Projector factory
# ---------------------------------------------------------------------------

# one bucket holds every exponential cone (primal and dual) and one every
# power cone (any power, primal and dual), so that a projection launches
# each of those kernels once; the other kinds bucket by (kind, size)
_MERGED = {"ep": "exp", "ed": "exp", "p": "pow"}
# the kinds whose projection factorizes a matrix (eigh, svd)
_FACTORIZED = {
    "s": _proj_psd_batch, "cs": _proj_csd_batch, "nuc": _proj_nuc_batch,
    "sl": _proj_sl_batch, "d": _proj_logdet_batch,
}


def _finite_rows(fn, rows):
    """fn(rows) with rows that hold a NaN or an infinity answered by NaN.
    An iterate may carry one (a rejected acceleration candidate does): XLA's
    eigh and svd hand NaN on, the library's raise on it, so such rows are
    kept from the factorization."""
    ok = torch.isfinite(rows).all(dim=1, keepdim=True)
    out = fn(torch.where(ok, rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
    return torch.where(ok, out, math.nan)


def _project_bucket(kind, param, rows, consts):
    """Project one bucket's rows (k, size); consts holds the bucket's
    per-device tensors."""
    if kind == "q":
        return _proj_soc_batch(rows)
    if kind in _FACTORIZED:
        return _finite_rows(lambda r: _FACTORIZED[kind](r, param), rows)
    if kind == "exp":
        return _proj_exp_batch(rows, _tile(consts, "sign", rows))
    if kind == "pow":
        return _proj_pow_batch(
            rows, _tile(consts, "a", rows), _tile(consts, "sign", rows)
        )
    if kind == "ell1":
        return _proj_ell1_batch(rows)
    raise NotImplementedError(f"cone kind {kind}")  # pragma: no cover


def _tile(consts, name, rows):
    """A bucket's per-cone constant consts[name] (count,), repeated for the
    B slack vectors whose cones the rows (B*count, size) stack; the
    repeated tensor is kept for the next call at this B."""
    per_cone = consts[name]
    if per_cone is None or per_cone.shape[0] == rows.shape[0]:
        return per_cone
    reps = rows.shape[0] // per_cone.shape[0]
    if (name, reps) not in consts:
        consts[(name, reps)] = per_cone.repeat(reps)
    return consts[(name, reps)]


def make_cone_projector(spec: ConeSpec, dtype=torch.float64) -> Callable:
    """Build Pi_K for the full concatenated slack vector (last axis m).

    Returns proj(z, bl=None, bu=None) for z of shape (m,) or (B, m); the
    box-cone bounds may be supplied per call (the solver normalizes them
    with the row scaling D, so they are per-instance data, not static
    structure): (bsize-1,) shared, or (B, bsize-1). All ragged layout work
    happens here; tensors the projector needs (gather indices, powers,
    default bounds) are made once per device at the first call there. Dual
    projection: use `make_dual_cone_projector`.
    """
    m = spec.dim
    # bucket segments; each bucket becomes one batched op
    buckets = {}
    for sg in spec.segments():
        kind, param = sg.kind, sg.param
        if kind in ("s", "cs") and param == 1:
            kind, param = "l", kind  # a 1 x 1 PSD block is the nonneg clamp
        if kind in _MERGED:
            key = (_MERGED[kind], None)
        else:
            key = (kind, param)
        buckets.setdefault(key, []).append(sg)

    # Lay the buckets side by side: `order` lists the slack positions
    # bucket after bucket, so that z[..., order] holds every bucket as one
    # contiguous range, and `inverse` puts the results back. Where the
    # segments already lie so, both are the identity and are skipped.
    plans = []  # (kind, param, lo, hi, count, per-cone numpy constants)
    order, lo = [], 0
    for (kind, param), group in buckets.items():
        for sg in group:
            order.append(np.arange(sg.offset, sg.offset + sg.length))
        length = sum(sg.length for sg in group)
        consts = {}
        if kind == "exp":
            sign = np.array([-1.0 if sg.kind == "ed" else 1.0 for sg in group])
            consts["sign"] = sign if (sign < 0).any() else None
        elif kind == "pow":
            powers = np.array([sg.param for sg in group], np.float64)
            consts["a"] = np.abs(powers)
            consts["sign"] = np.where(powers < 0, -1.0, 1.0) if (powers < 0).any() else None
        plans.append((kind, param, lo, lo + length, len(group), consts))
        lo += length
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    permuted = not np.array_equal(order, np.arange(m))
    inverse = np.argsort(order)

    per_device = {}

    def on_device(device):
        if device not in per_device:

            def t(a, **kw):
                out = torch.as_tensor(a, device=device, **kw)
                if out.numel():
                    trace.uploaded(device, "proj_tables")
                return out

            per_device[device] = {
                "order": t(order) if permuted else None,
                "inverse": t(inverse) if permuted else None,
                "bl": t(np.asarray(spec.bl), dtype=dtype),
                "bu": t(np.asarray(spec.bu), dtype=dtype),
                "consts": [
                    {k: (None if c is None else t(c, dtype=dtype)) for k, c in consts.items()}
                    for *_, consts in plans
                ],
            }
        return per_device[device]

    def proj(z, bl=None, bu=None):
        dev = on_device(z.device)
        bl = dev["bl"] if bl is None else bl
        bu = dev["bu"] if bu is None else bu
        zz = z.index_select(-1, dev["order"]) if permuted else z
        lead = z.shape[:-1]
        parts = []
        for (kind, param, lo, hi, count, _), consts in zip(plans, dev["consts"]):
            vals = zz[..., lo:hi]
            if kind == "z":
                res = torch.zeros_like(vals)
            elif kind == "l":
                res = _proj_nonneg(vals)
            elif kind == "box":
                res = _proj_box(vals, bl, bu)
            else:
                rows = vals.reshape(-1, (hi - lo) // count)
                res = _project_bucket(kind, param, rows, consts).reshape(*lead, hi - lo)
            parts.append(res)
        if not parts:
            return z.clone()
        out = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        return out.index_select(-1, dev["inverse"]) if permuted else out

    proj.per_device, proj.on_device = per_device, on_device  # the tables, for the tests
    return proj


def make_dual_cone_projector(spec: ConeSpec, dtype=torch.float64) -> Callable:
    """Pi_K*(z) = z + Pi_K(-z) (Moreau; gen_random_cone_prob.py:82-83)."""
    proj = make_cone_projector(spec, dtype)

    def proj_dual(z, bl=None, bu=None):
        return z + proj(-z, bl, bu)

    return proj_dual


# Bounded LRU: cap projector growth in long-running processes sweeping
# many cone structures.
_PROJECTOR_CACHE = {}
_PROJECTOR_CACHE_MAX = 64


def spec_signature(spec: ConeSpec):
    """Static structure key for a ConeSpec (box bounds enter dynamically)."""
    return (
        spec.z,
        spec.l,
        len(spec.bu),
        spec.q,
        spec.s,
        spec.cs,
        spec.ep,
        spec.ed,
        spec.p,
        spec.d,
        spec.nuc,
        spec.ell1,
        spec.sl,
    )


def get_projector(spec: ConeSpec, dtype=torch.float64) -> Callable:
    """Cached projector keyed by cone structure (shared across instances)."""
    key = (spec_signature(spec), str(dtype))
    if key in _PROJECTOR_CACHE:
        _PROJECTOR_CACHE[key] = _PROJECTOR_CACHE.pop(key)  # refresh LRU
    else:
        while len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
            _PROJECTOR_CACHE.pop(next(iter(_PROJECTOR_CACHE)))
        _PROJECTOR_CACHE[key] = make_cone_projector(spec, dtype)
    return _PROJECTOR_CACHE[key]
