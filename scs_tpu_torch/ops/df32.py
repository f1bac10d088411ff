"""Compensated float32 products for the high-accuracy mode — the port of
scs_tpu/ops/df32.py.

A float32 product a*b is written as p + err with p = fl(a*b) and err exact
(Dekker's split of both operands into 12-bit halves, no FMA needed).
Summing the p-stream and the err-stream apart leaves about one ulp of
relative error, independent of the products' rounding, where a plain f32
matvec carries an error that grows with the width. The solver uses these
for its residuals, its refinement residuals and g when the tolerance is
tighter than a plain f32 matvec can measure (Core.hi_acc), and polish.py
for its refinement and its verification.

  * mv(M, v)  — compensated M @ v
  * tv(M, u)  — compensated M.T @ u
  * dot(a, b) — compensated a . b

M is (r, c) with a vector, or (B, r, c) with (B, k) vectors; dot takes (k,)
or (B, k). mv_ref / tv_ref / dot_ref are scs_tpu's formulas as elementwise
PyTorch operations (eager PyTorch never contracts a multiply and an add, so
p + err == a*b holds exactly). On a CPU tensor the public functions are
those plain versions. On a CUDA float32 tensor they launch kernel D1
(csrc/gemv.cu, gemv_rows_comp_f32 / gemv_cols_comp_f32: G1 and G2 with two
accumulators a lane, err = fma(a, b, -p), M read once) and count the launch
in `mv.launches` / `tv.launches` and by (B, r, c) in `.shapes`; dot is mv on
a (B, 1, k) view of a and counts as mv. Anything else on CUDA raises (f64
never needs compensation: the solver gates hi_acc on f32).
"""

from __future__ import annotations

from collections import Counter

import torch

from .dense import _fn, _launch, _prepare, cols_cluster

_SPLIT = 4097.0  # 2^12 + 1 for float32 (24-bit significand)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + err == a*b exactly (barring overflow in the split)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def mv_ref(M, v):
    """Plain compensated M @ v: p- and err-streams summed apart."""
    p, err = _two_prod(M, v[..., None, :])
    return p.sum(-1) + err.sum(-1)


def tv_ref(M, u):
    """Plain compensated M.T @ u."""
    p, err = _two_prod(M, u[..., :, None])
    return p.sum(-2) + err.sum(-2)


def dot_ref(a, b):
    """Plain compensated dot over the last axis."""
    p, err = _two_prod(a, b)
    return p.sum(-1) + err.sum(-1)


def _cuda_args(who, M, vec, vec_axis):
    if M.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {M.device}")
    if M.dtype != torch.float32:
        raise TypeError(f"{who}: the compensated kernel takes float32 on CUDA, got {M.dtype}")
    return _prepare(who, M, vec, vec_axis)


def mv(M, v):
    """Compensated M @ v; on CUDA the gemv_rows_comp kernel (D1)."""
    if M.device.type == "cpu":
        return mv_ref(M, v)
    M3, v2, squeeze = _cuda_args("df32.mv", M, v, 2)
    B, r, c = M3.shape
    y = torch.empty((B, r), dtype=M3.dtype, device=M3.device)
    _launch("df32.mv", M3.device, _fn("gemv_rows_comp", M3.dtype),
            M3.data_ptr(), v2.data_ptr(), y.data_ptr(), B, r, c)
    mv.launches += 1
    mv.shapes[(B, r, c)] += 1
    return y[0] if squeeze else y


mv.launches = 0  # kernel launches since the last reset (dot's included)
mv.shapes = Counter()  # the same launches by (B, r, c)


def tv(M, u):
    """Compensated M.T @ u; on CUDA the gemv_cols_comp kernel (D1), its rows
    split over the same cluster as gemv_cols'."""
    if M.device.type == "cpu":
        return tv_ref(M, u)
    M3, u2, squeeze = _cuda_args("df32.tv", M, u, 1)
    B, r, c = M3.shape
    y = torch.empty((B, c), dtype=M3.dtype, device=M3.device)
    _launch("df32.tv", M3.device, _fn("gemv_cols_comp", M3.dtype),
            M3.data_ptr(), u2.data_ptr(), y.data_ptr(), B, r, c,
            cols_cluster(B, r, c, M3.element_size()))
    tv.launches += 1
    tv.shapes[(B, r, c)] += 1
    return y[0] if squeeze else y


tv.launches = 0  # kernel launches since the last reset
tv.shapes = Counter()  # the same launches by (B, r, c)


def dot(a, b):
    """Compensated dot of (k,) or (B, k) vectors over the last axis; on CUDA
    mv on the (B, 1, k) view of a."""
    if a.device.type == "cpu":
        return dot_ref(a, b)
    return mv(a.contiguous()[..., None, :], b)[..., 0]
