"""ADMM / Douglas-Rachford solver loop on the homogeneous self-dual embedding,
in PyTorch — the port of scs_tpu/solver.py. The linear projection runs
under one of three strategies:

  * "direct": a cached dense Cholesky factor of S = rho_x*I + P + A' D_y A,
    applied by two triangular solves (direct_solver="cholesky") or, with
    the factor slot holding S^-1, by one dense matvec ("inverse");
  * "indirect": matrix-free Jacobi-preconditioned CG on dense A;
  * "bell": the same CG with every S·x product as two or three block-ELL
    SpMVs (csrc/bell_spmv.cu on CUDA).

Every dense matvec of the first two (A x, A' y, P x, S^-1 r) goes through
ops/dense.py — the hand-written kernels of csrc/gemv.cu on CUDA. In
scs_tpu's high-accuracy mode (f32 at eps below 3e-5, `Core.hi_acc`) the
residuals, the refinement residuals and g take the compensated products of
ops/df32.py instead (kernel D1 on CUDA).

The math is scs_tpu's, step for step (see the scs_tpu/solver.py docstring
for the derivation). What changes is where the control flow runs: JAX
traces the whole solve into device loops (lax.while_loop, lax.cond);
PyTorch runs eagerly, so every loop and branch here is a host loop or a
host `if`, reading one small device value where the decision needs it:

  * CG (`_cg`): one read of the stop test per CG iteration;
  * the AA trial (`_iter_tail`): one read of the accept test per trial;
  * `_check`: a few reads per check_interval iterations.

Iteration counters and statuses therefore live on the host as Python
ints; vectors and float scalars stay on the device as tensors. Updates
are out of place (a State is never mutated), so a state can be reused —
the cold-start state of a solver instance serves every later solve.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import trace
from .cones import ConeSpec
from .info import FAILED, INFEASIBLE, SOLVED, UNBOUNDED, UNFINISHED
from .ops import df32
from .ops.projections import get_projector
from .ops.dense import gemv_cols, gemv_rows
from .ops.sparse import bell_spmv
from .settings import Settings

ZERO_CONE_RY_FACTOR = 1e-3  # zero-cone rows get rho_y = factor / scale


def _cholesky_solve(b, L, site):
    """torch.cholesky_solve, its wait counted at `site` (trace.py): on a
    card PyTorch solves a batch of more than one system with MAGMA, which
    reads its status on the host."""
    x = torch.cholesky_solve(b, L)
    if x.is_cuda and x.dim() > 2 and math.prod(x.shape[:-2]) > 1:
        trace.host_sync(site)
    return x


@contextlib.contextmanager
def _no_tf32():
    """Full-f32 matrix products for the duration of the block, restoring
    the caller's setting afterwards (the counterpart of scs_tpu's `_hp`
    precision pin: TF32 keeps ~3 decimal digits, which would stall the
    AA least squares the way bf16 MXU passes do on the TPU)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _norm(x):
    return torch.linalg.vector_norm(x)


def mean_call_time(call, sync, reps=5):
    """One warm call, then the mean wall time of `reps` calls, each ended
    by sync() (a device synchronize on CUDA)."""
    call()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
        sync()
    return (time.perf_counter() - t0) / reps


class BellData(NamedTuple):
    """Block-ELL operator data: A and the pre-transposed A^T packed into
    dense (bs x bs) tiles; colsq_* feed the Jacobi preconditioner without
    materializing dense A."""

    A_blocks: torch.Tensor  # (nbr, wA, bs, bs)
    A_cols: torch.Tensor  # (nbr, wA) int32 block-column ids
    At_blocks: torch.Tensor  # (nbc, wAt, bs, bs)
    At_cols: torch.Tensor  # (nbc, wAt)
    colsq_all: torch.Tensor  # (n,) sum_i A_ij^2
    colsq_zero: torch.Tensor  # (n,) sum over zero-cone rows of A_ij^2


class PBell(NamedTuple):
    """Block-ELL pack of the (symmetric) quadratic-cost matrix P."""

    blocks: torch.Tensor  # (nb, w, bs, bs)
    cols: torch.Tensor  # (nb, w) int32
    diag: torch.Tensor  # (n,) diag(P) for the Jacobi preconditioner


class Mats(NamedTuple):
    """Problem data (normalized). The operator is either the block-ELL
    packs (bell strategy: `bell`, `pbell`) or the dense `A`, `P` (direct and
    indirect strategies); the other pair is None, where scs_tpu keeps
    zero-size arrays."""

    bn: torch.Tensor  # (m,)
    cn: torch.Tensor  # (n,)
    bl: torch.Tensor  # normalized box lower bounds (possibly size 0)
    bu: torch.Tensor  # normalized box upper bounds
    # un-normalization data
    D: torch.Tensor  # (m,)
    E: torch.Tensor  # (n,)
    sc_b: torch.Tensor  # scalar
    sc_c: torch.Tensor  # scalar
    norm_b: torch.Tensor  # ||b|| original
    norm_c: torch.Tensor  # ||c|| original
    bell: Optional[BellData] = None  # block-ELL pack (bell strategy only)
    pbell: Optional[PBell] = None  # block-ELL pack of P (bell + has_P only)
    A: Optional[torch.Tensor] = None  # (m, n) dense (direct, indirect)
    P: Optional[torch.Tensor] = None  # (n, n) dense, has_P only


class AAState(NamedTuple):
    dX: torch.Tensor  # (L, N) ring buffer of w-iterate deltas
    dF: torch.Tensor  # (L, N) ring buffer of DR-residual deltas
    zeta_prev: torch.Tensor  # (N,) previous w
    f_prev: torch.Tensor  # (N,) previous DR residual
    count: int  # total deltas pushed (-1 = empty)
    n_accept: int
    n_reject_nonfinite: int
    n_reject_weight_cap: int
    n_safeguard_reject: int
    last_aa_norm: torch.Tensor
    last_reg: torch.Tensor
    aa_iter: int


class Diag(NamedTuple):
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    res_infeas: torch.Tensor
    res_unbdd_a: torch.Tensor
    res_unbdd_p: torch.Tensor
    comp_slack: torch.Tensor
    # homogeneous (not tau-divided) residual norms in ORIGINAL units —
    # the reference CSV's ax_s_btau_nrm_* / px_aty_ctau_nrm_* columns
    ax_s_btau_2: torch.Tensor
    ax_s_btau_inf: torch.Tensor
    px_aty_ctau_2: torch.Tensor
    px_aty_ctau_inf: torch.Tensor
    # the same quantities on the NORMALIZED (equilibrated) data — the
    # reference CSV's *_normalized columns
    res_pri_norm: torch.Tensor
    res_dual_norm: torch.Tensor
    gap_norm: torch.Tensor
    pobj_norm: torch.Tensor
    dobj_norm: torch.Tensor
    ax_s_btau_2_norm: torch.Tensor
    ax_s_btau_inf_norm: torch.Tensor
    px_aty_ctau_2_norm: torch.Tensor
    px_aty_ctau_inf_norm: torch.Tensor
    res_infeas_norm: torch.Tensor
    res_unbdd_a_norm: torch.Tensor
    res_unbdd_p_norm: torch.Tensor


class State(NamedTuple):
    # Governing DR variable (reflection form), as in scs_tpu:
    #   u_t = (R+Q)^-1 R w;  u = Pi_C(2 u_t - w);  w+ = w + alpha(u - u_t)
    # u is the cone-projected iterate and v = w+ - u the dual variable.
    w: torch.Tensor  # (N,) = (n + m + 1,)
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)
    # running (ergodic) averages; termination checks consider both
    u_sum: torch.Tensor  # (N,)
    v_sum: torch.Tensor  # (N,)
    avg_cnt: float  # iterations accumulated
    scale: torch.Tensor  # current DR scale (dynamic under adaptive_scale)
    # (n, n) Cholesky factor of S (direct, "cholesky"), S^-1 itself
    # ("inverse"), or the empty (0, 0) slot (indirect, bell)
    L: torch.Tensor
    gx: torch.Tensor  # (n,)
    gy: torch.Tensor  # (m,)
    px_warm: torch.Tensor  # (n,) CG warm start
    it: int
    status: int
    scale_updates: int
    since_rescale: int
    cg_iters: int  # cumulative CG iterations
    # per-step movement diagnostics (reference CSV columns diff_u_ut_nrm_*
    # / diff_v_v_prev_nrm_*)
    diff_u_ut_2: torch.Tensor
    diff_u_ut_inf: torch.Tensor
    diff_v_2: torch.Tensor
    diff_v_inf: torch.Tensor
    diag: Diag
    aa: AAState


class Core:
    """Solver core for one (m, n, cone-structure, settings) problem, on
    the device named by stg.device."""

    def __init__(self, m, n, has_P, spec: ConeSpec, stg: Settings):
        self.m, self.n, self.has_P = m, n, has_P
        self.N = n + m + 1
        self.stg = stg
        self.device = torch.device(stg.device)
        self.dtype = torch.float64 if stg.dtype == "float64" else torch.float32
        self.spec = spec
        self._init_strategy(spec, stg)
        self.zero_mask = torch.as_tensor(spec.zero_row_mask(), device=self.device)
        # dtype-aware CG tolerance floor: in f32 a tolerance below
        # ~3e-7*||rhs|| is unreachable (CG stagnates at its roundoff
        # plateau and would burn cg_max_iters every solve)
        self.eps_floor = 3e-7 if self.dtype == torch.float32 else 1e-14
        # Primal cone projector; the y block uses the dual cone via Moreau.
        self._proj = get_projector(spec, self.dtype)
        self.lookback = int(stg.acceleration_lookback)
        self.interval = int(stg.acceleration_interval)
        self._phase_cache = None
        self._phase_samples = []

    def _init_strategy(self, spec: ConeSpec, stg: Settings):
        """Strategy flags and the refinement policy (scs_tpu
        solver.py:243-282); shared with the batched core."""
        if stg.solver_strategy not in ("direct", "indirect", "bell"):
            raise ValueError(
                f"solver_strategy must be resolved to 'direct', 'indirect' "
                f"or 'bell' before a core is built (got {stg.solver_strategy!r})"
            )
        self.strategy = stg.solver_strategy
        self.indirect = self.strategy in ("indirect", "bell")
        self.use_bell = self.strategy == "bell"
        # "inverse" applies S^-1 as one dense matvec (one gemv_rows launch)
        # instead of two triangular solves
        self.use_inverse = not self.indirect and stg.direct_solver == "inverse"
        f32 = self.dtype == torch.float32
        # High-accuracy mode: f32 tolerances below what a plain f32 matvec
        # can even measure (its evaluation noise, ~1e-7 |A||x|, exceeds an
        # eps of 1e-6 at ordinary norms) switch the residual evaluation, the
        # refinement residuals and g to the compensated products of
        # ops/df32.py. Dense strategies only, as in scs_tpu.
        self.hi_acc = f32 and min(stg.eps_abs, stg.eps_rel) < 3e-5 and not self.use_bell
        # Direct-path iterative refinement (auto: 1 pass for f32 — the
        # factor-solve error otherwise floors the DR residual; 2 on curved
        # cones; 2 compensated passes in high-accuracy mode, where the solve
        # error must reach ~1e-7 relative; 0 for f64 and for CG)
        if stg.lin_refine_steps >= 0:
            self.refine_steps = int(stg.lin_refine_steps)
        elif self.hi_acc and not self.indirect:
            self.refine_steps = 2
        elif f32 and not self.indirect:
            self.refine_steps = 1 if spec.is_simple else 2
        else:
            self.refine_steps = 0

    def _scalar(self, v):
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def _sync(self, site="sync"):
        """Wait for the device; a host sync counted at `site` (trace.py)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.host_sync(site)

    # -- metric helpers ---------------------------------------------------

    def _ry(self, scale):
        base = 1.0 / scale
        return torch.where(self.zero_mask, ZERO_CONE_RY_FACTOR * base, base)

    def _Ax(self, mats: Mats, x):
        """A @ x — the dense row-reduction kernel or block-ELL SpMV."""
        if not self.use_bell:
            return gemv_rows(mats.A, x)
        bell = mats.bell
        return bell_spmv(bell.A_blocks, bell.A_cols, x)[: self.m]

    def _ATy(self, mats: Mats, y):
        """A^T @ y — the dense column-reduction kernel on the stored A (no
        stored transpose), or block-ELL SpMV of the pre-transposed pack."""
        if not self.use_bell:
            return gemv_cols(mats.A, y)
        bell = mats.bell
        return bell_spmv(bell.At_blocks, bell.At_cols, y)[: self.n]

    def _Px(self, mats: Mats, x):
        """P @ x — dense, or block-ELL SpMV (P is symmetric: one pack
        serves both orientations)."""
        if not self.use_bell:
            return gemv_rows(mats.P, x)
        pb = mats.pbell
        return bell_spmv(pb.blocks, pb.cols, x)[: self.n]

    def _matvec_S(self, mats: Mats, dy, x):
        out = self.stg.rho_x * x + self._ATy(mats, dy * self._Ax(mats, x))
        if self.has_P:
            out = out + self._Px(mats, x)
        return out

    # -- compensated operators of the high-accuracy mode: the same bytes as
    # the plain ones, ~1-ulp f32 results (ops/df32.py); the plain operators
    # when hi_acc is off. Written over the last axes, so the batched core
    # shares them (its _Ax/_ATy/_Px and mats carry the batch axis).

    def _Ax_hi(self, mats: Mats, x):
        if not self.hi_acc:
            return self._Ax(mats, x)
        return df32.mv(mats.A, x)

    def _ATy_hi(self, mats: Mats, y):
        if not self.hi_acc:
            return self._ATy(mats, y)
        return df32.tv(mats.A, y)

    def _Px_hi(self, mats: Mats, x):
        if not self.has_P:
            return torch.zeros_like(x)
        if not self.hi_acc:
            return self._Px(mats, x)
        return df32.mv(mats.P, x)

    def _dot_hi(self, a, b):
        if not self.hi_acc:
            return torch.dot(a, b)
        return df32.dot(a, b)

    def _matvec_S_hi(self, mats: Mats, dy, x):
        out = self.stg.rho_x * x + self._ATy_hi(mats, dy * self._Ax_hi(mats, x))
        if self.has_P:
            out = out + self._Px_hi(mats, x)
        return out

    def _build_S(self, mats: Mats, dy):
        """S = rho_x*I + P + A' D_y A as one full-f32 (TF32 off) library
        product; a plain large product outside any kernel, as in scs_tpu.
        Written over the last two axes, so the batched core shares it."""
        A = mats.A
        with _no_tf32():
            S = A.mT @ (A * dy[..., :, None])
        S.diagonal(dim1=-2, dim2=-1).add_(self.stg.rho_x)
        if self.has_P:
            S += mats.P
        return S

    def _diagS(self, mats: Mats, dy, scale):
        """diag(S) for the Jacobi preconditioner. Dense A: the weighted
        column sums of A*A. Bell: dy takes exactly two values (see _ry),
        scale on ordinary rows and scale/ZERO_CONE_RY_FACTOR on zero-cone
        rows, so the sums reduce to two precomputed vectors."""
        if not self.use_bell:
            A = mats.A
            diagS = self.stg.rho_x + (A * A * dy[..., :, None]).sum(-2)
            if self.has_P:
                diagS = diagS + mats.P.diagonal(dim1=-2, dim2=-1)
            return diagS
        bell = mats.bell
        diagS = (
            self.stg.rho_x
            + scale * (bell.colsq_all - bell.colsq_zero)
            + (scale / ZERO_CONE_RY_FACTOR) * bell.colsq_zero
        )
        if self.has_P:
            diagS = diagS + mats.pbell.diag
        return diagS

    def _cg(self, mats, dy, rhs, x0, tol, scale):
        """Jacobi-preconditioned CG on S x = rhs (reference:
        linsys/cpu/indirect/private.c). Returns (x, iterations).

        Stop rules are scs_tpu's: the residual norm reaches `tol`, the
        cg_max_iters cap, or 12 consecutive iterations without a new
        best-so-far residual (||r|| is not monotone in CG; in f32 the
        achievable residual floors at ~cond(S)*eps*||rhs||, and without
        this exit a tolerance below that plateau would burn cg_max_iters
        on every solve). One device read per iteration carries both tests.
        """
        Minv = 1.0 / self._diagS(mats, dy, scale)
        x = x0
        r = rhs - self._matvec_S(mats, dy, x)
        z = Minv * r
        p = z
        rz = torch.dot(r, z)
        best = _norm(r)
        go = bool(best > tol)
        k = stall = 0
        while go and k < self.stg.cg_max_iters and stall < 12:
            Ap = self._matvec_S(mats, dy, p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Minv * r
            rz_new = torch.dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            rnrm = _norm(r)
            go, improved = torch.stack([rnrm > tol, rnrm < 0.99 * best]).tolist()
            stall = 0 if improved else stall + 1
            best = torch.minimum(best, rnrm)
            k += 1
        return x, k

    def _apply_factor(self, L, r):
        """S^-1 r from the factor slot: one dense matvec when L holds S^-1
        ("inverse"), two triangular solves when it holds the Cholesky
        factor."""
        if self.use_inverse:
            return gemv_rows(L, r)
        return _cholesky_solve(r[..., None], L, "factor_solve")[..., 0]

    def _direct_solve(self, mats: Mats, L, dy, rhs):
        """S^-1 rhs by the factor, then refine_steps passes of iterative
        refinement: an f32 factor solve carries an O(cond(S)*eps) error that
        floors the DR residual, and one pass restores ~roundoff accuracy
        for one extra S matvec and factor apply. In high-accuracy mode the
        refinement residual is compensated, so the solve converges to ~1 ulp
        rather than cond(S)*eps_f32."""
        x = self._apply_factor(L, rhs)
        for _ in range(self.refine_steps):
            x = x + self._apply_factor(L, rhs - self._matvec_S_hi(mats, dy, x))
        return x

    def _lin_solve(self, state: State, mats: Mats, rhs, tol):
        """Solve S x = rhs with the active strategy: CG warm-started at the
        previous solution, or the cached factor. Returns (x, cg_iters)."""
        dy = 1.0 / self._ry(state.scale)
        if self.indirect:
            return self._cg(mats, dy, rhs, state.px_warm, tol, state.scale)
        # no CG iterations: a zero of cg_iters' own kind (int, or per row)
        return self._direct_solve(mats, state.L, dy, rhs), 0 * state.cg_iters

    # -- setup ------------------------------------------------------------

    def _factorize(self, mats: Mats, scale):
        """Numeric factorization for the given scale — the expensive,
        (b, c)-independent half of setup, reused across solves and updates.
        Cholesky and the triangular solves are library routines, as in
        scs_tpu. A factorization that fails (S not positive definite in the
        working precision) fills the slot with NaN, as jnp.linalg.cholesky
        does, and the status logic reports the solve as failed. Written over
        the last two axes, so the batched core shares it; counted in
        `self.factorizations`."""
        if self.indirect:
            return torch.zeros(scale.shape + (0, 0), dtype=self.dtype, device=self.device)
        self.factorizations += 1
        dy = 1.0 / self._ry(scale)
        S = self._build_S(mats, dy)
        L, info = torch.linalg.cholesky_ex(S)
        del S
        if self.use_inverse:
            # L := S^-1 (SPD, equilibrated; one-time n^3, then matvecs)
            eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
            with _no_tf32():
                L = _cholesky_solve(eye.expand_as(L), L, "factorize")
            if not L.is_contiguous():
                # the library may hand the solve back column-major; S^-1 is
                # symmetric, so its transposed view is the same matrix (to
                # rounding) in the row-major layout gemv_rows reads
                L = L.mT if L.mT.is_contiguous() else L.contiguous()
        return L.masked_fill_((info != 0)[..., None, None], math.nan)

    factorizations = 0  # factorizations run by this core (tests count them)

    def _compute_g(self, mats: Mats, scale, L):
        """g = solve(S, c - A' D_y b) and its y image — the (b, c)-
        dependent half of setup, recomputed on update(b, c) while the factor
        L is reused."""
        dy = 1.0 / self._ry(scale)
        rhs = mats.cn - self._ATy_hi(mats, dy * mats.bn)
        if self.indirect:
            tol = torch.clamp_min(self.eps_floor * _norm(rhs), self.stg.cg_tol_min * 10)
            gx, _ = self._cg(
                mats, dy, rhs,
                torch.zeros(self.n, dtype=self.dtype, device=self.device),
                tol, scale,
            )
        else:
            # g enters every iterate via the tau update, so its solve error
            # floors the achievable residual: refined like the per-
            # iteration solves (compensated residuals in high-accuracy mode)
            gx = self._direct_solve(mats, L, dy, rhs)
        gy = dy * (mats.bn + self._Ax_hi(mats, gx))
        return gx, gy

    def _setup(self, mats: Mats, scale):
        """Factorize (direct; the empty slot under CG) and compute g for
        the given scale."""
        L = self._factorize(mats, scale)
        gx, gy = self._compute_g(mats, scale, L)
        return L, gx, gy

    def _init_pure(self, mats: Mats):
        """Cold-start state."""
        scale = self._scalar(self.stg.scale)
        L, gx, gy = self._setup(mats, scale)
        return self._fresh_state(L, gx, gy, scale)

    def _fresh_state(self, L, gx, gy, scale):
        N = self.N

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        u = zeros(N)
        u[-1] = 1.0
        v = zeros(N)
        w = u + v
        Lb = max(self.lookback, 1)
        nanv = self._scalar(math.nan)
        aa = AAState(
            dX=zeros(Lb, N),
            dF=zeros(Lb, N),
            zeta_prev=w,
            f_prev=zeros(N),
            count=-1,
            n_accept=0,
            n_reject_nonfinite=0,
            n_reject_weight_cap=0,
            n_safeguard_reject=0,
            last_aa_norm=nanv,
            last_reg=self._scalar(0.0),
            aa_iter=0,
        )
        diag = Diag(*([nanv] * len(Diag._fields)))
        return State(
            w=w,
            u=u,
            v=v,
            u_sum=zeros(N),
            v_sum=zeros(N),
            avg_cnt=0.0,
            scale=scale,
            L=L,
            gx=gx,
            gy=gy,
            px_warm=zeros(self.n),
            it=0,
            status=UNFINISHED,
            scale_updates=0,
            since_rescale=0,
            cg_iters=0,
            diff_u_ut_2=nanv,
            diff_u_ut_inf=nanv,
            diff_v_2=nanv,
            diff_v_inf=nanv,
            diag=diag,
            aa=aa,
        )

    def init_state(self, mats: Mats, warm_u=None, warm_v=None):
        return self.with_warm(self._init_pure(mats), warm_u, warm_v)

    def init_from_factor(self, mats: Mats, L):
        """Fresh state reusing the factorization L, which does not depend
        on (b, c) — the update(b, c) path: only g is recomputed."""
        scale = self._scalar(self.stg.scale)
        gx, gy = self._compute_g(mats, scale, L)
        return self._fresh_state(L, gx, gy, scale)

    @staticmethod
    def with_warm(state0: State, warm_u=None, warm_v=None):
        """Overlay a warm (u, v) onto a cold-start state (its g is reused
        as-is)."""
        if warm_u is None:
            return state0
        like = state0.u
        u = torch.as_tensor(warm_u, dtype=like.dtype, device=like.device)
        v = torch.as_tensor(warm_v, dtype=like.dtype, device=like.device)
        w = u + v
        return state0._replace(
            w=w,
            u=u,
            v=v,
            aa=state0.aa._replace(zeta_prev=w),
        )

    # -- one DR iteration -------------------------------------------------

    def _step(self, state: State, mats: Mats):
        """One relaxed DR step on w:
        u_t = (R+Q)^-1 R w;  u = Pi_C(2 u_t - w);  w+ = w + alpha(u - u_t).
        Split into _step_lin (linear projection incl. tau recovery — the
        reference's lin_sys phase) and _step_cone (reflection + cone
        projection + dual update — the cone phase)."""
        return self._step_cone(state, *self._step_lin(state, mats), mats)

    def _step_lin(self, state: State, mats: Mats):
        n, m = self.n, self.m
        stg = self.stg
        w = state.w
        wx, wy, wtau = w[:n], w[n : n + m], w[-1]

        ry = self._ry(state.scale)
        dy = 1.0 / ry

        rhs = stg.rho_x * wx - self._ATy(mats, wy)
        # CG tolerance (inexact-Krylov schedule, scs_tpu's): tracks the
        # previous DR step size ||u - u_t||, capped at 1e-3*||rhs||,
        # tightened by (it+1)^-cg_rate, floored by the dtype's reach.
        npd = np.float64 if self.dtype == torch.float64 else np.float32
        sched = float(min(npd(1.0), npd(state.it + 1.0) ** npd(-stg.cg_rate) * npd(1e3)))
        prev_step = torch.where(
            torch.isfinite(state.diff_u_ut_2), state.diff_u_ut_2, 1.0
        )
        rhs_nrm = _norm(rhs)
        tol = torch.maximum(
            torch.clamp_min(self.eps_floor * rhs_nrm, stg.cg_tol_min),
            torch.minimum(1e-3 * rhs_nrm, stg.cg_tol_factor * prev_step * sched),
        )
        px, cg_k = self._lin_solve(state, mats, rhs, tol)
        py = wy + dy * self._Ax(mats, px)

        gx, gy = state.gx, state.gy
        a = 1.0 + stg.rho_x * torch.dot(gx, gx) + torch.dot(gy * ry, gy)
        hp = torch.dot(mats.cn, px) + torch.dot(mats.bn, py)
        if self.has_P:
            Ppx = self._Px(mats, px)
            bq = -wtau - hp + 2.0 * torch.dot(gx, Ppx)
            cq = -torch.dot(px, Ppx)
            disc = torch.clamp_min(bq * bq - 4.0 * a * cq, 0.0)
            tau = (-bq + torch.sqrt(disc)) / (2.0 * a)
        else:
            bq = -wtau - hp
            tau = -bq / a
        tau = torch.clamp_min(tau, 0.0)

        ut = torch.cat([px - tau * gx, py - tau * gy, tau[None]])
        return ut, px, cg_k

    def _step_cone(self, state: State, ut, px, cg_k, mats: Mats):
        n, m = self.n, self.m
        w = state.w
        refl = 2.0 * ut - w
        uy = refl[n : n + m] + self._proj(-refl[n : n + m], mats.bl, mats.bu)
        u_new = torch.cat([refl[:n], uy, torch.clamp_min(refl[-1], 0.0)[None]])
        w_new = w + self.stg.alpha * (u_new - ut)
        v_new = w_new - u_new

        du = u_new - ut
        dv = v_new - state.v
        return state._replace(
            w=w_new,
            u=u_new,
            v=v_new,
            px_warm=px,
            cg_iters=state.cg_iters + cg_k,
            diff_u_ut_2=_norm(du),
            diff_u_ut_inf=torch.max(torch.abs(du)),
            diff_v_2=_norm(dv),
            diff_v_inf=torch.max(torch.abs(dv)),
        )

    # -- Anderson acceleration (reference: src/aa.c) ----------------------

    def _aa_push(self, aa: AAState, zeta, f):
        dX, dF = aa.dX, aa.dF
        if aa.count >= 0:
            slot = aa.count % max(self.lookback, 1)
            dX, dF = dX.clone(), dF.clone()
            dX[slot] = zeta - aa.zeta_prev
            dF[slot] = f - aa.f_prev
        return aa._replace(
            dX=dX, dF=dF, zeta_prev=zeta, f_prev=f, count=aa.count + 1
        )

    def _aa_candidate(self, aa: AAState, zeta, f):
        """The AA candidate point from the ring buffers (scs_tpu's math:
        residual-normalized units, so the Tikhonov regularization is
        relative to the Gram magnitude; a PSD Cholesky solve of the small
        L x L system). The Gram products run with TF32 off."""
        stg = self.stg
        s = _norm(f) + 1e-300  # rounds to 0 in f32, as in scs_tpu
        dX, dF = aa.dX / s, aa.dF / s
        fs = f / s
        with _no_tf32():
            if stg.acceleration_type_1:
                M = dX @ dF.T  # (L, L) type-I mixed Gram (nonsymmetric)
                rhs0 = dX @ fs
                reg = stg.acceleration_regularization * (
                    1.0 + torch.trace(torch.abs(M))
                )
                G = M.T @ M  # regularized least squares
                G.diagonal().add_(reg * reg)
                rhs = M.T @ rhs0
            else:
                G = dF @ dF.T  # type-II Gram (PSD)
                reg = stg.acceleration_regularization * (1.0 + torch.trace(G))
                G.diagonal().add_(reg)
                rhs = dF @ fs
            # a failed factorization yields NaN, as jnp.linalg.cholesky
            # does, so the trial is rejected as non-finite downstream
            chol, info = torch.linalg.cholesky_ex(G)
            gamma = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
            gamma = torch.where(info == 0, gamma, math.nan)
            beta = stg.acceleration_relaxation
            cand = zeta - gamma @ aa.dX + beta * (f - gamma @ aa.dF)
        return cand, gamma, reg

    def _iter_body(self, state: State, mats: Mats):
        """One iteration: plain step, AA bookkeeping, periodic AA trial.
        (scs_tpu's trial-free `_iter_plain` exists because a traced cond
        runs both branches under vmap; here the trial is a host `if`, so
        this one body serves every iteration.)"""
        st1 = self._step(state, mats)
        return self._iter_tail(state, st1, mats)

    def _iter_tail(self, state: State, st1: State, mats: Mats):
        """AA bookkeeping + periodic trial, given the plain-step result."""
        zeta = state.w
        f = st1.w - zeta  # fixed-point residual of the DR map at w

        def accumulate(st):
            return st._replace(
                it=state.it + 1,
                u_sum=state.u_sum + st.u,
                v_sum=state.v_sum + st.v,
                avg_cnt=state.avg_cnt + 1.0,
            )

        if self.lookback == 0:
            return accumulate(st1)

        aa = self._aa_push(state.aa, zeta, f)
        if not ((state.it + 1) % self.interval == 0 and aa.count >= 1):
            return accumulate(st1._replace(aa=aa))

        cand, gamma, reg = self._aa_candidate(aa, zeta, f)
        # The DR map is positively homogeneous, so rescale the candidate
        # back to the current iterate's norm (exact by homogeneity) to keep
        # the safeguard comparison scale-fair.
        cand = cand * (_norm(zeta) / torch.clamp_min(_norm(cand), 1e-300))
        finite = torch.all(torch.isfinite(cand))
        weight_ok = torch.sum(torch.abs(gamma)) < 1e6
        # safeguard: evaluate the map at the candidate and compare
        # fixed-point residuals
        st2 = self._step(st1._replace(w=cand), mats)
        f_cand = st2.w - cand
        aa_norm = _norm(f_cand)
        safe = aa_norm <= self.stg.aa_safeguard_factor * _norm(f)
        finite, weight_ok, safe = torch.stack([finite, weight_ok, safe]).tolist()
        accept = finite and weight_ok and safe

        new_state = st2 if accept else st1
        if self.stg.aa_reset_on_reject and not accept:
            # a rejected candidate means the memory spans a bad direction;
            # clear it so the next window starts clean
            aa = aa._replace(
                count=-1,
                dX=torch.zeros_like(aa.dX),
                dF=torch.zeros_like(aa.dF),
            )
        aa = aa._replace(
            n_accept=aa.n_accept + int(accept),
            n_reject_nonfinite=aa.n_reject_nonfinite + int(not finite),
            n_reject_weight_cap=aa.n_reject_weight_cap
            + int(finite and not weight_ok),
            n_safeguard_reject=aa.n_safeguard_reject
            + int(finite and weight_ok and not safe),
            last_aa_norm=aa_norm,
            last_reg=reg,
            aa_iter=aa.aa_iter + 1,
            # acceptance moved the base point; reset the delta anchor
            zeta_prev=cand if accept else aa.zeta_prev,
            f_prev=f_cand if accept else aa.f_prev,
        )
        return accumulate(new_state._replace(aa=aa))

    # -- residuals / termination ------------------------------------------

    def _residuals(self, state: State, mats: Mats):
        n, m = self.n, self.m
        u, v = state.u, state.v
        xbar, ybar, tau = u[:n], u[n : n + m], u[-1]
        ry = self._ry(state.scale)
        st_hat = ry * v[n : n + m]  # = tau * normalized slack

        # compensated in high-accuracy mode: a plain f32 matvec's evaluation
        # noise would exceed the tolerance it is held to
        Axb = self._Ax_hi(mats, xbar)
        Aty = self._ATy_hi(mats, ybar)
        Pxb = self._Px_hi(mats, xbar)

        Dinv = 1.0 / mats.D
        Einv = 1.0 / mats.E
        sc_b, sc_c = mats.sc_b, mats.sc_c
        inf = math.inf

        safe_tau = torch.clamp_min(tau, 1e-300)

        # --- primal/dual residuals (un-normalized, divided by tau)
        rp_hat = Axb + st_hat - mats.bn * tau  # normalized, homogeneous
        rd_hat = Pxb + Aty + mats.cn * tau
        rp_vec = Dinv * rp_hat / (sc_b * safe_tau)
        rd_vec = Einv * rd_hat / (sc_c * safe_tau)
        res_pri = _norm(rp_vec)
        res_dual = _norm(rd_vec)

        # homogeneous residual norms, original units (CSV ax_s_btau_nrm_*)
        ax_s_btau_2 = res_pri * safe_tau
        ax_s_btau_inf = torch.max(torch.abs(rp_vec)) * safe_tau
        px_aty_ctau_2 = res_dual * safe_tau
        px_aty_ctau_inf = torch.max(torch.abs(rd_vec)) * safe_tau
        # normalized-space variants (equilibrated data, CSV *_normalized)
        ax2_n = _norm(rp_hat)
        axinf_n = torch.max(torch.abs(rp_hat))
        px2_n = _norm(rd_hat)
        pxinf_n = torch.max(torch.abs(rd_hat))

        nAx = _norm(Dinv * Axb) / (sc_b * safe_tau)
        ns = _norm(Dinv * st_hat) / (sc_b * safe_tau)
        nPx = _norm(Einv * Pxb) / (sc_c * safe_tau)
        nAty = _norm(Einv * Aty) / (sc_c * safe_tau)

        ctx = self._dot_hi(mats.cn, xbar) / (sc_c * sc_b * safe_tau)
        bty = self._dot_hi(mats.bn, ybar) / (sc_b * sc_c * safe_tau)
        xPx = self._dot_hi(xbar, Pxb) / (sc_b * sc_c * safe_tau**2)
        gap = torch.abs(xPx + ctx + bty)
        pobj = 0.5 * xPx + ctx
        dobj = -0.5 * xPx - bty
        comp_slack = torch.abs(torch.dot(st_hat, ybar)) / (sc_b * sc_c * safe_tau**2)

        # --- certificates (tau-free, normalized to b'y=-1 / c'x=-1)
        bty_raw = torch.dot(mats.bn, ybar) / (sc_b * sc_c)
        ctx_raw = torch.dot(mats.cn, xbar) / (sc_c * sc_b)
        nAty_raw = _norm(Einv * Aty) / sc_c
        res_infeas = torch.where(
            bty_raw < 0,
            mats.norm_b * nAty_raw / torch.clamp_min(-bty_raw, 1e-300),
            inf,
        )
        nAxs_raw = _norm(Dinv * (Axb + st_hat)) / sc_b
        nPx_raw = _norm(Einv * Pxb) / sc_c
        res_unbdd_a = torch.where(
            ctx_raw < 0,
            mats.norm_c * nAxs_raw / torch.clamp_min(-ctx_raw, 1e-300),
            inf,
        )
        no_P = torch.where(ctx_raw < 0, 0.0, torch.full_like(ctx_raw, inf))
        res_unbdd_p = torch.where(
            ctx_raw < 0,
            mats.norm_c * nPx_raw / torch.clamp_min(-ctx_raw, 1e-300),
            inf,
        ) if self.has_P else no_P

        # --- normalized-space (equilibrated data) diagnostics. After
        # equilibration ||bn|| = ||cn|| = 1, so the certificate residuals
        # need no norm factors.
        ctx_hat = torch.dot(mats.cn, xbar)
        bty_hat = torch.dot(mats.bn, ybar)
        xPx_hat = torch.dot(xbar, Pxb)
        res_pri_norm = ax2_n / safe_tau
        res_dual_norm = px2_n / safe_tau
        pobj_norm = 0.5 * xPx_hat / safe_tau**2 + ctx_hat / safe_tau
        dobj_norm = -0.5 * xPx_hat / safe_tau**2 - bty_hat / safe_tau
        gap_norm = torch.abs(
            xPx_hat / safe_tau**2 + ctx_hat / safe_tau + bty_hat / safe_tau
        )
        res_infeas_norm = torch.where(
            bty_hat < 0,
            _norm(Aty) / torch.clamp_min(-bty_hat, 1e-300),
            inf,
        )
        res_unbdd_a_norm = torch.where(
            ctx_hat < 0,
            _norm(Axb + st_hat) / torch.clamp_min(-ctx_hat, 1e-300),
            inf,
        )
        no_P_hat = torch.where(ctx_hat < 0, 0.0, torch.full_like(ctx_hat, inf))
        res_unbdd_p_norm = torch.where(
            ctx_hat < 0,
            _norm(Pxb) / torch.clamp_min(-ctx_hat, 1e-300),
            inf,
        ) if self.has_P else no_P_hat

        diag = Diag(
            res_pri=res_pri,
            res_dual=res_dual,
            gap=gap,
            pobj=pobj,
            dobj=dobj,
            res_infeas=res_infeas,
            res_unbdd_a=res_unbdd_a,
            res_unbdd_p=res_unbdd_p,
            comp_slack=comp_slack,
            ax_s_btau_2=ax_s_btau_2,
            ax_s_btau_inf=ax_s_btau_inf,
            px_aty_ctau_2=px_aty_ctau_2,
            px_aty_ctau_inf=px_aty_ctau_inf,
            res_pri_norm=res_pri_norm,
            res_dual_norm=res_dual_norm,
            gap_norm=gap_norm,
            pobj_norm=pobj_norm,
            dobj_norm=dobj_norm,
            ax_s_btau_2_norm=ax2_n,
            ax_s_btau_inf_norm=axinf_n,
            px_aty_ctau_2_norm=px2_n,
            px_aty_ctau_inf_norm=pxinf_n,
            res_infeas_norm=res_infeas_norm,
            res_unbdd_a_norm=res_unbdd_a_norm,
            res_unbdd_p_norm=res_unbdd_p_norm,
        )
        denoms = (nAx, ns, nPx, nAty)
        return diag, denoms, (ctx, bty, xPx)

    def _status_from(self, diag: Diag, denoms, scalars, norm_b, norm_c, eps_mult=1.0):
        """Termination status as a 0-d int32 device tensor."""
        stg = self.stg
        nAx, ns, nPx, nAty = denoms
        ctx, bty, xPx = scalars
        eps_abs = stg.eps_abs * eps_mult
        eps_rel = stg.eps_rel * eps_mult
        eps_infeas = stg.eps_infeas * eps_mult
        mx = torch.maximum

        solved = (
            (diag.res_pri <= eps_abs + eps_rel * mx(mx(nAx, ns), norm_b))
            & (diag.res_dual <= eps_abs + eps_rel * mx(mx(nPx, nAty), norm_c))
            & (
                diag.gap
                <= eps_abs
                + eps_rel * mx(mx(torch.abs(xPx), torch.abs(ctx)), torch.abs(bty))
            )
        )
        infeas = diag.res_infeas < eps_infeas
        unbdd = mx(diag.res_unbdd_a, diag.res_unbdd_p) < eps_infeas

        status = torch.full((), UNFINISHED, dtype=torch.int32, device=self.device)
        status = torch.where(unbdd, UNBOUNDED, status)
        status = torch.where(infeas, INFEASIBLE, status)
        return torch.where(solved, SOLVED, status)

    def _check(self, state: State, mats: Mats):
        """Residuals + termination + adaptive scale (with the new g)."""
        # Renormalize the iterate to a fixed reference norm: exact by the
        # positive homogeneity of the DR map; prevents drift of the
        # iterate scale along the embedding's ray of fixed points.
        nrm = _norm(state.w)
        t = torch.where(
            torch.isfinite(nrm) & (nrm > 0), math.sqrt(self.N) / nrm, 1.0
        )
        aa = state.aa
        state = state._replace(
            w=state.w * t,
            u=state.u * t,
            v=state.v * t,
            u_sum=state.u_sum * t,
            v_sum=state.v_sum * t,
            px_warm=state.px_warm * t,
            aa=aa._replace(
                dX=aa.dX * t,
                dF=aa.dF * t,
                zeta_prev=aa.zeta_prev * t,
                f_prev=aa.f_prev * t,
            ),
        )
        diag, denoms, scalars = self._residuals(state, mats)
        status = self._status_from(diag, denoms, scalars, mats.norm_b, mats.norm_c)
        bad = ~torch.all(torch.isfinite(state.u))
        status = int(torch.where(bad, FAILED, status))
        state = state._replace(diag=diag, status=status)

        # ergodic candidate: if the pointwise iterate has not terminated,
        # test the running average (converges O(1/k) even when the
        # pointwise DR iterate wanders in a slow limit band)
        if status == UNFINISHED and state.avg_cnt > 50.0:
            cnt = max(state.avg_cnt, 1.0)
            ua = state.u_sum / cnt
            st_a = state._replace(u=ua, v=state.v_sum / cnt)
            diag_a, denoms_a, scalars_a = self._residuals(st_a, mats)
            status_a = self._status_from(
                diag_a, denoms_a, scalars_a, mats.norm_b, mats.norm_c
            )
            status_a, finite = torch.stack(
                [status_a, torch.all(torch.isfinite(ua)).to(torch.int32)]
            ).tolist()
            if status_a != UNFINISHED and finite:
                state = st_a._replace(diag=diag_a, status=status_a)

        # doubling-window restart: keep the average over (roughly) the most
        # recent half of the iterations so the early transient washes out
        if state.status == UNFINISHED and 2.0 * state.avg_cnt > state.it:
            state = state._replace(
                u_sum=torch.zeros_like(state.u_sum),
                v_sum=torch.zeros_like(state.v_sum),
                avg_cnt=0.0,
            )

        if not self.stg.adaptive_scale:
            return state._replace(since_rescale=state.since_rescale + 1)
        ratio, trigger = self._rescale_ratio_trigger(state, mats, diag, denoms)
        return self._apply_rescale(state, mats, ratio, trigger)

    def _rescale_ratio_trigger(self, state: State, mats: Mats, diag, denoms):
        """Adaptive-scale decision: the primal/dual relative-residual ratio
        and whether an update is due (read from the device only when the
        host-side conditions hold)."""
        stg = self.stg
        nAx, ns, nPx, nAty = denoms
        mx = torch.maximum
        denom_p = stg.eps_abs + stg.eps_rel * mx(mx(nAx, ns), mats.norm_b)
        denom_d = stg.eps_abs + stg.eps_rel * mx(mx(nPx, nAty), mats.norm_c)
        rp_rel = diag.res_pri / torch.clamp_min(denom_p, 1e-300)
        rd_rel = diag.res_dual / torch.clamp_min(denom_d, 1e-300)
        ratio = torch.sqrt(
            torch.clamp_min(rp_rel, 1e-300) / torch.clamp_min(rd_rel, 1e-300)
        )
        # annealed update interval: frequent early, rare late (each update
        # restarts the DR transient and the AA memory)
        min_gap = max(stg.rescale_min_iters, state.it // 4)
        trigger = (
            (state.since_rescale + 1) * stg.check_interval >= min_gap
            and state.status == UNFINISHED
            and bool(
                ((ratio > stg.rescale_factor_band)
                 | (ratio < 1.0 / stg.rescale_factor_band))
                & torch.isfinite(ratio)
            )
        )
        return ratio, trigger

    def _apply_rescale(self, state: State, mats: Mats, ratio, trigger):
        if not trigger:
            return state._replace(since_rescale=state.since_rescale + 1)
        stg = self.stg
        new_scale = torch.clamp(state.scale * ratio, stg.min_scale, stg.max_scale)
        L, gx, gy = self._setup(mats, new_scale)
        n, m = self.n, self.m
        f = new_scale / state.scale
        # keep the slack s_hat = ry*v_y invariant across the metric change
        v = state.v.clone()
        v[n : n + m] *= f
        w = state.u + v  # w = u + v by construction (v = w - u)
        # the average lives in original coordinates; only v's y block is
        # metric-dependent — rescale it like v itself
        v_sum = state.v_sum.clone()
        v_sum[n : n + m] *= f
        return state._replace(
            scale=new_scale,
            L=L,
            gx=gx,
            gy=gy,
            v=v,
            w=w,
            v_sum=v_sum,
            scale_updates=state.scale_updates + 1,
            since_rescale=0,
            aa=state.aa._replace(count=-1, zeta_prev=w),
        )

    # -- chunked execution -------------------------------------------------

    def _chunk(self, state: State, mats: Mats):
        """check_interval iterations, then one check."""
        for _ in range(self.stg.check_interval):
            state = self._iter_body(state, mats)
        return self._check(state, mats)

    # -- finalization ------------------------------------------------------

    def _finalize(self, state: State, mats: Mats):
        """Extract (x, y, s) in original units + relaxed-tolerance status.

        Returns tensors for all three candidate interpretations (solution,
        infeasibility and unboundedness certificates); the caller picks by
        status. `relaxed` is a host int."""
        n, m = self.n, self.m

        # on exhaustion the ergodic average may be the better candidate
        if state.status == UNFINISHED and state.avg_cnt > 50.0:

            def score(st):
                d, _, _ = self._residuals(st, mats)
                return d.res_pri + d.res_dual + d.gap

            cnt = max(state.avg_cnt, 1.0)
            st_a = state._replace(u=state.u_sum / cnt, v=state.v_sum / cnt)
            better = torch.all(torch.isfinite(st_a.u)) & (score(st_a) < score(state))
            if bool(better):
                state = st_a

        u, v = state.u, state.v
        xbar, ybar, tau = u[:n], u[n : n + m], u[-1]
        ry = self._ry(state.scale)
        st_hat = ry * v[n : n + m]
        Dinv = 1.0 / mats.D
        safe_tau = torch.clamp_min(tau, 1e-300)

        x = mats.E * xbar / (mats.sc_b * safe_tau)
        y = mats.D * ybar / (mats.sc_c * safe_tau)
        s = Dinv * st_hat / (mats.sc_b * safe_tau)

        # certificates normalized to b'y = -1 / c'x = -1
        bty_raw = torch.dot(mats.bn, ybar) / (mats.sc_b * mats.sc_c)
        ctx_raw = torch.dot(mats.cn, xbar) / (mats.sc_c * mats.sc_b)
        y_cert = (mats.D * ybar / mats.sc_c) / torch.clamp_min(-bty_raw, 1e-300)
        x_cert = (mats.E * xbar / mats.sc_b) / torch.clamp_min(-ctx_raw, 1e-300)
        s_cert = (Dinv * st_hat / mats.sc_b) / torch.clamp_min(-ctx_raw, 1e-300)

        # relaxed-status evaluation for *_inaccurate classification
        diag, denoms, scalars = self._residuals(state, mats)
        relaxed = int(self._status_from(
            diag, denoms, scalars, mats.norm_b, mats.norm_c, eps_mult=1e3
        ))
        return x, y, s, x_cert, y_cert, s_cert, relaxed, diag

    def _probe(self, state: State):
        """Every host-consumed scalar of one check in ONE device read, in
        scs_tpu's order (consumed by api.SCS._write_csv_row and the
        verbose line). Returns a float64 numpy array."""
        d = state.diag
        dev = [
            d.res_pri, d.res_dual, d.gap, d.pobj, d.dobj, state.scale,
            d.ax_s_btau_inf, d.px_aty_ctau_inf, d.ax_s_btau_2,
            d.px_aty_ctau_2, d.res_infeas, d.res_unbdd_a, d.res_unbdd_p,
            state.u[-1], state.v[-1],
            d.res_pri_norm, d.res_dual_norm, d.gap_norm,
            d.ax_s_btau_inf_norm, d.px_aty_ctau_inf_norm,
            d.ax_s_btau_2_norm, d.px_aty_ctau_2_norm,
            d.res_infeas_norm, d.res_unbdd_a_norm, d.res_unbdd_p_norm,
            d.pobj_norm, d.dobj_norm,
            state.diff_u_ut_2, state.diff_v_2, state.diff_u_ut_inf,
            state.diff_v_inf, state.aa.last_aa_norm,
        ]
        vals = torch.stack(dev).tolist()
        return np.asarray([state.it, state.status, *vals], np.float64)

    # -- per-phase timing ---------------------------------------------------

    def _doctored_trial_state(self, state: State):
        """State altered so _iter_tail FIRES the AA trial."""
        return state._replace(
            it=max(self.interval - 1, 0),
            aa=state.aa._replace(count=2),
        )

    def _phase_round(self, st: State, mats: Mats):
        """One round of the instrumented loop's sequence from `st`: the
        linear step, the cone step and the iteration tail, each timed to a
        device synchronize, then a check and the probe's read. The tail runs
        from `st` altered to fire the AA trial (its time is accel_trial) and
        to leave the scale alone in the check. Returns the three times in
        seconds; nothing of the solve changes."""
        pc = time.perf_counter
        trial = self._doctored_trial_state(st)._replace(since_rescale=-(1 << 62))
        times = np.zeros(3)
        ts = pc()
        lin = self._step_lin(st, mats)
        self._sync()
        times[0] = pc() - ts
        ts = pc()
        st1 = self._step_cone(st, *lin, mats)
        self._sync()
        times[1] = pc() - ts
        ts = pc()
        tail = self._iter_tail(trial, st1, mats)
        self._sync()
        times[2] = pc() - ts
        self._probe(self._check(tail, mats))
        return times

    def phase_sample(self, state: State, mats: Mats, weight):
        """One round (_phase_round) timed from a state of the running
        solve, standing for `weight` of its chunks: the pipelined loop's
        "auto" timers (api.SCS._pipelined_loop clears `_phase_samples` at
        its start)."""
        self._phase_samples.append((weight, self._phase_round(state, mats)))

    def phase_times(self, states, mats: Mats):
        """Measured per-call cost of each solver phase, in seconds:
        dict(lin_sys=, cone=, accel_trial=), in the instrumented loop's
        sequence (phase_timing="always"; _phase_round). After a pipelined
        solve that sampled rounds along its way (phase_sample), their mean
        weighted by the chunks each stands for: the host's speed drifts by
        tens of percent over seconds, and the instrumented loop's sums
        average it over the whole solve. Otherwise a snapshot, cached: from
        each of `states` (callers pass [initial, final] so the
        state-dependent CG cost is sampled at both ends of the tolerance
        schedule) one round to warm up, then 5 timed rounds. A phase timed
        alone, back to back, reads less host time than it takes in the
        loop, where it follows the other phases and a check
        (tools/timer_proto.py prints both estimates on the same states)."""
        if self._phase_samples:
            w = np.array([s[0] for s in self._phase_samples], np.float64)
            t = np.stack([s[1] for s in self._phase_samples])
            lin_sys, cone, accel = (float(v) for v in w @ t / w.sum())
        elif self._phase_cache is not None:
            return self._phase_cache
        else:
            if isinstance(states, State):
                states = [states]
            rounds = 5
            total = np.zeros(3)
            for st in states:
                for r in range(rounds + 1):
                    times = self._phase_round(st, mats)
                    if r:
                        total += times
            lin_sys, cone, accel = (float(t) for t in total / (len(states) * rounds))
        out = {
            "lin_sys": lin_sys,
            "cone": cone,
            "accel_trial": accel if self.lookback > 0 else 0.0,
        }
        if not self._phase_samples:
            self._phase_cache = out
        return out
