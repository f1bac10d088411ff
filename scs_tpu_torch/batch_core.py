"""Batched solver core: B same-shape problems in masked lockstep — the
PyTorch form of what `jax.vmap(Core)` gives scs_tpu's BatchedSCS
(scs_tpu/solver.py, scs_tpu/batch.py:162-241) — under the bell strategy
(sparse problems, batched block-ELL SpMV) or the dense strategies ("direct"
with a batched factor, "indirect" by batched CG) on a (B, m, n) batch.

Every tensor of the state carries a leading batch axis B, and every
per-problem decision is a (B,) mask:

  * a traced `lax.cond` (AA trial, its accept test, the ergodic average,
    the adaptive rescale) becomes both branches and a row-wise select,
    `_select`, as vmap computes it; the host skips a branch only when no
    row takes it, so the result is the same select;
  * a `lax.while_loop` (CG, the segment loop) becomes a host loop that
    runs while any row is active, with one device read per iteration for
    the whole batch; a finished row is carried through unchanged;
  * counters and statuses are int32 tensors of shape (B,) on the device
    (the single-problem Core keeps them as host ints; here each problem
    has its own).

No operation mixes rows: every reduction is over the last axis, and the
operator is the batched block-ELL SpMV (`ops.sparse.bell_spmv_batched`) or
the batched dense matvecs (`ops.dense.gemv_rows`/`gemv_cols`), each the CUDA
kernel on a card, so a row that computes 0/0 after it has finished cannot
disturb another.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import trace
from .cones import ConeSpec
from .info import FAILED, UNFINISHED
from .ops import df32
from .ops.projections import get_projector
from .ops.dense import gemv_cols, gemv_rows
from .ops.sparse import bell_spmv_batched
from .settings import Settings
from .solver import ZERO_CONE_RY_FACTOR, Core, Diag, Mats, _cholesky_solve, _no_tf32


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _amax(x):
    return x.abs().amax(-1)


def _col(v):
    """(B,) -> (B, 1), for per-problem scalars against (B, k) vectors."""
    return v[:, None]


def _select(mask, new, old):
    """Row-wise select over a NamedTuple tree: row b is new's where
    mask[b], old's otherwise — vmap's form of lax.cond and jnp.where."""
    if isinstance(new, tuple):
        return type(new)(*(_select(mask, a, b) for a, b in zip(new, old)))
    if new is old:
        return new
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


class AAState(NamedTuple):
    dX: torch.Tensor  # (B, L, N) ring buffers of w-iterate deltas
    dF: torch.Tensor  # (B, L, N) ring buffers of DR-residual deltas
    zeta_prev: torch.Tensor  # (B, N)
    f_prev: torch.Tensor  # (B, N)
    count: torch.Tensor  # (B,) int32: deltas pushed (-1 = empty)
    n_accept: torch.Tensor  # (B,) int32
    n_reject_nonfinite: torch.Tensor
    n_reject_weight_cap: torch.Tensor
    n_safeguard_reject: torch.Tensor
    last_aa_norm: torch.Tensor  # (B,)
    last_reg: torch.Tensor  # (B,)
    aa_iter: torch.Tensor  # (B,) int32


class State(NamedTuple):
    """scs_tpu's State with a leading batch axis."""

    w: torch.Tensor  # (B, N)
    u: torch.Tensor
    v: torch.Tensor
    u_sum: torch.Tensor
    v_sum: torch.Tensor
    avg_cnt: torch.Tensor  # (B,) iterations accumulated in the averages
    scale: torch.Tensor  # (B,)
    # (B, n, n): each problem's Cholesky factor of S (direct, "cholesky")
    # or S^-1 ("inverse"); the empty (B, 0, 0) slot under CG
    L: torch.Tensor
    gx: torch.Tensor  # (B, n)
    gy: torch.Tensor  # (B, m)
    px_warm: torch.Tensor  # (B, n)
    it: torch.Tensor  # (B,) int32
    status: torch.Tensor  # (B,) int32
    scale_updates: torch.Tensor  # (B,) int32
    since_rescale: torch.Tensor  # (B,) int32
    # adaptive-scale decision recorded by _check when rescale_in_chunk is
    # off; rescale_step applies it between segments
    rescale_ratio: torch.Tensor  # (B,)
    rescale_trigger: torch.Tensor  # (B,) bool
    cg_iters: torch.Tensor  # (B,) int32
    diff_u_ut_2: torch.Tensor  # (B,)
    diff_u_ut_inf: torch.Tensor
    diff_v_2: torch.Tensor
    diff_v_inf: torch.Tensor
    diag: Diag  # (B,) leaves
    aa: AAState


class BatchedCore:
    """Solver core for B problems sharing (m, n, cone structure, settings).
    Mats are solver.Mats with a leading batch axis on every leaf (packs
    (B, nbr, w, bs, bs), cols (B, nbr, w); dense A (B, m, n), P (B, n, n))."""

    # shape-agnostic helpers of the single-problem core, reused as they are
    _sync = Core._sync
    _init_strategy = Core._init_strategy
    _matvec_S = Core._matvec_S
    # the high-accuracy hooks; they dispatch to this class's operators
    _Ax_hi = Core._Ax_hi
    _ATy_hi = Core._ATy_hi
    _Px_hi = Core._Px_hi
    _matvec_S_hi = Core._matvec_S_hi
    _build_S = Core._build_S
    _factorize = Core._factorize
    _apply_factor = Core._apply_factor
    _direct_solve = Core._direct_solve
    _lin_solve = Core._lin_solve
    factorizations = 0  # batched factorizations run (tests count them)
    _step = Core._step
    _iter_body = Core._iter_body
    _status_from = Core._status_from  # (B,) leaves broadcast to a (B,) status

    def __init__(self, m, n, has_P, spec: ConeSpec, stg: Settings):
        self.m, self.n, self.has_P = m, n, has_P
        self.N = n + m + 1
        self.stg = stg
        self.device = torch.device(stg.device)
        self.dtype = torch.float64 if stg.dtype == "float64" else torch.float32
        self.spec = spec
        self._init_strategy(spec, stg)
        self.zero_mask = torch.as_tensor(spec.zero_row_mask(), device=self.device)
        trace.uploaded(self.device, "setup_upload")
        self.eps_floor = 3e-7 if self.dtype == torch.float32 else 1e-14
        self._proj = get_projector(spec, self.dtype)
        self.lookback = int(stg.acceleration_lookback)
        self.interval = int(stg.acceleration_interval)
        # off (BatchedSCS's default): _check records the rescale decision
        # and rescale_step applies it between segments, as in scs_tpu
        self.rescale_in_chunk = bool(stg.rescale_in_chunk)
        # batched CG iterations run (each one S-product for the whole
        # batch, i.e. 2 or 3 operator launches), setup included; callers
        # zero it
        self.cg_steps = 0

    def _ints(self, B, value):
        return torch.full((B,), value, dtype=torch.int32, device=self.device)

    # -- metric helpers and operators ---------------------------------------

    def _ry(self, scale):
        base = _col(1.0 / scale)
        return torch.where(self.zero_mask, ZERO_CONE_RY_FACTOR * base, base)

    def _Ax(self, mats: Mats, x):
        if not self.use_bell:
            return gemv_rows(mats.A, x)
        bell = mats.bell
        return bell_spmv_batched(bell.A_blocks, bell.A_cols, x)[:, : self.m]

    def _ATy(self, mats: Mats, y):
        if not self.use_bell:
            return gemv_cols(mats.A, y)
        bell = mats.bell
        return bell_spmv_batched(bell.At_blocks, bell.At_cols, y)[:, : self.n]

    def _Px(self, mats: Mats, x):
        if not self.use_bell:
            return gemv_rows(mats.P, x)
        pb = mats.pbell
        return bell_spmv_batched(pb.blocks, pb.cols, x)[:, : self.n]

    def _dot_hi(self, a, b):
        """Per-problem dot over the last axis, compensated in high-accuracy
        mode (Core._dot_hi)."""
        if not self.hi_acc:
            return _dot(a, b)
        return df32.dot(a, b)

    def _diagS(self, mats: Mats, dy, scale):
        """diag(S) per problem; the scale is (B,) (see Core._diagS)."""
        if not self.use_bell:
            return Core._diagS(self, mats, dy, scale)
        bell = mats.bell
        s = _col(scale)
        diagS = (
            self.stg.rho_x
            + s * (bell.colsq_all - bell.colsq_zero)
            + (s / ZERO_CONE_RY_FACTOR) * bell.colsq_zero
        )
        if self.has_P:
            diagS = diagS + mats.pbell.diag
        return diagS

    def _cg(self, mats, dy, rhs, x0, tol, scale, rows=None):
        """Jacobi-preconditioned CG on S_b x = rhs_b for every problem b,
        with scs_tpu's stop rules per problem: each row keeps its own k,
        stall count and best residual, and is active while
        (rnrm > tol) & (k < cg_max_iters) & (stall < 12) — vmap's
        while_loop. `rows` (B,) bool, where given, leaves the other rows
        untouched at x0 (their result is discarded by the caller).
        Returns (x, k) with k the (B,) int32 iteration counts."""
        stg = self.stg
        Minv = 1.0 / self._diagS(mats, dy, scale)
        x = x0
        r = rhs - self._matvec_S(mats, dy, x)
        p = Minv * r
        rz = _dot(r, p)
        rnrm = best = _norm(r)
        B = rhs.shape[0]
        k = self._ints(B, 0)
        stall = self._ints(B, 0)
        active = (rnrm > tol) & (stg.cg_max_iters > 0)
        if rows is not None:
            active = active & rows
        while trace.any_(active, "cg"):  # one device read per CG iteration
            a = _col(active)
            Ap = self._matvec_S(mats, dy, p)
            alpha = _col(rz / _dot(p, Ap))
            x = torch.where(a, x + alpha * p, x)
            r_new = r - alpha * Ap
            z = Minv * r_new
            rz_new = _dot(r_new, z)
            p = torch.where(a, z + _col(rz_new / rz) * p, p)
            r = torch.where(a, r_new, r)
            rz = torch.where(active, rz_new, rz)
            rnrm_new = _norm(r_new)
            stall = torch.where(
                active, torch.where(rnrm_new < 0.99 * best, 0, stall + 1), stall
            )
            best = torch.where(active, torch.minimum(best, rnrm_new), best)
            rnrm = torch.where(active, rnrm_new, rnrm)
            k = k + active
            active = active & (rnrm > tol) & (k < stg.cg_max_iters) & (stall < 12)
            self.cg_steps += 1
        return x, k

    # -- setup ----------------------------------------------------------------

    def _compute_g(self, mats: Mats, scale, L, rows=None):
        """g = solve(S, c - A' D_y b) and its y image, per problem: by the
        given factor L (direct) or by CG (on `rows` only, where given)."""
        dy = 1.0 / self._ry(scale)
        rhs = mats.cn - self._ATy_hi(mats, dy * mats.bn)
        if self.indirect:
            tol = torch.clamp_min(self.eps_floor * _norm(rhs), self.stg.cg_tol_min * 10)
            gx, _ = self._cg(mats, dy, rhs, torch.zeros_like(rhs), tol, scale, rows)
        else:
            gx = self._direct_solve(mats, L, dy, rhs)
        gy = dy * (mats.bn + self._Ax_hi(mats, gx))
        return gx, gy

    def initial_scale(self, B):
        return torch.full((B,), self.stg.scale, dtype=self.dtype, device=self.device)

    def _fresh_state(self, L, gx, gy, scale):
        B, N = gx.shape[0], self.N

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        u = zeros(B, N)
        u[:, -1] = 1.0
        v = zeros(B, N)
        w = u + v
        Lb = max(self.lookback, 1)
        nanv = torch.full((B,), math.nan, dtype=self.dtype, device=self.device)
        aa = AAState(
            dX=zeros(B, Lb, N),
            dF=zeros(B, Lb, N),
            zeta_prev=w,
            f_prev=zeros(B, N),
            count=self._ints(B, -1),
            n_accept=self._ints(B, 0),
            n_reject_nonfinite=self._ints(B, 0),
            n_reject_weight_cap=self._ints(B, 0),
            n_safeguard_reject=self._ints(B, 0),
            last_aa_norm=nanv,
            last_reg=zeros(B),
            aa_iter=self._ints(B, 0),
        )
        return State(
            w=w,
            u=u,
            v=v,
            u_sum=zeros(B, N),
            v_sum=zeros(B, N),
            avg_cnt=zeros(B),
            scale=scale,
            L=L,
            gx=gx,
            gy=gy,
            px_warm=zeros(B, self.n),
            it=self._ints(B, 0),
            status=self._ints(B, UNFINISHED),
            scale_updates=self._ints(B, 0),
            since_rescale=self._ints(B, 0),
            rescale_ratio=torch.ones(B, dtype=self.dtype, device=self.device),
            rescale_trigger=torch.zeros(B, dtype=torch.bool, device=self.device),
            cg_iters=self._ints(B, 0),
            diff_u_ut_2=nanv,
            diff_u_ut_inf=nanv,
            diff_v_2=nanv,
            diff_v_inf=nanv,
            diag=Diag(*([nanv] * len(Diag._fields))),
            aa=aa,
        )

    def init_state(self, mats: Mats, L=None):
        """Cold-start states of the whole batch: the factorization at the
        initial scale (direct; skipped when the caller passes its cached
        factor L) and g."""
        scale = self.initial_scale(mats.bn.shape[0])
        if L is None:
            L = self._factorize(mats, scale)
        gx, gy = self._compute_g(mats, scale, L)
        return self._fresh_state(L, gx, gy, scale)

    # -- one DR iteration -----------------------------------------------------

    def _step_lin(self, state: State, mats: Mats):
        n, m = self.n, self.m
        stg = self.stg
        w = state.w
        wx, wy, wtau = w[:, :n], w[:, n : n + m], w[:, -1]

        ry = self._ry(state.scale)
        dy = 1.0 / ry

        rhs = stg.rho_x * wx - self._ATy(mats, wy)
        # CG tolerance schedule (Core._step_lin), per problem: `it` and the
        # previous DR step size are each row's own
        it_f = state.it.to(self.dtype) + 1.0
        sched = torch.clamp_max(it_f ** (-stg.cg_rate) * 1e3, 1.0)
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
        a = 1.0 + stg.rho_x * _dot(gx, gx) + _dot(gy * ry, gy)
        hp = _dot(mats.cn, px) + _dot(mats.bn, py)
        if self.has_P:
            Ppx = self._Px(mats, px)
            bq = -wtau - hp + 2.0 * _dot(gx, Ppx)
            cq = -_dot(px, Ppx)
            disc = torch.clamp_min(bq * bq - 4.0 * a * cq, 0.0)
            tau = (-bq + torch.sqrt(disc)) / (2.0 * a)
        else:
            bq = -wtau - hp
            tau = -bq / a
        tau = _col(torch.clamp_min(tau, 0.0))

        ut = torch.cat([px - tau * gx, py - tau * gy, tau], dim=1)
        return ut, px, cg_k

    def _step_cone(self, state: State, ut, px, cg_k, mats: Mats):
        n, m = self.n, self.m
        w = state.w
        refl = 2.0 * ut - w
        uy = refl[:, n : n + m] + self._proj(-refl[:, n : n + m], mats.bl, mats.bu)
        u_new = torch.cat(
            [refl[:, :n], uy, torch.clamp_min(refl[:, -1:], 0.0)], dim=1
        )
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
            diff_u_ut_inf=_amax(du),
            diff_v_2=_norm(dv),
            diff_v_inf=_amax(dv),
        )

    # -- Anderson acceleration ------------------------------------------------

    def _aa_push(self, aa: AAState, zeta, f):
        Lb = aa.dX.shape[1]
        slot = torch.clamp_min(aa.count, 0) % Lb
        put = (torch.arange(Lb, device=self.device) == _col(slot)) & _col(aa.count >= 0)
        put = put[:, :, None]  # (B, L, 1)
        return aa._replace(
            dX=torch.where(put, (zeta - aa.zeta_prev)[:, None, :], aa.dX),
            dF=torch.where(put, (f - aa.f_prev)[:, None, :], aa.dF),
            zeta_prev=zeta,
            f_prev=f,
            count=aa.count + 1,
        )

    def _aa_candidate(self, aa: AAState, zeta, f):
        """The AA candidate of every problem (Core._aa_candidate's math):
        batched Gram products with TF32 off and a batched Cholesky whose
        failure gives that row NaN, rejected downstream as non-finite."""
        stg = self.stg
        s = (_norm(f) + 1e-300)[:, None, None]  # rounds to 0 in f32
        dX, dF = aa.dX / s, aa.dF / s
        fs = (f[:, :, None] / s)  # (B, N, 1)
        with _no_tf32():
            if stg.acceleration_type_1:
                M = dX @ dF.transpose(1, 2)  # (B, L, L) type-I mixed Gram
                rhs0 = dX @ fs
                reg = stg.acceleration_regularization * (
                    1.0 + M.abs().diagonal(dim1=1, dim2=2).sum(-1)
                )
                MT = M.transpose(1, 2)
                G = MT @ M
                G.diagonal(dim1=1, dim2=2).add_(_col(reg * reg))
                rhs = MT @ rhs0
            else:
                G = dF @ dF.transpose(1, 2)  # type-II Gram (PSD)
                reg = stg.acceleration_regularization * (
                    1.0 + G.diagonal(dim1=1, dim2=2).sum(-1)
                )
                G.diagonal(dim1=1, dim2=2).add_(_col(reg))
                rhs = dF @ fs
            chol, info = torch.linalg.cholesky_ex(G)
            gamma = _cholesky_solve(rhs, chol, "aa_solve")[:, :, 0]  # (B, L)
            gamma = torch.where(_col(info == 0), gamma, math.nan)
            g = gamma[:, None, :]
            beta = stg.acceleration_relaxation
            cand = zeta - (g @ aa.dX)[:, 0] + beta * (f - (g @ aa.dF)[:, 0])
        return cand, gamma, reg

    @staticmethod
    def _accumulate(state: State, st: State):
        return st._replace(
            it=state.it + 1,
            u_sum=state.u_sum + st.u,
            v_sum=state.v_sum + st.v,
            avg_cnt=state.avg_cnt + 1.0,
        )

    def _iter_plain(self, state: State, mats: Mats):
        """One iteration without the AA trial (scs_tpu's _iter_plain: the
        trial-aligned chunk runs it where the trial cannot fire)."""
        st1 = self._step(state, mats)
        if self.lookback == 0:
            return self._accumulate(state, st1)
        aa = self._aa_push(state.aa, state.w, st1.w - state.w)
        return self._accumulate(state, st1._replace(aa=aa))

    def _iter_tail(self, state: State, st1: State, mats: Mats):
        """AA bookkeeping and the periodic trial, per problem: rows with
        do_aa take the trial's outcome, the others the plain step."""
        zeta = state.w
        f = st1.w - zeta
        if self.lookback == 0:
            return self._accumulate(state, st1)

        aa = self._aa_push(state.aa, zeta, f)
        plain = st1._replace(aa=aa)
        do_aa = ((state.it + 1) % self.interval == 0) & (aa.count >= 1)
        if not trace.any_(do_aa, "aa_trial"):
            return self._accumulate(state, plain)

        cand, gamma, reg = self._aa_candidate(aa, zeta, f)
        cand = cand * _col(_norm(zeta) / torch.clamp_min(_norm(cand), 1e-300))
        finite = torch.isfinite(cand).all(-1)
        weight_ok = gamma.abs().sum(-1) < 1e6
        st2 = self._step(st1._replace(w=cand), mats)
        f_cand = st2.w - cand
        aa_norm = _norm(f_cand)
        safe = aa_norm <= self.stg.aa_safeguard_factor * _norm(f)
        accept = finite & weight_ok & safe

        new_state = _select(accept, st2, st1)
        if self.stg.aa_reset_on_reject:
            aa = _select(accept, aa, aa._replace(
                count=torch.full_like(aa.count, -1),
                dX=torch.zeros_like(aa.dX),
                dF=torch.zeros_like(aa.dF),
            ))
        i32 = lambda b: b.to(torch.int32)  # noqa: E731
        acc = _col(accept)
        aa = aa._replace(
            n_accept=aa.n_accept + i32(accept),
            n_reject_nonfinite=aa.n_reject_nonfinite + i32(~finite),
            n_reject_weight_cap=aa.n_reject_weight_cap + i32(finite & ~weight_ok),
            n_safeguard_reject=aa.n_safeguard_reject
            + i32(finite & weight_ok & ~safe),
            last_aa_norm=aa_norm,
            last_reg=reg,
            aa_iter=aa.aa_iter + 1,
            zeta_prev=torch.where(acc, cand, aa.zeta_prev),
            f_prev=torch.where(acc, f_cand, aa.f_prev),
        )
        trial = new_state._replace(aa=aa)
        return self._accumulate(state, _select(do_aa, trial, plain))

    # -- residuals / termination ----------------------------------------------

    def _residuals(self, state: State, mats: Mats):
        """Core._residuals per problem: every norm, dot and max is over
        the last axis; per-problem scalars have shape (B,)."""
        n, m = self.n, self.m
        u, v = state.u, state.v
        xbar, ybar, tau = u[:, :n], u[:, n : n + m], u[:, -1]
        ry = self._ry(state.scale)
        st_hat = ry * v[:, n : n + m]

        Axb = self._Ax_hi(mats, xbar)
        Aty = self._ATy_hi(mats, ybar)
        Pxb = self._Px_hi(mats, xbar)

        Dinv = 1.0 / mats.D
        Einv = 1.0 / mats.E
        sc_b, sc_c = mats.sc_b, mats.sc_c
        inf = math.inf

        safe_tau = torch.clamp_min(tau, 1e-300)

        rp_hat = Axb + st_hat - mats.bn * _col(tau)
        rd_hat = Pxb + Aty + mats.cn * _col(tau)
        rp_vec = Dinv * rp_hat / _col(sc_b * safe_tau)
        rd_vec = Einv * rd_hat / _col(sc_c * safe_tau)
        res_pri = _norm(rp_vec)
        res_dual = _norm(rd_vec)

        ax_s_btau_2 = res_pri * safe_tau
        ax_s_btau_inf = _amax(rp_vec) * safe_tau
        px_aty_ctau_2 = res_dual * safe_tau
        px_aty_ctau_inf = _amax(rd_vec) * safe_tau
        ax2_n = _norm(rp_hat)
        axinf_n = _amax(rp_hat)
        px2_n = _norm(rd_hat)
        pxinf_n = _amax(rd_hat)

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
        comp_slack = torch.abs(_dot(st_hat, ybar)) / (sc_b * sc_c * safe_tau**2)

        bty_raw = _dot(mats.bn, ybar) / (sc_b * sc_c)
        ctx_raw = _dot(mats.cn, xbar) / (sc_c * sc_b)
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

        ctx_hat = _dot(mats.cn, xbar)
        bty_hat = _dot(mats.bn, ybar)
        xPx_hat = _dot(xbar, Pxb)
        res_pri_norm = ax2_n / safe_tau
        res_dual_norm = px2_n / safe_tau
        pobj_norm = 0.5 * xPx_hat / safe_tau**2 + ctx_hat / safe_tau
        dobj_norm = -0.5 * xPx_hat / safe_tau**2 - bty_hat / safe_tau
        gap_norm = torch.abs(
            xPx_hat / safe_tau**2 + ctx_hat / safe_tau + bty_hat / safe_tau
        )
        res_infeas_norm = torch.where(
            bty_hat < 0, _norm(Aty) / torch.clamp_min(-bty_hat, 1e-300), inf
        )
        res_unbdd_a_norm = torch.where(
            ctx_hat < 0,
            _norm(Axb + st_hat) / torch.clamp_min(-ctx_hat, 1e-300),
            inf,
        )
        no_P_hat = torch.where(ctx_hat < 0, 0.0, torch.full_like(ctx_hat, inf))
        res_unbdd_p_norm = torch.where(
            ctx_hat < 0, _norm(Pxb) / torch.clamp_min(-ctx_hat, 1e-300), inf
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
        return diag, (nAx, ns, nPx, nAty), (ctx, bty, xPx)

    def _check(self, state: State, mats: Mats):
        """Residuals, termination, the ergodic average and the adaptive
        scale of every problem (scs_tpu's _check under vmap)."""
        nrm = _norm(state.w)
        t = torch.where(
            torch.isfinite(nrm) & (nrm > 0), math.sqrt(self.N) / nrm, 1.0
        )
        t2, t3 = t[:, None], t[:, None, None]
        aa = state.aa
        state = state._replace(
            w=state.w * t2,
            u=state.u * t2,
            v=state.v * t2,
            u_sum=state.u_sum * t2,
            v_sum=state.v_sum * t2,
            px_warm=state.px_warm * t2,
            aa=aa._replace(
                dX=aa.dX * t3,
                dF=aa.dF * t3,
                zeta_prev=aa.zeta_prev * t2,
                f_prev=aa.f_prev * t2,
            ),
        )
        diag, denoms, scalars = self._residuals(state, mats)
        status = self._status_from(diag, denoms, scalars, mats.norm_b, mats.norm_c)
        bad = ~torch.isfinite(state.u).all(-1)
        status = torch.where(bad, FAILED, status)
        state = state._replace(diag=diag, status=status)

        # ergodic candidate, per problem
        try_avg = (status == UNFINISHED) & (state.avg_cnt > 50.0)
        if trace.any_(try_avg, "avg"):
            cnt = _col(torch.clamp_min(state.avg_cnt, 1.0))
            ua = state.u_sum / cnt
            st_a = state._replace(u=ua, v=state.v_sum / cnt)
            diag_a, denoms_a, scalars_a = self._residuals(st_a, mats)
            status_a = self._status_from(
                diag_a, denoms_a, scalars_a, mats.norm_b, mats.norm_c
            )
            take = try_avg & (status_a != UNFINISHED) & torch.isfinite(ua).all(-1)
            state = _select(take, st_a._replace(diag=diag_a, status=status_a), state)

        # doubling-window restart of the averages, per problem
        reset = (state.status == UNFINISHED) & (
            2.0 * state.avg_cnt > state.it.to(self.dtype)
        )
        r2 = _col(reset)
        state = state._replace(
            u_sum=torch.where(r2, 0.0, state.u_sum),
            v_sum=torch.where(r2, 0.0, state.v_sum),
            avg_cnt=torch.where(reset, 0.0, state.avg_cnt),
        )

        if not self.stg.adaptive_scale:
            return state._replace(since_rescale=state.since_rescale + 1)
        ratio, trigger = self._rescale_ratio_trigger(state, mats, diag, denoms)
        if not self.rescale_in_chunk:
            # record the decision; rescale_step applies it between segments
            return state._replace(
                since_rescale=state.since_rescale + 1,
                rescale_ratio=ratio,
                rescale_trigger=trigger,
            )
        return self._apply_rescale(state, mats, ratio, trigger)

    def _rescale_ratio_trigger(self, state: State, mats: Mats, diag, denoms):
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
        min_gap = torch.clamp_min(state.it // 4, stg.rescale_min_iters)
        trigger = (
            ((state.since_rescale + 1) * stg.check_interval >= min_gap)
            & ((ratio > stg.rescale_factor_band)
               | (ratio < 1.0 / stg.rescale_factor_band))
            & (state.status == UNFINISHED)
            & torch.isfinite(ratio)
        )
        return ratio, trigger

    def _refactorize_rows(self, state: State, mats: Mats, new_scale, trigger):
        """The factor slot after a rescale: rows that trigger get the
        factorization at their new scale, the others keep theirs. Only the
        triggered rows are factorized (a gathered sub-batch), so a rescale
        costs setup work for the rows that need it and its S / factor
        transients are that small."""
        if self.indirect:
            return state.L
        idx = trigger.nonzero()[:, 0]  # sized on the host: a read of the device
        trace.host_sync("rescale_rows")
        # _factorize reads only A, P and the scale
        sub = mats._replace(
            A=mats.A.index_select(0, idx),
            P=mats.P.index_select(0, idx) if self.has_P else None,
        )
        L_sub = self._factorize(sub, new_scale.index_select(0, idx))
        return state.L.index_copy(0, idx, L_sub)

    def _apply_rescale(self, state: State, mats: Mats, ratio, trigger):
        """New scale, factor and g for the rows that trigger;
        since_rescale + 1 for the others. The setup work (factorization,
        the setup CG) runs only on the triggered rows."""
        kept = state._replace(since_rescale=state.since_rescale + 1)
        if not trace.any_(trigger, "rescale"):
            return kept
        stg = self.stg
        n, m = self.n, self.m
        new_scale = torch.clamp(state.scale * ratio, stg.min_scale, stg.max_scale)
        L = self._refactorize_rows(state, mats, new_scale, trigger)
        gx, gy = self._compute_g(mats, new_scale, L, rows=trigger)
        f = _col(new_scale / state.scale)

        def y_times_f(a):
            # keep the slack s_hat = ry*v_y invariant across the metric change
            return torch.cat([a[:, :n], a[:, n : n + m] * f, a[:, n + m :]], dim=1)

        v = y_times_f(state.v)
        w = state.u + v
        B = trigger.shape[0]
        rescaled = state._replace(
            scale=new_scale,
            L=L,
            gx=gx,
            gy=gy,
            v=v,
            w=w,
            # the average lives in original coordinates; only v's y block
            # is metric-dependent — rescale it like v itself
            v_sum=y_times_f(state.v_sum),
            scale_updates=state.scale_updates + 1,
            since_rescale=self._ints(B, 0),
            rescale_trigger=torch.zeros_like(trigger),
            aa=state.aa._replace(count=self._ints(B, -1), zeta_prev=w),
        )
        # L is row-selected already (_refactorize_rows)
        return _select(trigger, rescaled, kept._replace(L=L))

    def rescale_step(self, state: State, mats: Mats):
        """Apply the rescale decision recorded by the last _check (the
        batched solve loop calls this between segments when a row triggered)."""
        if not self.stg.adaptive_scale:
            return state
        new = self._apply_rescale(
            state, mats, state.rescale_ratio, state.rescale_trigger
        )
        # _check already advanced since_rescale once per chunk; undo the
        # extra non-trigger increment of _apply_rescale
        return new._replace(
            since_rescale=torch.where(
                new.scale_updates > state.scale_updates, 0, state.since_rescale
            ),
            rescale_trigger=torch.zeros_like(state.rescale_trigger),
        )

    # -- chunks and segments --------------------------------------------------

    def _chunk(self, state: State, mats: Mats):
        """check_interval iterations, then one check (every row)."""
        k = self.stg.check_interval
        interval = max(self.interval, 1)
        if self.lookback > 0 and k % interval == 0:
            # trial-aligned: every row starts at it = 0 and chunks advance
            # it by a multiple of the interval, so the trial can fire only
            # on the last iteration of each interval group
            for _ in range(k // interval):
                for _ in range(interval - 1):
                    state = self._iter_plain(state, mats)
                state = self._iter_body(state, mats)
        else:
            for _ in range(k):
                state = self._iter_body(state, mats)
        return self._check(state, mats)

    @staticmethod
    def live(state: State, max_iters):
        """(B,) bool: the rows still iterating (unfinished, under the cap)."""
        return (state.status == UNFINISHED) & (state.it < max_iters)

    def masked_chunk(self, state: State, mats: Mats, max_iters):
        """One chunk in which finished and iteration-capped rows stay
        frozen (scs_tpu batch.py:166-188). Without the in-chunk rescale,
        the factor and g are loop-invariant and carried through as they
        were (no select over the (B, n, n) factor)."""
        new = self._chunk(state, mats)
        if self.rescale_in_chunk:
            return _select(self.live(state, max_iters), new, state)
        new = new._replace(L=state.L, gx=state.gx, gy=state.gy)
        return _select(self.live(state, max_iters), new, state)

    def run_seg(self, state: State, mats: Mats, max_iters, seg):
        """Up to `seg` masked chunks, while any row is live (one device
        read per chunk); the span `solve.segment`."""
        with trace.span("solve.segment", bucket=state.it.shape[0]) as sp:
            chunks = 0
            while chunks < seg and trace.any_(self.live(state, max_iters), "live"):
                state = self.masked_chunk(state, mats, max_iters)
                chunks += 1
            sp.set(chunks=chunks)
        return state

    # -- per-phase timing -----------------------------------------------------

    def _doctored_trial_state(self, state: State):
        """State altered so _iter_tail fires the AA trial in every row."""
        return state._replace(
            it=torch.full_like(state.it, max(self.interval - 1, 0)),
            aa=state.aa._replace(count=torch.full_like(state.aa.count, 2)),
        )

    # -- finalization ---------------------------------------------------------

    def _finalize(self, state: State, mats: Mats):
        """(x, y, s), the certificates, the relaxed status and the
        diagnostics of every problem (Core._finalize per row, with the
        per-problem choice of the ergodic average on exhaustion)."""
        n, m = self.n, self.m
        maybe = (state.status == UNFINISHED) & (state.avg_cnt > 50.0)
        if trace.any_(maybe, "finalize"):
            def score(st):
                d, _, _ = self._residuals(st, mats)
                return d.res_pri + d.res_dual + d.gap

            cnt = _col(torch.clamp_min(state.avg_cnt, 1.0))
            st_a = state._replace(u=state.u_sum / cnt, v=state.v_sum / cnt)
            better = (
                maybe & torch.isfinite(st_a.u).all(-1) & (score(st_a) < score(state))
            )
            state = _select(better, st_a, state)

        u, v = state.u, state.v
        xbar, ybar, tau = u[:, :n], u[:, n : n + m], u[:, -1]
        ry = self._ry(state.scale)
        st_hat = ry * v[:, n : n + m]
        Dinv = 1.0 / mats.D
        safe_tau = torch.clamp_min(tau, 1e-300)
        sc_b, sc_c = mats.sc_b, mats.sc_c

        x = mats.E * xbar / _col(sc_b * safe_tau)
        y = mats.D * ybar / _col(sc_c * safe_tau)
        s = Dinv * st_hat / _col(sc_b * safe_tau)

        bty_raw = _dot(mats.bn, ybar) / (sc_b * sc_c)
        ctx_raw = _dot(mats.cn, xbar) / (sc_c * sc_b)
        y_cert = (mats.D * ybar / _col(sc_c)) / _col(torch.clamp_min(-bty_raw, 1e-300))
        x_cert = (mats.E * xbar / _col(sc_b)) / _col(torch.clamp_min(-ctx_raw, 1e-300))
        s_cert = (Dinv * st_hat / _col(sc_b)) / _col(torch.clamp_min(-ctx_raw, 1e-300))

        diag, denoms, scalars = self._residuals(state, mats)
        relaxed = self._status_from(
            diag, denoms, scalars, mats.norm_b, mats.norm_c, eps_mult=1e3
        )
        return x, y, s, x_cert, y_cert, s_cert, relaxed, diag

    def finalize_pack(self, state: State, mats: Mats):
        """_finalize plus every per-problem scalar of the info dict in one
        (B, 22) float64 tensor, in scs_tpu's column order
        (batch.py:205-241), so the host reads them in one transfer."""
        x, y, s, x_cert, y_cert, s_cert, relaxed, diag = self._finalize(state, mats)
        aa = state.aa
        cols = [
            state.status, state.it, relaxed, state.scale_updates, state.scale,
            diag.pobj, diag.dobj, diag.res_pri, diag.res_dual, diag.gap,
            diag.res_infeas, diag.res_unbdd_a, diag.res_unbdd_p, diag.comp_slack,
            aa.aa_iter, aa.n_accept, aa.n_reject_nonfinite,
            aa.n_reject_weight_cap, aa.n_safeguard_reject, aa.count,
            aa.last_aa_norm, aa.last_reg,
        ]
        scal = torch.stack([c.to(torch.float64) for c in cols], dim=1)
        return x, y, s, x_cert, y_cert, s_cert, scal
