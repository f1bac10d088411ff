"""Batched multi-problem solving: B same-shape problems as one batched
core — the port of scs_tpu/batch.py.

The reference serves B instances with a thread pool, one solver per
thread; scs_tpu solves them as one vmapped program; here they run as one
batched core (batch_core.BatchedCore) in masked lockstep. Two paths:

  * dense: A is a (B, m, n) array (or a list densified to one) under the
    "direct" strategy (a batched Cholesky at setup; by default the factor
    slot holds S^-1 and every solve is one batched matvec) or "indirect"
    (batched CG). Upload, Ruiz equilibration, factorization and g all run
    on the device; every dense matvec is one launch of the batched GEMV
    kernels (ops/dense.py) for the whole batch;
  * bell: A is a list of B scipy sparse matrices; every operator call is
    one launch of the batched block-ELL SpMV, and the (B, m, n) dense batch
    is never formed, on the host or the device.

The solve loop is scs_tpu's, decision for decision (batch.py:1024-1189):
segments of masked chunks, a speculative next segment run before the
current segment's probe is read, the adaptive rescale applied between
segments to the speculatively advanced state, retirement of finished
problems and compaction of the survivors down a halving bucket ladder,
the time limit and Ctrl-C. The factor slot L rides through compaction
with every other leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import info as info_mod
from . import trace
from .batch_core import BatchedCore
from .cones import ConeSpec
from .info import UNFINISHED
from .settings import Settings
from .solver import BellData, Mats, PBell, mean_call_time


def batch_memory_bytes(B, m, n, has_P, itemsize=4, lookback=10):
    """(peak, steady) live-byte estimate for a dense B-problem batch
    (scs_tpu batch.py:60-75). The peak is at setup: the problem data (A, P
    equilibrated in place) plus the S / chol(S) / S^-1 transients of the
    batched factorization; the steady state drops the transients but keeps
    the factor L."""
    N = n + m + 1
    nP = n * n if has_P else 0
    mats_b = m * n + nP + 4 * (m + n)
    state_b = n * n + 2 * max(lookback, 1) * N + 8 * N
    setup_transient = 3 * n * n
    peak = B * itemsize * (mats_b + state_b + setup_transient)
    steady = B * itemsize * (mats_b + state_b)
    return peak, steady


def recommend_chunks(B, m, n, has_P, itemsize=4, budget=None) -> int:
    """Number of sequential sub-batches needed to fit setup in device
    memory; `budget` defaults to 3/4 of the card's free memory right now
    (`torch.cuda.mem_get_info`: without a card it raises, there is no
    assumed capacity)."""
    if budget is None:
        budget = int(0.75 * torch.cuda.mem_get_info()[0])
    peak, _ = batch_memory_bytes(B, m, n, has_P, itemsize)
    chunks = max(1, -(-peak // budget))
    p = 1  # round up to a power of two for even slicing
    while p < chunks:
        p *= 2
    return int(min(p, B))


def _gather(tree, idx):
    """Rows `idx` of every leaf of a NamedTuple tree (None leaves stay)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_gather(t, idx) for t in tree))
    return tree.index_select(0, idx)


class BatchedSCS:
    """Solve B same-shape cone problems simultaneously.

    Parameters
    ----------
    data: dict with
        A: (B, m, n) dense array or tensor, or a list of B matrices (dense
           or scipy sparse; a sparse list stays sparse under "bell" and is
           densified otherwise)
        P: (B, n, n) dense FULL symmetric (or a list; under "bell" sparse,
           full or upper triangle), optional
        b: (B, m), c: (B, n)
    cone: one cone dict shared by the batch.

    The caller's A and P are never modified: the solver equilibrates its
    own device copy in place. A dense (B, m, n) A under
    solver_strategy="bell" raises ValueError as in scs_tpu.
    """

    # compaction ladder floor: never compact below this many problems
    _MIN_BUCKET = 32

    def __init__(self, data, cone, **settings):
        settings.setdefault("verbose", False)
        # scs_tpu's batched defaults (batch.py:311-344), kept so that one
        # settings dict gives the same solve in either package. Direct
        # solves apply the precomputed inverse: one batched matvec instead
        # of B pairs of triangular solves.
        settings.setdefault("direct_solver", "inverse")
        # Refactorize between segments, not inside the chunk
        settings.setdefault("rescale_in_chunk", False)
        # refinement doubles the per-iteration A traffic; zero/nonneg/box
        # batches converge at eps 1e-4 without it. Tight tolerances and
        # curved cones get the auto policy (-1).
        eps_min = min(
            float(settings.get("eps_abs", 1e-4)), float(settings.get("eps_rel", 1e-4))
        )
        settings.setdefault(
            "lin_refine_steps",
            -1 if (eps_min < 3e-5 or not ConeSpec.from_dict(cone).is_simple) else 0,
        )
        settings.setdefault("check_interval", 50)
        settings.setdefault("batch_compact_interval", 1)
        A = data["A"]
        P = data.get("P")
        sparse_list = (
            isinstance(A, (list, tuple)) and len(A) > 0 and hasattr(A[0], "tocsc")
        )
        if sparse_list:
            B = len(A)
            m, n = A[0].shape
        else:
            if isinstance(A, (list, tuple)):
                A = _stack_dense(A)
            if A.ndim != 3:
                raise ValueError("Batched A must have shape (B, m, n)")
            B, m, n = A.shape

        self.stg = Settings.from_kwargs(**settings)
        if self.stg.solver_strategy == "auto":
            self.stg.solver_strategy = "direct" if n <= 4096 else "indirect"
        if self.stg.solver_strategy == "bell":
            if not sparse_list:
                raise ValueError(
                    "solver_strategy='bell' on a batch requires A as a "
                    "list of scipy sparse matrices (the point of the "
                    "batched bell path is never densifying)"
                )
        elif sparse_list:
            # non-bell strategies use the dense batched core
            A = _stack_dense(A)
        if isinstance(P, (list, tuple)) and self.stg.solver_strategy != "bell":
            P = _stack_dense(P)
        spec = ConeSpec.from_dict(cone)
        if spec.dim != m:
            raise ValueError("cone dimensions incompatible with b")
        self.spec = spec
        self.B, self.m, self.n = B, m, n
        self.has_P = P is not None
        self._dtype = torch.float64 if self.stg.dtype == "float64" else torch.float32
        self._device = torch.device(self.stg.device)

        self._batch = trace.new_batch()
        t0 = time.perf_counter()
        # marks at the set-up's boundaries, read by setup_breakdown; the one
        # wait of set-up is its end's
        marks = self._setup_marks = [self._mark()]
        with trace.span("batch.setup", batch=self._batch, B=B, m=m, n=n):
            if self.stg.solver_strategy == "bell":
                self.core = BatchedCore(m, n, self.has_P, spec, self.stg)
                # host-side sparse preprocessing per problem (equilibration
                # and block-ELL packing never materialize dense A), then one
                # stacked upload; as in scs_tpu the upload counts in
                # "equilibrate"
                marks.append(marks[0])
                with trace.span("setup.equilibrate"):
                    self.mats = self._build_bell_mats(A, P, data["b"], data["c"], spec)
            else:
                # upload, then everything on the device: one batched Ruiz
                # equilibration scales the solver's own copy of (A, P) in place
                with trace.span("setup.upload"):
                    self.core = BatchedCore(m, n, self.has_P, spec, self.stg)
                    A = self._own(A, (B, m, n))
                    P = self._own(P, (B, n, n)) if self.has_P else None
                    b = self._own(data["b"], (B, m))
                    c = self._own(data["c"], (B, n))
                marks.append(self._mark())
                with trace.span("setup.equilibrate"):
                    self.mats = self._build_dense_mats(A, P, b, c, spec)
                del A, P
            marks.append(self._mark())
            core = self.core
            # the factorization at the initial scale depends only on (A, P):
            # cached for reset()/update(), so b/c sweeps and repeat solves
            # never re-run the batched Cholesky (the empty slot under CG)
            with trace.span("setup.factorize"):
                self._L = core._factorize(self.mats, core.initial_scale(B))
            marks.append(self._mark())
            with trace.span("setup.g"):
                self._states = core.init_state(self.mats, L=self._L)
                marks.append(self._mark())
                core._sync("setup_sync")
        self._setup_time = time.perf_counter() - t0
        self._setup_breakdown = None
        self._phase_cache = None

    def _mark(self):
        """A point of set-up: a CUDA event on the solver's stream, or on the
        CPU the host's clock (every operation there has ended on return)."""
        if self._device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    @property
    def setup_breakdown(self):
        """Seconds of set-up's parts ("transfer", "equilibrate", "factorize",
        "compute_g"), each between two of the marks at the `setup.*` spans'
        boundaries: on a card the device's clock, read at the first access
        (set-up's final wait has passed every mark)."""
        if self._setup_breakdown is None:
            marks = self._setup_marks
            if self._device.type == "cuda":
                secs = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
            else:
                secs = [b - a for a, b in zip(marks, marks[1:])]
            self._setup_breakdown = dict(
                zip(("transfer", "equilibrate", "factorize", "compute_g"), secs)
            )
        return self._setup_breakdown

    def _own(self, a, shape):
        """The solver's own tensor of `a` on its device in its dtype: always
        a copy, never a view of the caller's array (the equilibration scales
        it in place)."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        out = a.to(device=self._device, dtype=self._dtype, copy=True).reshape(shape)
        if a.device.type == "cpu":
            trace.uploaded(self._device, "setup_upload")
        return out

    def _build_dense_mats(self, A, P, b, c, spec):
        """Batched dense Mats from the solver's own (A, P, b, c) tensors:
        the on-device Ruiz equilibration (A and P scaled in place) or the
        identity scaling (scs_tpu batch.py:123-160, prep_one under vmap)."""
        from .normalize import ruiz_equilibrate_batched  # noqa: PLC0415

        B, dtype, dev = self.B, self._dtype, self._device
        norm_b = torch.linalg.vector_norm(b, dim=1)
        norm_c = torch.linalg.vector_norm(c, dim=1)
        if self.stg.normalize:
            A, P, bh, ch, D, E, sc_b, sc_c, bl_h, bu_h = ruiz_equilibrate_batched(
                A, P, b, c, spec
            )
        else:
            bh, ch = b, c
            D = torch.ones((B, self.m), dtype=dtype, device=dev)
            E = torch.ones((B, self.n), dtype=dtype, device=dev)
            sc_b = sc_c = torch.ones(B, dtype=dtype, device=dev)
            bl_h = torch.as_tensor(spec.bl, dtype=dtype, device=dev).expand(B, -1).clone()
            bu_h = torch.as_tensor(spec.bu, dtype=dtype, device=dev).expand(B, -1).clone()
        return Mats(
            bn=bh, cn=ch, bl=bl_h, bu=bu_h, D=D, E=E, sc_b=sc_b, sc_c=sc_c,
            norm_b=norm_b, norm_c=norm_c, A=A, P=P,
        )

    def _build_bell_mats(self, A_list, P_list, b, c, spec):
        """Batched block-ELL Mats for B sparse problems: per-problem host
        equilibration and packing in a thread pool, stacked with a leading
        batch axis. Widths are padded to the batch's largest (zero tiles
        pointing at block-column 0), so problems need not share a pattern
        (scs_tpu batch.py:476-620)."""
        from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

        from scipy import sparse as spsp  # noqa: PLC0415

        from .normalize import identity_scaling, ruiz_equilibrate_sparse  # noqa: PLC0415
        from .ops.sparse import (  # noqa: PLC0415
            _cols_tensor,
            pack_bell_host,
            pack_bell_sym_host,
            stack_bell_host,
        )

        B, m, n = self.B, self.m, self.n
        bs = self.stg.bell_block_size
        b = np.asarray(b, np.float64).reshape(B, m)
        c = np.asarray(c, np.float64).reshape(B, n)
        has_P = P_list is not None
        dtype, dev = self._dtype, self._device
        np_dtype = np.float64 if dtype == torch.float64 else np.float32

        def prep_one(i):
            Ai = spsp.csc_matrix(A_list[i])
            Pi = None
            if has_P:
                Pi = spsp.csc_matrix(P_list[i])
                if (abs(Pi - Pi.T) > 1e-12 * abs(Pi).max()).nnz > 0:
                    # accept triu input like the single-problem path
                    U = spsp.triu(Pi).tocsc()
                    Pi = (U + U.T - spsp.diags(U.diagonal())).tocsc()
            if self.stg.normalize:
                Ah, Ph, bh, ch, scal, spec_hat = ruiz_equilibrate_sparse(
                    Ai, Pi, b[i], c[i], spec
                )
            else:
                scal = identity_scaling(m, n)
                Ah, Ph, bh, ch, spec_hat = Ai, Pi, b[i], c[i], spec
            packed = pack_bell_host(Ah, bs, np_dtype)
            zmask = spec_hat.zero_row_mask().astype(np.float64)
            csq_zero = np.asarray(zmask @ Ah.multiply(Ah)).ravel()
            psym = pack_bell_sym_host(Ph, bs, np_dtype) if has_P else None
            return packed, csq_zero, psym, bh, ch, spec_hat, scal

        # per-problem independent; the native packer and the large numpy
        # ops release the GIL
        with ThreadPoolExecutor(max_workers=min(8, B)) as ex:
            prepped = list(ex.map(prep_one, range(B)))

        def stack_padded(blocks_list, cols_list, n_blocks):
            blocks, cols = stack_bell_host(blocks_list, cols_list)
            return (
                torch.as_tensor(blocks, dtype=dtype, device=dev),
                _cols_tensor(cols, n_blocks, dev),
            )

        def stacked(vals):
            return torch.as_tensor(np.stack(vals), dtype=dtype, device=dev)

        packs = [p[0] for p in prepped]  # (Ab, Ac, Atb, Atc, col_sq, row_sq)
        nbr, nbc = packs[0][0].shape[0], packs[0][2].shape[0]
        A_blocks, A_cols = stack_padded([p[0] for p in packs], [p[1] for p in packs], nbc)
        At_blocks, At_cols = stack_padded([p[2] for p in packs], [p[3] for p in packs], nbr)
        bell = BellData(
            A_blocks=A_blocks,
            A_cols=A_cols,
            At_blocks=At_blocks,
            At_cols=At_cols,
            colsq_all=stacked([p[4] for p in packs]),
            colsq_zero=stacked([p[1] for p in prepped]),
        )
        pbell = None
        if has_P:
            psyms = [p[2] for p in prepped]
            p_blocks, p_cols = stack_padded(
                [q[0] for q in psyms], [q[1] for q in psyms], psyms[0][0].shape[0]
            )
            pbell = PBell(blocks=p_blocks, cols=p_cols, diag=stacked([q[2] for q in psyms]))
        scals = [p[6] for p in prepped]
        spec_hats = [p[5] for p in prepped]
        return Mats(
            bn=stacked([p[3] for p in prepped]),
            cn=stacked([p[4] for p in prepped]),
            bl=stacked([np.asarray(s.bl, np.float64) for s in spec_hats]),
            bu=stacked([np.asarray(s.bu, np.float64) for s in spec_hats]),
            D=stacked([np.asarray(s.D) for s in scals]),
            E=stacked([np.asarray(s.E) for s in scals]),
            sc_b=stacked([float(s.sc_b) for s in scals]),
            sc_c=stacked([float(s.sc_c) for s in scals]),
            norm_b=stacked([float(np.linalg.norm(bi)) for bi in b]),
            norm_c=stacked([float(np.linalg.norm(ci)) for ci in c]),
            bell=bell,
            pbell=pbell,
        )

    def reset(self):
        """Re-initialize all solver states (cold start): g at the initial
        scale against the cached factorization (or by CG), then fresh
        iterates."""
        self._states = self.core.init_state(self.mats, L=self._L)
        self.core._sync("setup_sync")

    def phase_times(self):
        """Measured time of each phase for the WHOLE batch, in seconds per
        batched call: the linear step, the cone step and the AA trial (the
        iteration tail of a state doctored so the trial fires) at the
        batch's true shape, each one warm call and then the mean of 5, each
        call ended by a device synchronize. Multiply by the iteration count
        for a per-phase breakdown — the batched analogue of the reference's
        lin_sys/cone/accel timers (scs/scsobject.h:1088-1092). Cached."""
        if self._phase_cache is not None:
            return self._phase_cache
        if self._states is None:
            self.reset()
        core = self.core

        def time5(call):
            return mean_call_time(call, core._sync)

        st, mats = self._states, self.mats
        lin_out = core._step_lin(st, mats)
        t_lin = time5(lambda: core._step_lin(st, mats))
        t_cone = time5(lambda: core._step_cone(st, *lin_out, mats))
        t_accel = 0.0
        if core.lookback > 0:
            std = core._doctored_trial_state(st)
            st1 = core._step_cone(std, *core._step_lin(std, mats), mats)
            t_accel = time5(lambda: core._iter_tail(std, st1, mats))
        self._phase_cache = {"lin_sys": t_lin, "cone": t_cone, "accel_trial": t_accel}
        return self._phase_cache

    def update(self, b=None, c=None):
        """Update b and/or c for the whole batch, re-scaled with the stored
        equilibration; the factor (or the packs) is reused and only g is
        recomputed — no factorization runs (scs_tpu BatchedSCS.update)."""
        mats = self.mats

        def t(a, k):
            a = np.asarray(a, np.float64).reshape(self.B, k)
            out = torch.as_tensor(a, dtype=self._dtype, device=self._device)
            trace.uploaded(self._device, "update_upload")
            return out

        if b is not None:
            b = t(b, self.m)
            mats = mats._replace(
                bn=mats.sc_b[:, None] * mats.D * b,
                norm_b=torch.linalg.vector_norm(b, dim=1),
            )
        if c is not None:
            c = t(c, self.n)
            mats = mats._replace(
                cn=mats.sc_c[:, None] * mats.E * c,
                norm_c=torch.linalg.vector_norm(c, dim=1),
            )
        self.mats = mats
        self.reset()

    # -- result building ---------------------------------------------------

    def _materialize(self, results, positions, pack, mask, elapsed, interrupted=False):
        """Host side of finalization: read a finalize pack and build result
        dicts. mask: which rows of the current batch to store (None = all);
        rows whose original position already holds a result (compaction
        padding duplicates) are skipped."""
        host = []
        for a in pack:
            host.append(a.detach().cpu().numpy())
            trace.host_sync("results")
        x, y, s, x_cert, y_cert, s_cert, scal = host
        timers = self.phase_times() if self.stg.phase_timing == "always" else None
        lookback = self.core.lookback
        interval = max(self.core.interval, 1)
        for i in range(len(positions)):
            if mask is not None and not mask[i]:
                continue
            pos = int(positions[i])
            if results[pos] is not None:
                continue
            row = scal[i]
            st = int(row[0])
            it = int(row[1])
            if st == info_mod.UNFINISHED:
                if interrupted and it < int(self.stg.max_iters):
                    # Ctrl-C mid-batch: unfinished problems report SIGINT
                    # with their current iterates
                    st = info_mod.SIGINT
                else:
                    st = {
                        info_mod.SOLVED: info_mod.SOLVED_INACCURATE,
                        info_mod.INFEASIBLE: info_mod.INFEASIBLE_INACCURATE,
                        info_mod.UNBOUNDED: info_mod.UNBOUNDED_INACCURATE,
                    }.get(int(row[2]), info_mod.SOLVED_INACCURATE)
            if st in (info_mod.INFEASIBLE, info_mod.INFEASIBLE_INACCURATE):
                xi, yi, si = np.full(self.n, np.nan), y_cert[i], np.full(self.m, np.nan)
            elif st in (info_mod.UNBOUNDED, info_mod.UNBOUNDED_INACCURATE):
                xi, yi, si = x_cert[i], np.full(self.m, np.nan), s_cert[i]
            else:
                xi, yi, si = x[i], y[i], s[i]
            if lookback > 0:
                aa_stats = {
                    "iter": int(row[14]),
                    "n_accept": int(row[15]),
                    "n_reject_lapack": 0,
                    "n_reject_rank0": 0,
                    "n_reject_nonfinite": int(row[16]),
                    "n_reject_weight_cap": int(row[17]),
                    "n_safeguard_reject": int(row[18]),
                    "last_rank": int(min(max(int(row[19]), 0), lookback)),
                    "last_aa_norm": float(row[20]),
                    "last_regularization": float(row[21]),
                }
            else:
                aa_stats = info_mod.default_aa_stats()
            rejected = (
                aa_stats["n_safeguard_reject"]
                + aa_stats["n_reject_nonfinite"]
                + aa_stats["n_reject_weight_cap"]
            )
            kw = {}
            if timers is not None:
                # the timers are per batched call at the initial size; the
                # per-problem share scales by 1/B
                aa_trials = it // interval if lookback > 0 else 0
                kw = dict(
                    lin_sys_time=timers["lin_sys"] * it / self.B,
                    cone_time=timers["cone"] * it / self.B,
                    accel_time=timers["accel_trial"] * aa_trials / self.B,
                )
            info = info_mod.make_info(
                st,
                it,
                scale_updates=int(row[3]),
                scale=float(row[4]),
                pobj=float(row[5]),
                dobj=float(row[6]),
                res_pri=float(row[7]),
                res_dual=float(row[8]),
                gap=float(row[9]),
                res_infeas=float(row[10]),
                res_unbdd_a=float(row[11]),
                res_unbdd_p=float(row[12]),
                comp_slack=float(row[13]),
                solve_time=elapsed,
                setup_time=self._setup_time,
                accepted_accel_steps=aa_stats["n_accept"],
                rejected_accel_steps=rejected,
                aa_stats=aa_stats,
                **kw,
            )
            results[pos] = {"x": xi.copy(), "y": yi.copy(), "s": si.copy(), "info": info}

    def polish(self, results, sub_batch=32, eps_reg=1e-6, refine=3):
        """Active-set polish of solved results (scs_tpu BatchedSCS.polish):
        one masked-KKT solve with compensated refinement per problem,
        reaching ~f32-ulp KKT residuals without iterating the DR tail below
        the f32 floor (polish.py). Zero + nonneg cones, direct strategy,
        float32 only; otherwise the results come back unchanged with an
        all-False mask, as in scs_tpu. A polished point that fails
        verification (the sign conditions, or residuals no better than the
        unpolished point's) is not taken.

        Runs in normalized space against the solver's own equilibrated
        operator of the full batch (`self.mats`, indexed by the problems'
        positions in the original batch), then un-normalizes; sub-batched
        because the Schur transients are (sub, m, m). Returns (results,
        polished_mask)."""
        from . import polish as polish_mod  # noqa: PLC0415

        spec = self.spec
        if (
            spec.dim != spec.z + spec.l
            or self.core.indirect
            or self._dtype != torch.float32
        ):
            return results, np.zeros(self.B, bool)

        zero_mask = np.asarray(spec.zero_row_mask())
        mats = self.mats
        D = mats.D.double().cpu().numpy()
        E = mats.E.double().cpu().numpy()
        sc_b = mats.sc_b.double().cpu().numpy()
        sc_c = mats.sc_c.double().cpu().numpy()

        polished = np.zeros(self.B, bool)
        for lo in range(0, self.B, sub_batch):
            hi = min(lo + sub_batch, self.B)
            sl = np.asarray([
                i for i in range(lo, hi)
                if results[i] is not None
                and results[i]["info"]["status"] in ("solved", "solved_inaccurate")
            ], np.int64)
            if not sl.size:
                continue
            # active mask from the original-unit complementarity test (y_i >
            # s_i picks the binding constraint; row scalings would bias the
            # comparison in normalized space)
            d_np = np.stack([
                zero_mask | (np.asarray(results[i]["y"]) > np.asarray(results[i]["s"]))
                for i in sl
            ])
            gather = torch.as_tensor(sl, device=self._device)
            A_s = mats.A.index_select(0, gather)
            P_s = mats.P.index_select(0, gather) if self.has_P else None
            b_s = mats.bn.index_select(0, gather)
            c_s = mats.cn.index_select(0, gather)

            def dev(a):
                return torch.as_tensor(a, dtype=self._dtype, device=self._device)

            xh, yh, sh, ok = polish_mod.polish_batch(
                A_s, P_s, b_s, c_s, dev(d_np), zero_mask, eps_reg=eps_reg, refine=refine,
            )
            # exact original-unit residual norms of the normalized point:
            # each row weighted by its inverse equilibration
            wr = dev(1.0 / (D[sl] * sc_b[sl, None]))
            wc = dev(1.0 / (E[sl] * sc_c[sl, None]))
            rp, rd, _ = polish_mod.kkt_errors(A_s, P_s, b_s, c_s, xh, yh, sh, wr=wr, wc=wc)
            xh, yh, sh, rp, rd = (
                a.double().cpu().numpy() for a in (xh, yh, sh, rp, rd)
            )
            ok = ok.cpu().numpy()
            ch_all = c_s.double().cpu().numpy()
            bh_all = b_s.double().cpu().numpy()
            for k, i in enumerate(sl):
                if not ok[k]:
                    continue
                info = results[i]["info"]
                rp_orig, rd_orig = float(rp[k]), float(rd[k])
                if rp_orig > max(info["res_pri"], 1e-9) or rd_orig > max(
                    info["res_dual"], 1e-9
                ):
                    continue  # polish did not improve: keep the original
                x_o = E[i] * xh[k] / sc_b[i]
                y_o = D[i] * yh[k] / sc_c[i]
                s_o = sh[k] / (D[i] * sc_b[i])
                results[i]["x"], results[i]["y"], results[i]["s"] = x_o, y_o, s_o
                info["res_pri"] = rp_orig
                info["res_dual"] = rd_orig
                info["comp_slack"] = float(abs(np.dot(s_o, y_o)))
                # objectives of the polished point in original units, in f64
                # on the host: pobj = (0.5 x'P x + c'x) / (sc_b sc_c) and the
                # true dual objective dobj = (-0.5 x'P x - b'y) / (sc_b sc_c)
                quad = 0.0
                if self.has_P:
                    Ph = P_s[k].double().cpu().numpy()
                    quad = 0.5 * xh[k] @ (Ph @ xh[k])
                sc = sc_b[i] * sc_c[i]
                info["pobj"] = float((quad + ch_all[k] @ xh[k]) / sc)
                info["dobj"] = float((-quad - bh_all[k] @ yh[k]) / sc)
                info["gap"] = float(abs(info["pobj"] - info["dobj"]))
                info["status"] = "solved"
                info["status_val"] = info_mod.SOLVED
                polished[i] = True
        return results, polished

    @staticmethod
    def _compact(states, mats, idx):
        """Retirement compaction: the surviving rows of every state and
        mats leaf."""
        return _gather(states, idx), _gather(mats, idx)

    def solve(self):
        """Solve the batch. With compaction enabled (at B >= 2*_MIN_BUCKET),
        finished problems are retired at segment boundaries and the
        survivors are re-packed into a smaller batch; per-problem
        `solve_time` is the wall-clock until that problem's retirement.
        Recorded as the span `batch.solve` (trace.py), its segments, probes,
        rescales, finalizations, compactions and result building as its
        children."""
        with trace.span("batch.solve", batch=self._batch, B=self.B):
            if self._states is None:
                self.reset()
            return self._solve_loop()

    def _solve_loop(self):
        core = self.core
        t0 = time.perf_counter()
        states, mats = self._states, self.mats
        B = self.B
        positions = np.arange(B)
        results: list = [None] * B
        max_iters = int(self.stg.max_iters)
        check_interval = int(self.stg.check_interval)
        compact = bool(self.stg.batch_compaction) and B >= 2 * self._MIN_BUCKET
        seg = max(1, int(self.stg.batch_compact_interval))
        pending = []  # (finalize pack, positions, mask, elapsed)
        # lockstep cost: sum over segments of (batch size x iterations run)
        self.device_prob_iters = 0
        # batch sizes the solve ran at: B, then each compaction's bucket
        self.bucket_ladder = [B]
        prev_maxit = 0

        def seg_len(cur):
            # at the ladder floor only termination is left to detect: run
            # several chunks per host poll
            if compact and cur <= self._MIN_BUCKET:
                return max(seg, 8)
            return seg

        def probe_of(st):
            with trace.span("solve.probe"):
                out = torch.stack([
                    st.status.to(torch.float64),
                    st.it.to(torch.float64),
                    st.rescale_trigger.to(torch.float64),
                ]).cpu().numpy()
                trace.host_sync("probe")
            return out

        def finalize(st, mats, positions, mask):
            with trace.span("solve.finalize"):
                pending.append((core.finalize_pack(st, mats), positions, mask,
                                time.perf_counter() - t0))

        # The next segment runs before this segment's probe is read, and
        # the probe's decisions (rescale, retirement) act on that next
        # state: scs_tpu's speculative pipeline, kept so that a rescale
        # lands on the same iteration as there.
        time_limit = float(self.stg.time_limit_secs or 0.0)
        interrupted = False
        try:
            states = core.run_seg(states, mats, max_iters, seg_len(B))
            while True:
                nxt = core.run_seg(states, mats, max_iters, seg_len(len(positions)))
                status_np, it_np, trig_np = probe_of(states)
                max_it_now = int(it_np.max())
                chunks_run = -(-(max_it_now - prev_maxit) // max(check_interval, 1))
                self.device_prob_iters += len(positions) * chunks_run * check_interval
                prev_maxit = max_it_now
                done = (status_np != UNFINISHED) | (it_np >= max_iters)
                timed_out = bool(time_limit and (time.perf_counter() - t0) > time_limit)
                if done.all() or timed_out:
                    finalize(states, mats, positions, None)
                    break
                states = nxt
                if trig_np.any():
                    # some problem's adaptive scale drifted: apply the
                    # decision recorded in the (next) state
                    with trace.span("solve.rescale"):
                        states = core.rescale_step(states, mats)
                if not compact:
                    continue
                n_act = int((~done).sum())
                cur = len(positions)
                target = cur
                while target // 2 >= max(n_act, self._MIN_BUCKET):
                    target //= 2
                if target < cur:
                    # retire the finished problems (frozen in `states`, so
                    # their pack is final), then compact the rest
                    finalize(states, mats, positions, done)
                    with trace.span("solve.compact", bucket=target):
                        active = np.where(~done)[0]
                        pad = np.full(target - n_act, active[0], dtype=np.int64)
                        idx = np.concatenate([active, pad])
                        idx_dev = torch.as_tensor(idx, device=self._device)
                        trace.uploaded(self._device, "compact_upload")
                        states, mats = self._compact(states, mats, idx_dev)
                    positions = positions[idx]
                    self.bucket_ladder.append(target)
        except KeyboardInterrupt:
            interrupted = True
            # finalize the in-flight state so partial results are returned
            finalize(states, mats, positions, None)
        with trace.span("solve.results"):
            for pack, pos, mask, el in pending:
                self._materialize(results, pos, pack, mask, el, interrupted=interrupted)
        # states are compacted/finished now; a later solve() cold-starts
        self._states = None
        return results


def _stack_dense(mats):
    """A list of dense or scipy sparse matrices as one (B, r, c) array."""
    return np.stack([
        np.asarray(M.todense() if hasattr(M, "todense") else M) for M in mats
    ])


def solve_batch(data, cone, **settings):
    """One-shot batched solve over B same-shape problems."""
    return BatchedSCS(data, cone, **settings).solve()
