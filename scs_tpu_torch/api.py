"""Public API: the SCS class, scs.solve(), and the LinearSolver enum.

The port of scs_tpu/api.py: the same constructor and data validation
(CSC acceptance with warning, sparse b/c flattening, P upper-triangle
extraction), the same solve()/update() signatures and the same info dict.

All three strategies run: "direct" (dense Cholesky, or the precomputed
inverse with direct_solver="inverse"), "indirect" (matrix-free CG on dense
A) and "bell" (block-ELL matrix-free CG); float32 below eps 3e-5 on a dense
strategy is the compensated high-accuracy mode (Core.hi_acc). Two loops
drive a solve: the chunked loop (one check every check_interval
iterations), and with phase_timing="always" the instrumented loop (each
phase of every iteration timed to a device synchronize, one check, CSV row
and verbose line per iteration).
"""

from __future__ import annotations

import enum
import threading
import time
import warnings

import numpy as np
import torch
from scipy import sparse

from . import info as info_mod
from . import native
from .cones import ConeSpec
from .io import CsvLogger, print_footer, print_header, print_iter_line, write_problem
from .normalize import identity_scaling, ruiz_equilibrate, ruiz_equilibrate_sparse
from .settings import Settings
from .solver import BellData, Core, Mats


class LinearSolver(enum.Enum):
    """Linear system solver backend (reference names; strategy mapping).

    Reference: scs/py/__init__.py:28-37. Direct backends (QDLDL, MKL,
    ACCELERATE, CPU_DENSE, CUDSS) map to the dense Cholesky strategy;
    indirect backends (CPU_INDIRECT, GPU_INDIRECT) map to matrix-free CG.
    """

    AUTO = "auto"
    QDLDL = "qdldl"
    CPU_INDIRECT = "cpu_indirect"
    MKL = "mkl"
    ACCELERATE = "accelerate"
    CPU_DENSE = "cpu_dense"
    GPU_INDIRECT = "gpu_indirect"
    CUDSS = "cudss"
    # scs_tpu names
    DENSE_DIRECT = "dense_direct"
    PALLAS_CG = "pallas_cg"


# "auto" phase timers (SCS._pipelined_loop): rounds are timed once a solve
# is past this many seconds, R rounds at each stride
PHASE_SAMPLE_AFTER = 0.3
PHASE_SAMPLE_ROUNDS = 4

_DIRECT = {
    LinearSolver.QDLDL,
    LinearSolver.MKL,
    LinearSolver.ACCELERATE,
    LinearSolver.CPU_DENSE,
    LinearSolver.CUDSS,
    LinearSolver.DENSE_DIRECT,
}
_INDIRECT = {
    LinearSolver.CPU_INDIRECT,
    LinearSolver.GPU_INDIRECT,
    LinearSolver.PALLAS_CG,
}

def _block_ell_stats(A_csc, bs):
    """Estimated element counts of the block-ELL pack of (A, A^T) vs the
    dense representation. O(nnz); drives the AUTO bell-vs-indirect choice:
    scalar density is misleading because an unstructured matrix at density
    0.01 still touches essentially every (128, 128) tile."""
    m, n = A_csc.shape
    nbr, nbc = -(-m // bs), -(-n // bs)
    coo = A_csc.tocoo()
    pids = np.unique(
        (coo.row // bs).astype(np.int64) * nbc + (coo.col // bs)
    )
    rcounts = np.bincount((pids // nbc).astype(np.intp), minlength=nbr)
    ccounts = np.bincount((pids % nbc).astype(np.intp), minlength=nbc)
    wA = max(int(rcounts.max()) if nbr else 0, 1)
    wAt = max(int(ccounts.max()) if nbc else 0, 1)
    packed = (nbr * wA + nbc * wAt) * bs * bs
    return packed, m * n


def _resolve_strategy(linear_solver, m, n, A_csc=None, bell_bs=128) -> str:
    if isinstance(linear_solver, str):
        linear_solver = LinearSolver(linear_solver)
    if linear_solver in _DIRECT:
        return "direct"
    if linear_solver in _INDIRECT:
        return "indirect"
    # AUTO heuristic (scs_tpu's): dense factorization for moderate n; for
    # large problems, matrix-free CG — via the block-ELL SpMV when the
    # measured block structure makes the pack meaningfully smaller than
    # dense (SpMV is bandwidth-bound, so packed size is the cost model).
    if n <= 4096:
        return "direct"
    if A_csc is None:
        return "indirect"
    packed, dense = _block_ell_stats(A_csc, bell_bs)
    return "bell" if packed <= 0.25 * dense else "indirect"


def _has_lower_tri(P):
    """Fast check for strictly-lower-triangular entries in sorted CSC
    (mirrors reference _has_lower_tri, scs/py/__init__.py:77-84)."""
    if native.available:
        return native.has_lower_tri(P.indptr, P.indices, P.shape[1])
    nnz_per_col = np.diff(P.indptr)
    nonempty = nnz_per_col > 0
    if not nonempty.any():
        return False
    last_row = P.indices[P.indptr[1:][nonempty] - 1]
    return bool(np.any(last_row > np.where(nonempty)[0]))


class SCS:
    """Conic QP solver instance (workspace + setup + warm-start store) —
    the counterpart of the reference SCS object (scs/py/__init__.py:87 +
    scs/scsobject.h SCS_init/SCS_solve)."""

    def __init__(self, data, cone, **settings):
        if not data or not cone:
            raise ValueError("Missing data or cone information")
        if "b" not in data or "c" not in data:
            raise ValueError("Missing one of b, c from data dictionary")
        if "A" not in data:
            raise ValueError("Missing A from data dictionary")

        A = data["A"]
        b = data["b"]
        c = data["c"]
        if A is None or b is None or c is None:
            raise ValueError("Incomplete data specification")

        # Reference parity: dense (ndarray) A raises TypeError
        # (scs/py/__init__.py:117-118) unless allow_dense_input=True.
        dense_ok = settings.pop("allow_dense_input", False)
        if not sparse.issparse(A):
            if not dense_ok or not isinstance(A, np.ndarray):
                raise TypeError("A is required to be a sparse matrix")
            self._A_input = sparse.csc_matrix(np.asarray(A, np.float64))
        else:
            if A.format != "csc":
                warnings.warn(
                    "Converting A to a CSC (compressed sparse column) matrix;"
                    " may take a while."
                )
                A = A.tocsc()
            if not A.has_sorted_indices:
                A = A.sorted_indices()
            self._A_input = A

        if sparse.issparse(b):
            b = np.asarray(b.todense()).ravel()
        if sparse.issparse(c):
            c = np.asarray(c.todense()).ravel()
        b = np.asarray(b, np.float64).ravel()
        c = np.asarray(c, np.float64).ravel()
        m, n = len(b), len(c)
        if m <= 0 or n <= 0:
            raise ValueError("m and n must be positive")
        if self._A_input.shape != (m, n):
            raise ValueError("A shape not compatible with b,c")

        P_triu = None
        if "P" in data and data["P"] is not None:
            P = data["P"]
            if not sparse.issparse(P):
                if not dense_ok or not isinstance(P, np.ndarray):
                    raise TypeError("P is required to be a sparse matrix")
                P = sparse.csc_matrix(np.asarray(P, np.float64))
            if P.shape != (n, n):
                raise ValueError("P shape not compatible with A,b,c")
            if P.format != "csc":
                warnings.warn(
                    "Converting P to a CSC (compressed sparse column) "
                    "matrix; may take a while."
                )
                P = P.tocsc()
            if not P.has_sorted_indices:
                P = P.sorted_indices()
            if _has_lower_tri(P):
                P = sparse.triu(P, format="csc")
            P_triu = P

        linear_solver = settings.pop("linear_solver", LinearSolver.AUTO)
        self.stg = Settings.from_kwargs(**settings)
        strategy = (
            self.stg.solver_strategy
            if self.stg.solver_strategy != "auto"
            else _resolve_strategy(
                linear_solver, m, n, self._A_input, self.stg.bell_block_size
            )
        )
        spec = ConeSpec.from_dict(cone)
        if spec.dim != m:
            raise ValueError(
                f"Total cone dimension {spec.dim} does not match length of b ({m})"
            )
        self.stg.solver_strategy = strategy
        # Instrumented mode: real per-phase timers and one CSV row / verbose
        # line per iteration need a check after every iteration
        if self.stg.phase_timing == "always":
            self.stg.check_interval = 1

        self.spec = spec
        self.m, self.n = m, n
        self._cone_dict = dict(cone)
        self._b_orig, self._c_orig = b, c

        t0 = time.perf_counter()
        self._device = torch.device(self.stg.device)
        dtype = torch.float64 if self.stg.dtype == "float64" else torch.float32
        self._dtype = dtype
        has_P = P_triu is not None
        self.has_P = has_P

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=self._device)

        bell = pbell = Ah = Ph = None
        if strategy == "bell":
            # Fully sparse preprocessing: equilibration, preconditioner sums
            # and the block-ELL packs all run on CSC data — the dense (m, n)
            # array is never formed, host or device.
            P_full = None
            if has_P:
                U = P_triu
                P_full = (U + U.T - sparse.diags(U.diagonal())).tocsc()
            if self.stg.normalize:
                Ah_sp, Ph_sp, bh, ch, scal, spec_hat = ruiz_equilibrate_sparse(
                    self._A_input, P_full, b, c, spec
                )
            else:
                scal = identity_scaling(m, n)
                Ah_sp, Ph_sp, bh, ch, spec_hat = self._A_input, P_full, b, c, spec
            bell, pbell = self._build_bell(Ah_sp, Ph_sp, spec_hat, dtype)
        else:
            A_dense = (
                native.csc_to_dense(self._A_input)
                if native.available
                else np.asarray(self._A_input.todense())
            )
            P_dense = None
            if has_P:
                # P holds the upper triangle; expand to the full symmetric
                # matrix for the dense path
                if native.available:
                    P_dense = native.csc_triu_to_dense_sym(P_triu)
                else:
                    U = np.asarray(P_triu.todense())
                    P_dense = U + U.T - np.diag(np.diag(U))
            # normalization is host-side numpy preprocessing, as in scs_tpu
            if self.stg.normalize:
                Ah, Ph, bh, ch, scal, spec_hat = ruiz_equilibrate(
                    A_dense, P_dense, b, c, spec
                )
            else:
                scal = identity_scaling(m, n)
                Ah, Ph, bh, ch, spec_hat = A_dense, P_dense, b, c, spec
            Ah = self._place_dense(t, Ah)
            Ph = t(Ph).contiguous() if has_P else None
        self._scal = scal
        self._spec_hat = spec_hat
        self._sc_prod = float(np.asarray(scal.sc_b) * np.asarray(scal.sc_c))

        self.mats = Mats(
            bell=bell,
            pbell=pbell,
            A=Ah,
            P=Ph,
            bn=t(bh),
            cn=t(ch),
            bl=t(spec_hat.bl),
            bu=t(spec_hat.bu),
            D=t(scal.D),
            E=t(scal.E),
            sc_b=t(scal.sc_b),
            sc_c=t(scal.sc_c),
            norm_b=t(np.linalg.norm(b)),
            norm_c=t(np.linalg.norm(c)),
        )

        self.core = self._make_core(m, n, has_P, spec_hat)
        # setup: the factorization (direct) and g
        self._state0 = self.core.init_state(self.mats)
        self.core._sync()
        self._setup_time = time.perf_counter() - t0
        self._warm = None  # (u, v, scale) from the previous solve
        self._last_state = None
        self._measured_phases = None  # (lin, cone, accel) s of an instrumented solve
        # Per-instance lock serializing solve/update on a shared instance —
        # the counterpart of the reference's PyThread_type_lock discipline
        # (scs/scsobject.h:12, 939-955).
        self._lock = threading.RLock()

        if self.stg.write_data_filename and self._logs:
            write_problem(
                self.stg.write_data_filename,
                {"A": self._A_input, "b": b, "c": c, "P": data.get("P")},
                cone,
                {
                    k: getattr(self.stg, k)
                    for k in (
                        "max_iters",
                        "eps_abs",
                        "eps_rel",
                        "eps_infeas",
                        "alpha",
                        "scale",
                        "rho_x",
                        "normalize",
                        "adaptive_scale",
                    )
                },
            )

    # -- subclass hooks (parallel.ShardedSCS overrides them) ----------------

    _logs = True  # this instance prints, writes the CSV and the problem file

    def _make_core(self, m, n, has_P, spec_hat):
        """The solver core; ShardedSCS substitutes a row-sharded one."""
        return Core(m, n, has_P, spec_hat, self.stg)

    def _place_dense(self, t, Ah):
        """The equilibrated dense A on the solver's device (`t` converts a
        host array); ShardedSCS places only this rank's rows."""
        return t(Ah).contiguous()

    def _rank0(self, flag):
        """A host decision taken from this process's clock, as the caller
        computed it; ShardedSCS takes rank 0's on every rank."""
        return flag

    def _build_bell(self, Ah_sp, Ph_sp, spec_hat, dtype):
        """Pack the equilibrated sparse operator into block-ELL form on the
        solver's device. Returns (bell, pbell)."""
        from .ops.sparse import pack_bell, pack_bell_sym  # noqa: PLC0415

        bs, dev = self.stg.bell_block_size, self._device
        bm = pack_bell(Ah_sp, bs, dtype, dev)
        zmask = spec_hat.zero_row_mask().astype(np.float64)
        Asq = Ah_sp.multiply(Ah_sp)  # sparse elementwise square
        colsq_zero = np.asarray(zmask @ Asq).ravel()
        bell = BellData(
            A_blocks=bm.A_blocks,
            A_cols=bm.A_cols,
            At_blocks=bm.At_blocks,
            At_cols=bm.At_cols,
            colsq_all=bm.col_sq,
            colsq_zero=torch.as_tensor(colsq_zero, dtype=dtype, device=dev),
        )
        pbell = None
        if Ph_sp is not None:
            pbell = pack_bell_sym(Ph_sp, bs, dtype, dev)
        return bell, pbell

    # -- warm start plumbing ----------------------------------------------

    def _warm_state(self, x, y, s):
        """Map user-provided (x, y, s) into normalized embedding (u, v)."""
        n, m = self.n, self.m
        scal = self._scal
        u = np.zeros(self.core.N)
        v = np.zeros(self.core.N)
        u[-1] = 1.0
        if x is not None:
            u[:n] = scal.sc_b * np.asarray(x, np.float64) / scal.E
        if y is not None:
            u[n : n + m] = scal.sc_c * np.asarray(y, np.float64) / scal.D
        if s is not None:
            st_hat = scal.sc_b * scal.D * np.asarray(s, np.float64)
            ry = np.where(
                np.asarray(self.spec.zero_row_mask()),
                1e-3 / self.stg.scale,
                1.0 / self.stg.scale,
            )
            v[n : n + m] = st_hat / ry
        return u, v

    # -- main entry points -------------------------------------------------

    def solve(self, warm_start=True, x=None, y=None, s=None):
        """Run the solver. Mirrors reference SCS.solve
        (scs/py/__init__.py:186-203). Thread-safe: concurrent calls on a
        shared instance are serialized by the per-instance lock."""
        with self._lock:
            return self._solve_locked(warm_start, x, y, s)

    def _solve_locked(self, warm_start, x, y, s):
        core, mats, stg = self.core, self.mats, self.stg
        t0 = time.perf_counter()

        # every path reuses the cached cold-start state (and with it the
        # setup computed at __init__/update time)
        if warm_start and (x is not None or y is not None or s is not None):
            warm_u, warm_v = self._warm_state(x, y, s)
            state = core.with_warm(self._state0, warm_u, warm_v)
        elif warm_start and self._warm is not None:
            warm_u, warm_v, warm_scale = self._warm
            # the stored v lives in the final adaptive-scale metric; map its
            # y block into the fresh metric (s_hat = r_y * v_y invariant)
            n, m = self.n, self.m
            warm_v = warm_v.clone()
            warm_v[n : n + m] *= float(self.stg.scale) / warm_scale
            state = core.with_warm(self._state0, warm_u, warm_v)
        else:
            state = self._state0

        interrupted = False
        verbose = stg.verbose and self._logs
        csv = (
            CsvLogger(stg.log_csv_filename)
            if stg.log_csv_filename and self._logs
            else None
        )

        if verbose:
            print_header(
                stg, self.m, self.n, self.spec,
                {
                    "direct": f"dense-cholesky direct ({core.device})",
                    "indirect": f"matrix-free CG, dense ({core.device})",
                    "bell": f"matrix-free CG, block-ELL SpMV ({core.device})",
                }[stg.solver_strategy],
                "1.0.0",
            )

        self._measured_phases = None
        self._sampling_time = 0.0
        self._last_state = state
        try:
            if stg.phase_timing == "always":
                state = self._instrumented_loop(state, core, mats, stg, csv, verbose, t0)
            else:
                state = self._pipelined_loop(state, core, mats, stg, csv, verbose, t0)
        except KeyboardInterrupt:
            interrupted = True
            state = self._last_state
        finally:
            if csv is not None:
                csv.close()

        # the "auto" timers' rounds are not the solve's time
        solve_time = time.perf_counter() - t0 - self._sampling_time
        out = self._build_solution(state, solve_time, interrupted)
        if verbose:
            print_footer(out["info"])
        return out

    def _pipelined_loop(self, state, core, mats, stg, csv, verbose, t0):
        """Host loop of chunks (check_interval iterations and one check
        each) until termination, max_iters or the time limit. A
        KeyboardInterrupt lands between device calls and maps to the
        SIGINT status, like the reference's ctrlc.c handler. Under "auto"
        timers, once the solve is verbose or past PHASE_SAMPLE_AFTER
        seconds, one round of the instrumented sequence is timed after
        chunks 1..R, then at a stride that doubles every R scheduled chunks
        (R = PHASE_SAMPLE_ROUNDS), each standing for its stride's chunks
        (Core.phase_sample): O(R log chunks) rounds spread over the whole
        solve, their time left out of the solve's. The schedule counts
        chunks, so the ranks of a sharded solve take their rounds
        together."""
        sampling = stg.phase_timing == "auto"
        core._phase_samples = []
        chunk, at, stride, points, on = 0, 1, 1, 0, False
        while True:
            state = core._chunk(state, mats)
            self._last_state = state
            done = state.status != info_mod.UNFINISHED or state.it >= stg.max_iters
            el = time.perf_counter() - t0 - self._sampling_time
            chunk += 1
            if sampling and chunk == at:
                on = on or self._rank0(stg.verbose or el > PHASE_SAMPLE_AFTER)
                if on:
                    ts = time.perf_counter()
                    core.phase_sample(state, mats, stride)
                    self._sampling_time += time.perf_counter() - ts
                points += 1
                if points % PHASE_SAMPLE_ROUNDS == 0:
                    stride *= 2
                at += stride
            if verbose or csv is not None:
                # ONE device read per chunk
                self._log_check(self._probe_values(state), el, verbose, csv)
            if done or (stg.time_limit_secs and self._rank0(el > stg.time_limit_secs)):
                return state

    def _instrumented_loop(self, state, core, mats, stg, csv, verbose, t0):
        """Per-iteration split-phase loop (phase_timing="always"): the
        linear step, the cone step and the iteration tail (AA bookkeeping
        and trial) each run and are timed to a device synchronize, so
        lin_sys/cone/accel times are real accumulated wall-clock (the
        reference's in-loop timers, scsobject.h:1088-1092); accel time
        counts only iterations whose tail runs the AA trial. One check, one
        probe, one CSV row and one verbose line per iteration."""
        pc = time.perf_counter
        t_lin = t_cone = t_accel = 0.0
        trialing = core.lookback > 0
        while True:
            self._last_state = state
            ts = pc()
            lin = core._step_lin(state, mats)
            core._sync()
            t_lin += pc() - ts

            ts = pc()
            st1 = core._step_cone(state, *lin, mats)
            core._sync()
            t_cone += pc() - ts

            is_trial = trialing and (state.it + 1) % core.interval == 0
            ts = pc()
            state = core._iter_tail(state, st1, mats)
            core._sync()
            if is_trial:
                t_accel += pc() - ts

            state = core._check(state, mats)
            p = self._probe_values(state)  # ONE device read
            el = pc() - t0
            done = int(p[1]) != info_mod.UNFINISHED or int(p[0]) >= stg.max_iters
            self._log_check(p, el, verbose, csv)
            if done or (stg.time_limit_secs and self._rank0(el > stg.time_limit_secs)):
                break
        self._measured_phases = (t_lin, t_cone, t_accel)
        return state

    def _log_check(self, p, elapsed, verbose, csv):
        """The verbose line and the CSV row of one check, from its probe."""
        if verbose:
            print_iter_line(
                int(p[0]), float(p[2]), float(p[3]), float(p[4]),
                float(p[5]), float(p[7]), elapsed,
            )
        if csv is not None:
            self._write_csv_row(csv, p, elapsed)

    def _probe_values(self, state):
        """Every host-consumed scalar of one check, in one device read
        (Core._probe)."""
        return self.core._probe(state)

    def _write_csv_row(self, csv, p, elapsed):
        """Write one CSV row from a packed probe array (see
        _probe_values)."""
        # kappa in original units: kap_hat = v_tau lives in the normalized
        # embedding; un-scale like the objective (1/(sc_b*sc_c))
        sc = self._sc_prod
        tau = float(p[15])
        kap_hat = float(p[16])
        vals = {
            "iter": int(p[0]),
            "res_pri": float(p[2]),
            "res_dual": float(p[3]),
            "gap": float(p[4]),
            "ax_s_btau_nrm_inf": float(p[8]),
            "px_aty_ctau_nrm_inf": float(p[9]),
            "ax_s_btau_nrm_2": float(p[10]),
            "px_aty_ctau_nrm_2": float(p[11]),
            "res_infeas": float(p[12]),
            "res_unbdd_a": float(p[13]),
            "res_unbdd_p": float(p[14]),
            "pobj": float(p[5]),
            "dobj": float(p[6]),
            "tau": tau,
            "kap": kap_hat / max(sc, 1e-300),
            "res_pri_normalized": float(p[17]),
            "res_dual_normalized": float(p[18]),
            "gap_normalized": float(p[19]),
            "ax_s_btau_nrm_inf_normalized": float(p[20]),
            "px_aty_ctau_nrm_inf_normalized": float(p[21]),
            "ax_s_btau_nrm_2_normalized": float(p[22]),
            "px_aty_ctau_nrm_2_normalized": float(p[23]),
            "res_infeas_normalized": float(p[24]),
            "res_unbdd_a_normalized": float(p[25]),
            "res_unbdd_p_normalized": float(p[26]),
            "pobj_normalized": float(p[27]),
            "dobj_normalized": float(p[28]),
            "tau_normalized": tau,
            "kap_normalized": kap_hat,
            "scale": float(p[7]),
            "diff_u_ut_nrm_2": float(p[29]),
            "diff_v_v_prev_nrm_2": float(p[30]),
            "diff_u_ut_nrm_inf": float(p[31]),
            "diff_v_v_prev_nrm_inf": float(p[32]),
            "aa_norm": float(p[33]),
            "time": float(elapsed),
        }
        csv.write_row(vals)

    @staticmethod
    def _is_indeterminate(state, tau, kap) -> bool:
        """True when the iterate carries no signal: tau ~ 0 AND kappa ~ 0
        relative to the iterate norm (which _check renormalizes to
        sqrt(N), so the comparison is scale-free)."""
        nrm = float(torch.linalg.vector_norm(state.u)) + float(
            torch.linalg.vector_norm(state.v)
        )
        tiny = 1e-9 * max(nrm, 1e-300)
        return abs(tau) < tiny and abs(kap) < tiny

    def _build_solution(self, state, solve_time, interrupted):
        core, mats = self.core, self.mats
        x, y, s, x_cert, y_cert, s_cert, relaxed, diag = core._finalize(
            state, mats
        )
        status = state.status
        if interrupted:
            status = info_mod.SIGINT
        elif status == info_mod.UNFINISHED:
            # exhausted max_iters / time limit: classify best guess with
            # relaxed tolerances (reference *_inaccurate semantics)
            if relaxed == info_mod.SOLVED:
                status = info_mod.SOLVED_INACCURATE
            elif relaxed == info_mod.INFEASIBLE:
                status = info_mod.INFEASIBLE_INACCURATE
            elif relaxed == info_mod.UNBOUNDED:
                status = info_mod.UNBOUNDED_INACCURATE
            elif self._is_indeterminate(
                state, float(state.u[-1]), float(state.v[-1])
            ):
                # tau AND kappa collapsed with no certificate even at 1e3x
                # relaxed tolerances (reference INDETERMINATE = -3)
                status = info_mod.INDETERMINATE
            else:
                status = info_mod.SOLVED_INACCURATE

        def host(t):
            return t.detach().cpu().numpy().copy()

        # fresh writable host copies (reference parity: OWNDATA numpy
        # arrays, scsobject.h:1015-1043), in the solve dtype as scs_tpu
        nan_n = np.full(self.n, np.nan)
        nan_m = np.full(self.m, np.nan)
        if status in (info_mod.INFEASIBLE, info_mod.INFEASIBLE_INACCURATE):
            x_out, y_out, s_out = nan_n, host(y_cert), nan_m
        elif status in (info_mod.UNBOUNDED, info_mod.UNBOUNDED_INACCURATE):
            x_out, y_out, s_out = host(x_cert), nan_m, host(s_cert)
        else:
            x_out, y_out, s_out = host(x), host(y), host(s)

        # store the embedding state for warm starting the next solve
        self._warm = (state.u, state.v, float(state.scale))

        aa = state.aa
        aa_stats = {
            "iter": aa.aa_iter,
            "n_accept": aa.n_accept,
            # Structurally zero (as in scs_tpu): the AA least squares is a
            # Tikhonov-regularized Cholesky solve with no LAPACK error path
            # and no rank-0 early-out — a failed factorization surfaces as
            # NaN and lands in n_reject_nonfinite instead.
            "n_reject_lapack": 0,
            "n_reject_rank0": 0,
            "n_reject_nonfinite": aa.n_reject_nonfinite,
            "n_reject_weight_cap": aa.n_reject_weight_cap,
            "n_safeguard_reject": aa.n_safeguard_reject,
            "last_rank": int(min(max(aa.count, 0), core.lookback)),
            "last_aa_norm": float(aa.last_aa_norm),
            "last_regularization": float(aa.last_reg),
        }
        if core.lookback == 0:
            aa_stats = info_mod.default_aa_stats()

        # per-phase timing. phase_timing="always" ran the instrumented
        # loop: real accumulated per-phase wall-clock. "auto" estimates from
        # timed phase calls x the realized phase counts (Core.phase_times).
        lin_sys_time = cone_time = accel_time = 0.0
        stg = self.stg
        if self._measured_phases is not None:
            lin_sys_time, cone_time, accel_time = self._measured_phases
        elif stg.phase_timing == "auto" and (
            stg.verbose or self._rank0(solve_time > PHASE_SAMPLE_AFTER)
        ):
            pt = core.phase_times([self._state0, state], mats)
            # each iteration does one linear projection + one cone
            # projection; each AA trial adds a candidate solve + safeguard
            aa_trials = aa.aa_iter if core.lookback > 0 else 0
            lin_sys_time = pt["lin_sys"] * state.it
            cone_time = pt["cone"] * state.it
            accel_time = pt["accel_trial"] * aa_trials

        info = info_mod.make_info(
            status,
            state.it,
            scale_updates=state.scale_updates,
            scale=float(state.scale),
            pobj=float(diag.pobj),
            dobj=float(diag.dobj),
            res_pri=float(diag.res_pri),
            res_dual=float(diag.res_dual),
            gap=float(diag.gap),
            res_infeas=float(diag.res_infeas),
            res_unbdd_a=float(diag.res_unbdd_a),
            res_unbdd_p=float(diag.res_unbdd_p),
            comp_slack=float(diag.comp_slack),
            solve_time=solve_time,
            setup_time=self._setup_time,
            lin_sys_time=lin_sys_time,
            cone_time=cone_time,
            accel_time=accel_time,
            rejected_accel_steps=aa.n_safeguard_reject
            + aa.n_reject_nonfinite
            + aa.n_reject_weight_cap,
            accepted_accel_steps=aa.n_accept,
            aa_stats=aa_stats,
        )
        return {"x": x_out, "y": y_out, "s": s_out, "info": info}

    def update(self, b=None, c=None):
        """Update b and/or c without redoing the b/c-independent setup
        (reference SCS.update, scs/py/__init__.py:205-214). Thread-safe
        under the per-instance lock."""
        with self._lock:
            return self._update_locked(b, c)

    def _update_locked(self, b=None, c=None):
        scal = self._scal
        mats = self.mats

        def t(a):
            return torch.as_tensor(a, dtype=self._dtype, device=self._device)

        if b is not None:
            b = np.asarray(b, np.float64).ravel()
            if len(b) != self.m:
                raise ValueError("new b has incompatible dimension")
            self._b_orig = b
            mats = mats._replace(
                bn=t(scal.sc_b * scal.D * b), norm_b=t(np.linalg.norm(b))
            )
        if c is not None:
            c = np.asarray(c, np.float64).ravel()
            if len(c) != self.n:
                raise ValueError("new c has incompatible dimension")
            self._c_orig = c
            mats = mats._replace(
                cn=t(scal.sc_c * scal.E * c), norm_c=t(np.linalg.norm(c))
            )
        self.mats = mats
        # g depends on (b, c): recompute it with the cached factor (or the
        # packs); no factorization runs here
        self._state0 = self.core.init_from_factor(self.mats, self._state0.L)


def solve(data, cone, **settings):
    """One-shot legacy API (reference scs/py/__init__.py:218-230)."""
    solver = SCS(data, cone, **settings)
    x = data.get("x")
    y = data.get("y")
    s = data.get("s")
    return solver.solve(warm_start=True, x=x, y=y, s=s)
