"""Batched multi-problem solving: B same-shape SPARSE problems under the
bell strategy — the port of scs_tpu/batch.py's bell path.

The reference serves B sparse instances with a thread pool, one solver
per thread; scs_tpu solves them as one vmapped program; here they run as
one batched core (batch_core.BatchedCore) whose every operator call is
one launch of the batched block-ELL SpMV for the whole batch. The (B, m, n)
dense batch is never formed, on the host or the device.

The solve loop is scs_tpu's, decision for decision (batch.py:1024-1189):
segments of masked chunks, a speculative next segment run before the
current segment's probe is read, the adaptive rescale applied between
segments to the speculatively advanced state, retirement of finished
problems and compaction of the survivors down a halving bucket ladder,
the time limit and Ctrl-C. Only the dense batched path (direct and
indirect strategies on a (B, m, n) array) is not ported: it raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import info as info_mod
from .batch_core import BatchedCore
from .cones import ConeSpec
from .info import UNFINISHED
from .settings import Settings
from .solver import BellData, Mats, PBell

_NOT_PORTED = {
    "direct": "ROADMAP.md Queue 1 item 7 (BatchedSCS on the dense path)",
    "indirect": "ROADMAP.md Queue 1 items 7 and 9 (dense batch, indirect strategy)",
}


def _gather(tree, idx):
    """Rows `idx` of every leaf of a NamedTuple tree (None leaves stay)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_gather(t, idx) for t in tree))
    return tree.index_select(0, idx)


class BatchedSCS:
    """Solve B same-shape sparse cone problems simultaneously.

    Parameters
    ----------
    data: dict with
        A: list of B scipy sparse (m, n) matrices
        P: list of B scipy sparse (n, n) matrices (full or upper triangle),
           optional
        b: (B, m), c: (B, n)
    cone: one cone dict shared by the batch.

    Only solver_strategy="bell" is ported; a dense (B, m, n) A under it
    raises ValueError as in scs_tpu.
    """

    # compaction ladder floor: never compact below this many problems
    _MIN_BUCKET = 32

    def __init__(self, data, cone, **settings):
        settings.setdefault("verbose", False)
        # scs_tpu's batched defaults (batch.py:311-344) that the bell path
        # reads, kept so that one settings dict gives the same solve in
        # either package
        settings.setdefault("rescale_in_chunk", False)
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
                A = np.stack([
                    np.asarray(Ai.todense() if hasattr(Ai, "todense") else Ai)
                    for Ai in A
                ])
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
        else:
            raise NotImplementedError(
                f"solver_strategy={self.stg.solver_strategy!r} on a batch is "
                f"not ported to scs_tpu_torch yet: "
                f"{_NOT_PORTED[self.stg.solver_strategy]}; pass "
                "solver_strategy='bell' with A as a list of sparse matrices"
            )
        if self.stg.phase_timing == "always":
            raise NotImplementedError(
                "phase_timing='always' (the per-phase instrumented timers) "
                "is not ported to scs_tpu_torch yet: ROADMAP.md Queue 1 "
                "item 6 follow-up"
            )
        spec = ConeSpec.from_dict(cone)
        if spec.dim != m:
            raise ValueError("cone dimensions incompatible with b")
        self.spec = spec
        self.B, self.m, self.n = B, m, n
        self.has_P = P is not None
        self._dtype = torch.float64 if self.stg.dtype == "float64" else torch.float32
        self._device = torch.device(self.stg.device)

        t0 = time.perf_counter()
        self.core = BatchedCore(m, n, self.has_P, spec, self.stg)
        # host-side sparse preprocessing per problem (equilibration and
        # block-ELL packing never materialize dense A), then one stacked
        # upload; as in scs_tpu the upload counts in "equilibrate"
        self.mats = self._build_bell_mats(A, P, data["b"], data["c"], spec)
        t_prep = time.perf_counter() - t0
        t2 = time.perf_counter()
        self.reset()
        t_g = time.perf_counter() - t2
        self._setup_time = time.perf_counter() - t0
        self.setup_breakdown = {
            "transfer": 0.0,
            "equilibrate": t_prep,
            "factorize": 0.0,  # matrix-free CG: no factorization
            "compute_g": t_g,
        }

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
        scale by CG, then fresh iterates."""
        self._states = self.core.init_state(self.mats)
        self.core._sync()

    def update(self, b=None, c=None):
        """Update b and/or c for the whole batch, re-scaled with the stored
        equilibration; the packs are reused and only g is recomputed
        (scs_tpu BatchedSCS.update)."""
        mats = self.mats

        def t(a, k):
            a = np.asarray(a, np.float64).reshape(self.B, k)
            return torch.as_tensor(a, dtype=self._dtype, device=self._device)

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
        x, y, s, x_cert, y_cert, s_cert, scal = (
            a.detach().cpu().numpy() for a in pack
        )
        lookback = self.core.lookback
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
            )
            results[pos] = {"x": xi.copy(), "y": yi.copy(), "s": si.copy(), "info": info}

    def polish(self, results, sub_batch=32, eps_reg=1e-6, refine=3):
        """Active-set polish (scs_tpu BatchedSCS.polish) runs for the dense
        direct core only; the bell core is matrix-free CG, so — as in
        scs_tpu — results come back unchanged. Returns (results,
        polished_mask)."""
        return results, np.zeros(self.B, bool)

    @staticmethod
    def _compact(states, mats, idx):
        """Retirement compaction: the surviving rows of every state and
        mats leaf."""
        return _gather(states, idx), _gather(mats, idx)

    def solve(self):
        """Solve the batch. With compaction enabled (at B >= 2*_MIN_BUCKET),
        finished problems are retired at segment boundaries and the
        survivors are re-packed into a smaller batch; per-problem
        `solve_time` is the wall-clock until that problem's retirement."""
        if self._states is None:
            self.reset()
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
        prev_maxit = 0

        def seg_len(cur):
            # at the ladder floor only termination is left to detect: run
            # several chunks per host poll
            if compact and cur <= self._MIN_BUCKET:
                return max(seg, 8)
            return seg

        def probe_of(st):
            return torch.stack([
                st.status.to(torch.float64),
                st.it.to(torch.float64),
                st.rescale_trigger.to(torch.float64),
            ]).cpu().numpy()

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
                    pending.append((core.finalize_pack(states, mats), positions, None,
                                    time.perf_counter() - t0))
                    break
                states = nxt
                if trig_np.any():
                    # some problem's adaptive scale drifted: apply the
                    # decision recorded in the (next) state
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
                    pending.append((core.finalize_pack(states, mats), positions, done,
                                    time.perf_counter() - t0))
                    active = np.where(~done)[0]
                    pad = np.full(target - n_act, active[0], dtype=np.int64)
                    idx = np.concatenate([active, pad])
                    states, mats = self._compact(
                        states, mats, torch.as_tensor(idx, device=self._device)
                    )
                    positions = positions[idx]
        except KeyboardInterrupt:
            interrupted = True
            # finalize the in-flight state so partial results are returned
            pending.append((core.finalize_pack(states, mats), positions, None,
                            time.perf_counter() - t0))
        for pack, pos, mask, el in pending:
            self._materialize(results, pos, pack, mask, el, interrupted=interrupted)
        # states are compacted/finished now; a later solve() cold-starts
        self._states = None
        return results


def solve_batch(data, cone, **settings):
    """One-shot batched solve over B same-shape sparse problems."""
    return BatchedSCS(data, cone, **settings).solve()
