"""Row-sharded block-ELL (bell) solver core — the port of
scs_tpu/parallel/sharded_bell.py, for a giant sparse problem whose pack fits
on no single card.

Layout (ops.sparse.pack_bell_sharded, placed by ShardedSCS): rank d holds
the block-ELL pack of its contiguous row slice A_d and the pack of A_d^T;
with a quadratic cost, also its row slice of P's symmetric pack. Every
iterate vector is replicated, and the operator touches communicate:

    A @ x  : local SpMV (K1 on CUDA), then gather_rows of the (m,) result
    A^T @ y: this rank's rows of y, local SpMV of the transposed pack, then
             sum_ranks of the (n,) partials
    P @ x  : local SpMV of P's row slice, then gather_rows, cut to n

Everything else of the DR iteration (cone projection, AA, residuals,
adaptive scale, the CG loop) runs on replicated vectors, identically on
every rank, so the rest of Core is used as it is.
"""

from __future__ import annotations

from ..ops.sparse import bell_spmv
from ..solver import Core, Mats
from .comm import gather_rows, sum_and_gather_rows, sum_ranks


class ShardedBellCore(Core):
    """Core whose bell operator is row-sharded over the ranks of `group`
    (this rank is `rank`); `mats.bell` / `mats.pbell` hold this rank's
    packs and the replicated preconditioner vectors."""

    def __init__(self, m, n, has_P, spec, stg, group, rank):
        self.group, self.rank = group, rank
        super().__init__(m, n, has_P, spec, stg)

    def phase_times(self, states, mats):
        """Not measured on the sharded bell path, as in scs_tpu: zeros
        (ShardedSCS rejects phase_timing="always" there)."""
        return {"lin_sys": 0.0, "cone": 0.0, "accel_trial": 0.0}

    def phase_sample(self, state, mats, weight):
        """Not measured (phase_times): no round is timed."""

    def _Ax(self, mats: Mats, x):
        bell = mats.bell
        # m is a multiple of n_dev*bs (ShardedSCS pads), so the gathered
        # slices are exactly the (m,) vector
        return gather_rows(bell_spmv(bell.A_blocks, bell.A_cols, x), self.group)

    def _ATy(self, mats: Mats, y):
        bell = mats.bell
        m_loc = bell.A_blocks.shape[0] * bell.A_blocks.shape[-1]
        y_loc = y[self.rank * m_loc : (self.rank + 1) * m_loc]
        t = bell_spmv(bell.At_blocks, bell.At_cols, y_loc)[: self.n]
        return sum_ranks(t, self.group)

    def _matvec_S(self, mats: Mats, dy, x):
        """S x in one collective: this rank's rows of dy * (A x) are its own
        products, so A' D A x needs only the sum of the ranks' partials, and
        with P its rows of P x travel in the same gather (the bits of
        Core._matvec_S through _Ax, _ATy and _Px)."""
        bell = mats.bell
        m_loc = bell.A_blocks.shape[0] * bell.A_blocks.shape[-1]
        dy_loc = dy[self.rank * m_loc : (self.rank + 1) * m_loc]
        q = bell_spmv(bell.A_blocks, bell.A_cols, x)
        t = bell_spmv(bell.At_blocks, bell.At_cols, dy_loc * q)[: self.n]
        if not self.has_P:
            return self.stg.rho_x * x + sum_ranks(t, self.group)
        pb = mats.pbell
        t, px = sum_and_gather_rows(t, bell_spmv(pb.blocks, pb.cols, x), self.group)
        return self.stg.rho_x * x + t + px[: self.n]

    def _Px(self, mats: Mats, x):
        """P @ x from this rank's rows of P's symmetric pack, gathered like
        A @ x (symmetry: no transposed pack, no sum)."""
        pb = mats.pbell
        return gather_rows(bell_spmv(pb.blocks, pb.cols, x), self.group)[: self.n]
