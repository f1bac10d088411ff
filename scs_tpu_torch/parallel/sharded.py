"""Single-problem solve with the constraint matrix row-sharded over the
ranks of a process group — the port of scs_tpu/parallel/sharded.py.

scs_tpu runs the whole DR loop as one program under a mesh, with only A
sharded, and XLA's SPMD partitioner places the collectives. Here every rank
is a process that runs the same host loop on the same replicated vectors,
and the collectives are explicit, in the two operator touches: A @ x
computes this rank's rows and gathers them (`comm.gather_rows`), A' @ y
computes this rank's partial and sums the partials over the ranks
(`comm.sum_ranks`, a fixed order, so every rank holds the same bits and
takes the same host decisions). A rank's device holds only its rows of A
(or its slice of the block-ELL packs); P and every iterate vector are
replicated. The memory that makes a problem too big for one card is A's,
and sharding divides it by the number of ranks.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse as _sp

from ..api import SCS
from ..ops import df32
from ..ops.dense import gemv_cols, gemv_rows
from ..solver import BellData, Core, Mats
from .comm import gather_rows, rank0_decides, sum_ranks
from .mesh import make_mesh, mesh_layout, rank_device


class ShardedDenseCore(Core):
    """Core whose dense A is row-sharded: `mats.A` holds this rank's rows
    (m / n_dev of them); the products are G1/G2 (D1 in high-accuracy mode)
    on them, then a gather or a sum over the ranks of `group`."""

    def __init__(self, m, n, has_P, spec, stg, group, rank):
        self.group, self.rank = group, rank
        super().__init__(m, n, has_P, spec, stg)

    def _rows(self, mats: Mats, v):
        """This rank's entries of an (m,) vector."""
        m_loc = mats.A.shape[0]
        return v[self.rank * m_loc : (self.rank + 1) * m_loc]

    def _Ax(self, mats: Mats, x):
        return gather_rows(gemv_rows(mats.A, x), self.group)

    def _ATy(self, mats: Mats, y):
        return sum_ranks(gemv_cols(mats.A, self._rows(mats, y)), self.group)

    def _matvec_S(self, mats: Mats, dy, x):
        """S x from this rank's rows alone: its rows of dy * (A x) are its
        own products, so A' D A x needs one sum over the ranks and no
        gather (the bits of Core._matvec_S through _Ax and _ATy)."""
        t = gemv_cols(mats.A, self._rows(mats, dy) * gemv_rows(mats.A, x))
        out = self.stg.rho_x * x + sum_ranks(t, self.group)
        if self.has_P:
            out = out + self._Px(mats, x)
        return out

    def _Ax_hi(self, mats: Mats, x):
        if not self.hi_acc:
            return self._Ax(mats, x)
        return gather_rows(df32.mv(mats.A, x), self.group)

    def _ATy_hi(self, mats: Mats, y):
        """Compensated A' y. Each rank's partial comes from D1 to about one
        ulp of itself; the partials are added in float64, in rank order, and
        rounded once to float32, so their sum adds no rounding of its own
        where a plain float32 sum of cancelling partials would give back the
        error the compensated product removed."""
        if not self.hi_acc:
            return self._ATy(mats, y)
        part = df32.tv(mats.A, self._rows(mats, y))
        return sum_ranks(part, self.group, acc_dtype=torch.float64)

    def _diagS(self, mats: Mats, dy, scale):
        A = mats.A
        local = (A * A * self._rows(mats, dy)[:, None]).sum(-2)
        diagS = self.stg.rho_x + sum_ranks(local, self.group)
        if self.has_P:
            diagS = diagS + mats.P.diagonal()
        return diagS


class ShardedSCS(SCS):
    """SCS solver for one problem with A row-sharded over the ranks of a
    1-D DeviceMesh (one process a rank; `torchrun --nproc-per-node N`).

    Parameters are those of `SCS`, plus:
      mesh: a 1-D `torch.distributed.device_mesh.DeviceMesh` (axis: rows);
            by default `make_mesh(axis_name="rows")`, every rank of the
            default process group.

    Every rank constructs the solver with the same data and calls the same
    methods in the same order. `device` is this rank's: "cuda" (the
    default) means cuda:{LOCAL_RANK}, "cpu" the CPU, "cuda:k" that card.

    Two strategies, both matrix-free: "indirect" (the default; dense A by
    rows, CG) and "bell" (the block-ELL packs by rows, for a sparse A whose
    dense form fits nowhere). The row dimension is padded to a multiple of
    the mesh size (of mesh size x bell_block_size under "bell") by
    prepending zero-cone rows (zero rows of A and zero entries of b: the
    constraint 0 = 0); the padding is stripped from y and s on output.

    What differs from SCS: the verbose lines, the CSV rows and the problem
    file come from rank 0 alone; the time limit and the "auto" timers'
    decision to run are rank 0's, shared with the others, so no rank leaves
    the loop alone. A KeyboardInterrupt reaches only the rank that receives
    it and is not passed on: that rank stops while the others wait for it
    in a collective. Interrupt every rank (the launcher does, on Ctrl-C at
    its terminal) or none.
    """

    def __init__(self, data, cone, mesh=None, **settings):
        if mesh is None:
            mesh = make_mesh(axis_name="rows")
        if mesh.ndim != 1:
            raise ValueError("ShardedSCS expects a 1-D mesh")
        self.mesh = mesh
        self._group, self._rank, n_dev = mesh_layout(mesh)
        self._n_dev = n_dev

        strategy = settings.setdefault("solver_strategy", "indirect")
        if strategy not in ("indirect", "bell"):
            raise ValueError("ShardedSCS requires solver_strategy='indirect' or 'bell'")
        self._bell_mode = strategy == "bell"
        if self._bell_mode and settings.get("phase_timing") == "always":
            raise ValueError(
                "phase_timing='always' is not supported on the sharded bell path"
            )
        settings["device"] = str(rank_device(settings.get("device", "cuda"), self._group))
        self._logs = self._rank == 0

        b = np.asarray(
            data["b"].todense() if _sp.issparse(data["b"]) else data["b"],
            np.float64,
        ).ravel()
        # bell: each rank's row slice must pack into whole (bs x bs) tiles
        pad_mult = (
            n_dev * int(settings.get("bell_block_size", 128)) if self._bell_mode else n_dev
        )
        pad = (-len(b)) % pad_mult
        self._row_pad = pad
        if pad:
            data = dict(data)
            cone = dict(cone)
            A = data["A"]
            if _sp.issparse(A):
                A = _sp.vstack([_sp.csc_matrix((pad, A.shape[1])), A.tocsc()]).tocsc()
            else:
                A = np.vstack([np.zeros((pad, np.shape(A)[1])), np.asarray(A)])
            data["A"] = A
            data["b"] = np.concatenate([np.zeros(pad), b])
            cone["z"] = int(cone.get("z", 0)) + pad

        super().__init__(data, cone, **settings)

    # -- strategy hooks -----------------------------------------------------

    def _make_core(self, m, n, has_P, spec_hat):
        from .sharded_bell import ShardedBellCore  # noqa: PLC0415

        cls = ShardedBellCore if self._bell_mode else ShardedDenseCore
        return cls(m, n, has_P, spec_hat, self.stg, self._group, self._rank)

    def _place_dense(self, t, Ah):
        m_loc = Ah.shape[0] // self._n_dev
        return t(Ah[self._rank * m_loc : (self._rank + 1) * m_loc]).contiguous()

    def _rank0(self, flag):
        return rank0_decides(flag, self._group)

    def _build_bell(self, Ah_sp, Ph_sp, spec_hat, dtype):
        from ..ops.sparse import (  # noqa: PLC0415
            pack_bell_sharded,
            pack_bell_sym_sharded,
            place_bell_shard,
        )
        from ..solver import PBell  # noqa: PLC0415

        bs, r, dev = int(self.stg.bell_block_size), self._rank, self._device
        Ab, Ac, Atb, Atc, colsq_all = pack_bell_sharded(Ah_sp, self._n_dev, bs, dtype)
        zmask = spec_hat.zero_row_mask().astype(np.float64)
        colsq_zero = np.asarray(zmask @ Ah_sp.multiply(Ah_sp)).ravel()
        A_blocks, A_cols = place_bell_shard(Ab, Ac, r, Atb.shape[1], dev)
        At_blocks, At_cols = place_bell_shard(Atb, Atc, r, Ab.shape[1], dev)
        del Ab, Ac, Atb, Atc
        bell = BellData(
            A_blocks=A_blocks,
            A_cols=A_cols,
            At_blocks=At_blocks,
            At_cols=At_cols,
            colsq_all=torch.as_tensor(colsq_all, device=dev),
            colsq_zero=torch.as_tensor(colsq_zero, dtype=dtype, device=dev),
        )
        pbell = None
        if Ph_sp is not None:
            pb = pack_bell_sym_sharded(Ph_sp, self._n_dev, bs, dtype)
            blocks, cols = place_bell_shard(pb.blocks, pb.cols, r, -(-self.n // bs), dev)
            pbell = PBell(blocks=blocks, cols=cols, diag=torch.as_tensor(pb.diag, device=dev))
        return bell, pbell

    def _update_locked(self, b=None, c=None):
        if b is not None and self._row_pad:
            b = np.concatenate([np.zeros(self._row_pad), np.asarray(b, np.float64).ravel()])
        return super()._update_locked(b, c)

    def _solve_locked(self, warm_start, x, y, s):
        pad = self._row_pad
        if y is not None and pad:
            y = np.concatenate([np.zeros(pad), np.asarray(y).ravel()])
        if s is not None and pad:
            s = np.concatenate([np.zeros(pad), np.asarray(s).ravel()])
        out = super()._solve_locked(warm_start, x, y, s)
        if pad:
            out["y"] = out["y"][pad:]
            out["s"] = out["s"][pad:]
        return out
