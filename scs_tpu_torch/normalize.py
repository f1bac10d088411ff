"""Data equilibration (Ruiz-style) — counterpart of the reference's
src/normalize.c + linsys/scs_matrix.c scaling.

The host (numpy) functions of scs_tpu/normalize.py, unchanged, so both
packages equilibrate identically, and `ruiz_equilibrate_batched`, the
on-device counterpart of scs_tpu's vmapped ruiz_equilibrate_jnp for a dense
(B, m, n) batch.

Transform (self-consistent; derivation in solver.py docstring):
    A_hat = D A E            (D per-cone-block-uniform row scaling)
    P_hat = (sc_c / sc_b) * E P E
    b_hat = sc_b * D b
    c_hat = sc_c * E c
with sc_b = 1/max(||D b||, MIN_SCALE), sc_c = 1/max(||E c||, MIN_SCALE).

Un-normalization of a solution of the scaled problem (tau-normalized):
    x = E x_hat / sc_b
    y = D y_hat / sc_c
    s = D^-1 s_hat / sc_b

Rows of the zero ('z') and nonnegative ('l') cones scale per-row; box-cone
rows scale per-row with the bounds bu/bl adjusted accordingly; all other
cones scale uniformly per cone block (a nonuniform diagonal scaling would
change the cone).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cones import ConeSpec

MIN_SCALE = 1e-8
NUM_RUIZ_PASSES = 10


def row_block_ids(spec: ConeSpec):
    """Map each row to a scaling block; -1 means per-row (free) scaling."""
    ids = np.full(spec.dim, -1, dtype=np.int64)
    next_id = 0
    for sg in spec.segments():
        if sg.kind in ("z", "l", "box"):
            continue  # per-row scaling allowed (box bounds get adjusted)
        ids[sg.offset : sg.offset + sg.length] = next_id
        next_id += 1
    return ids, next_id


@dataclasses.dataclass
class Scaling:
    D: np.ndarray  # (m,)
    E: np.ndarray  # (n,)
    sc_b: float
    sc_c: float


def ruiz_equilibrate(A, P, b, c, spec: ConeSpec, passes=NUM_RUIZ_PASSES):
    """Equilibrate dense A (m,n), optional dense P (n,n), b (m,), c (n,).

    Returns (A_hat, P_hat, b_hat, c_hat, Scaling, spec_hat) where spec_hat
    carries the adjusted box bounds for the normalized problem.
    """
    A = np.asarray(A, np.float64)
    m, n = A.shape
    D = np.ones(m)
    E = np.ones(n)
    ids, nblocks = row_block_ids(spec)
    has_blocks = nblocks > 0

    Ah = A.copy()
    Ph = None if P is None else np.asarray(P, np.float64).copy()

    for _ in range(passes):
        r = np.max(np.abs(Ah), axis=1)
        if has_blocks:
            # uniformize within cone blocks (max over the block)
            blk_max = np.zeros(nblocks)
            np.maximum.at(blk_max, ids[ids >= 0], r[ids >= 0])
            r = np.where(ids >= 0, blk_max[np.clip(ids, 0, None)], r)
        # all-zero rows/cols must keep scale 1 (a zero row would otherwise
        # blow its scale up by 1/sqrt(MIN_SCALE) every pass)
        r = np.where(r <= MIN_SCALE, 1.0, r)
        r = np.sqrt(r)
        cn = np.max(np.abs(Ah), axis=0)
        if Ph is not None:
            cn = np.maximum(cn, np.max(np.abs(Ph), axis=0))
        cn = np.where(cn <= MIN_SCALE, 1.0, cn)
        cn = np.sqrt(cn)
        Ah /= r[:, None]
        Ah /= cn[None, :]
        if Ph is not None:
            Ph /= cn[:, None]
            Ph /= cn[None, :]
        D /= r
        E /= cn

    bh = D * np.asarray(b, np.float64)
    ch = E * np.asarray(c, np.float64)
    sc_b = 1.0 / max(float(np.linalg.norm(bh)), MIN_SCALE)
    sc_c = 1.0 / max(float(np.linalg.norm(ch)), MIN_SCALE)
    bh *= sc_b
    ch *= sc_c
    if Ph is not None:
        Ph *= sc_c / sc_b

    # adjust box bounds: s'_i = d_i s_i, t' = d_t t  =>  bu' = bu * d_i / d_t
    spec_hat = spec
    if spec.bsize > 0:
        off = spec.z + spec.l
        d_t = D[off]
        d_s = D[off + 1 : off + spec.bsize]
        bu_hat = spec.bu * d_s / d_t
        bl_hat = spec.bl * d_s / d_t
        spec_hat = dataclasses.replace(spec, bu=bu_hat, bl=bl_hat)

    return Ah, Ph, bh, ch, Scaling(D=D, E=E, sc_b=sc_b, sc_c=sc_c), spec_hat


def identity_scaling(m, n):
    return Scaling(D=np.ones(m), E=np.ones(n), sc_b=1.0, sc_c=1.0)


def ruiz_equilibrate_sparse(A, P, b, c, spec: ConeSpec, passes=NUM_RUIZ_PASSES):
    """Sparse-aware Ruiz equilibration: same math as `ruiz_equilibrate`,
    O(nnz) per pass, never materializing a dense (m, n) array — the
    preprocessing path for the block-ELL ("bell") strategy, whose whole
    point is that dense A fits neither device nor host at scale.

    A: scipy CSC (m, n). P: scipy CSC (n, n) FULL symmetric (not triu) or
    None. Returns (A_hat csc, P_hat csc|None, b_hat, c_hat, Scaling,
    spec_hat).
    """
    from scipy import sparse as sp

    A = sp.csc_matrix(A, copy=True)
    m, n = A.shape
    D = np.ones(m)
    E = np.ones(n)
    ids, nblocks = row_block_ids(spec)
    has_blocks = nblocks > 0

    Ah = A
    Ph = None if P is None else sp.csc_matrix(P, copy=True)

    def col_max_abs(M):
        Mab = np.abs(M.data)
        out = np.zeros(M.shape[1])
        np.maximum.at(out, np.repeat(np.arange(M.shape[1]), np.diff(M.indptr)), Mab)
        return out

    for _ in range(passes):
        r = np.zeros(m)
        np.maximum.at(r, Ah.indices, np.abs(Ah.data))
        if has_blocks:
            blk_max = np.zeros(nblocks)
            np.maximum.at(blk_max, ids[ids >= 0], r[ids >= 0])
            r = np.where(ids >= 0, blk_max[np.clip(ids, 0, None)], r)
        r = np.where(r <= MIN_SCALE, 1.0, r)
        r = np.sqrt(r)
        cn = col_max_abs(Ah)
        if Ph is not None:
            cn = np.maximum(cn, col_max_abs(Ph))
        cn = np.where(cn <= MIN_SCALE, 1.0, cn)
        cn = np.sqrt(cn)
        # scale in place on the CSC data arrays: A <- D_r^-1 A E_c^-1
        col_of = np.repeat(np.arange(n), np.diff(Ah.indptr))
        Ah.data /= r[Ah.indices]
        Ah.data /= cn[col_of]
        if Ph is not None:
            pcol = np.repeat(np.arange(n), np.diff(Ph.indptr))
            Ph.data /= cn[Ph.indices]
            Ph.data /= cn[pcol]
        D /= r
        E /= cn

    bh = D * np.asarray(b, np.float64)
    ch = E * np.asarray(c, np.float64)
    sc_b = 1.0 / max(float(np.linalg.norm(bh)), MIN_SCALE)
    sc_c = 1.0 / max(float(np.linalg.norm(ch)), MIN_SCALE)
    bh *= sc_b
    ch *= sc_c
    if Ph is not None:
        Ph.data *= sc_c / sc_b

    spec_hat = spec
    if spec.bsize > 0:
        off = spec.z + spec.l
        d_t = D[off]
        d_s = D[off + 1 : off + spec.bsize]
        spec_hat = dataclasses.replace(
            spec, bu=spec.bu * d_s / d_t, bl=spec.bl * d_s / d_t
        )

    return Ah, Ph, bh, ch, Scaling(D=D, E=E, sc_b=sc_b, sc_c=sc_c), spec_hat


# ---------------------------------------------------------------------------
# On-device equilibration of a dense batch — used by the batched dense path.
# ---------------------------------------------------------------------------


def _absmax(M, dim):
    """max |M| along `dim` without a |M|-sized temporary."""
    return torch.linalg.vector_norm(M, ord=float("inf"), dim=dim)


def ruiz_equilibrate_batched(A, P, b, c, spec: ConeSpec, passes=NUM_RUIZ_PASSES):
    """Ruiz equilibration of B dense problems at once, on the tensors'
    device: the math of `ruiz_equilibrate` per problem (scs_tpu's
    ruiz_equilibrate_jnp under jax.vmap).

    A: (B, m, n), P: (B, n, n) or None, b: (B, m), c: (B, n). A and P are
    SCALED IN PLACE (the counterpart of scs_tpu donating them into its
    equilibration program: no second copy of the batch is ever live), so
    pass tensors the caller does not need again. Returns (A, P, b_hat,
    c_hat, D, E, sc_b, sc_c, bl_hat, bu_hat) with D (B, m), E (B, n), sc_b
    and sc_c (B,), and the box bounds (B, bsize-1) (zero-length without a
    box cone).
    """
    B, m, n = A.shape
    dtype, dev = A.dtype, A.device
    ids_np, nblocks = row_block_ids(spec)
    D = torch.ones((B, m), dtype=dtype, device=dev)
    E = torch.ones((B, n), dtype=dtype, device=dev)
    if nblocks > 0:
        in_block = torch.as_tensor(ids_np >= 0, device=dev)
        idx = torch.as_tensor(np.clip(ids_np, 0, None), device=dev)
        idx_b = idx.expand(B, m)

    for _ in range(passes):
        r = _absmax(A, 2)
        if nblocks > 0:
            # uniformize within cone blocks (max over the block)
            seg_in = torch.where(in_block, r, -torch.inf)
            blk_max = torch.full((B, nblocks), -torch.inf, dtype=dtype, device=dev)
            blk_max = blk_max.scatter_reduce(1, idx_b, seg_in, reduce="amax")
            r = torch.where(in_block, blk_max.gather(1, idx_b), r)
        r = torch.where(r <= MIN_SCALE, 1.0, r).sqrt()
        cn = _absmax(A, 1)
        if P is not None:
            cn = torch.maximum(cn, _absmax(P, 1))
        cn = torch.where(cn <= MIN_SCALE, 1.0, cn).sqrt()
        A.div_(r[:, :, None]).div_(cn[:, None, :])
        if P is not None:
            P.div_(cn[:, :, None]).div_(cn[:, None, :])
        D = D / r
        E = E / cn

    bh = D * b
    ch = E * c
    sc_b = 1.0 / torch.clamp_min(torch.linalg.vector_norm(bh, dim=1), MIN_SCALE)
    sc_c = 1.0 / torch.clamp_min(torch.linalg.vector_norm(ch, dim=1), MIN_SCALE)
    bh = bh * sc_b[:, None]
    ch = ch * sc_c[:, None]
    if P is not None:
        P.mul_((sc_c / sc_b)[:, None, None])

    if spec.bsize > 0:
        off = spec.z + spec.l
        d_t = D[:, off : off + 1]
        d_s = D[:, off + 1 : off + spec.bsize]
        bu_hat = torch.as_tensor(spec.bu, dtype=dtype, device=dev) * d_s / d_t
        bl_hat = torch.as_tensor(spec.bl, dtype=dtype, device=dev) * d_s / d_t
    else:
        bu_hat = torch.zeros((B, 0), dtype=dtype, device=dev)
        bl_hat = torch.zeros((B, 0), dtype=dtype, device=dev)
    return A, P, bh, ch, D, E, sc_b, sc_c, bl_hat, bu_hat
