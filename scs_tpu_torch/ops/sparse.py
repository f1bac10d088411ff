"""Block-ELL sparse matrix-vector product — the sparse layout and the
CUDA kernel behind the large-problem "bell" strategy.

The matrix is cut into (bs x bs) dense tiles; each block-row stores a
fixed number (`width`) of nonzero tiles plus their block-column ids. The
layout and the host packers are scs_tpu's (scs_tpu/ops/sparse.py),
unchanged, so a pack made by either package serves both.

  * bell_spmv       — the kernel wrapper: a CUDA tensor launches the
                      hand-written kernel (csrc/bell_spmv.cu), a CPU tensor
                      takes the plain version; x comes at its true length
                      (zero beyond its end), nothing is padded for a launch
  * bell_spmv_ref   — the plain PyTorch version (gather + einsum)
  * bell_spmv_batched, bell_spmv_batched_ref — the same for B problems at
                      once (leading batch axis, per-problem cols), the
                      operator of the batched bell path
  * BellMatrix      — packed (A, A^T) pair with .mv / .rmv
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch


def bell_spmv_ref(blocks, cols, x_pad):
    """Plain block-ELL SpMV: y (nbr*bs,) = A @ x.

    blocks: (nbr, width, bs, bs) storing each tile TRANSPOSED
    (blocks[r, w, j, i] = A_tile[i, j]); cols: (nbr, width) integer
    block-column ids; x_pad: (nbc*bs,) zero-padded input.
    """
    nbr, width, bs, _ = blocks.shape
    xb = x_pad.reshape(-1, bs)  # (nbc, bs)
    gathered = xb.index_select(0, cols.reshape(-1).long())  # (nbr*width, bs)
    # contract over the merged (slot, j) axis k: the blocks' own memory
    # order, so the product needs no transposed copy of the pack
    y = torch.einsum(
        "rki,rk->ri",
        blocks.reshape(nbr, width * bs, bs),
        gathered.reshape(nbr, width * bs),
    )
    return y.reshape(nbr * bs)


def _pad_for_ref(x, cols, bs):
    """x zero-padded along its last axis to whole tiles up to the last
    block column that `cols` names: what the plain versions take. Only the
    CPU path pads; the CUDA kernel reads zeros beyond x's end itself."""
    n_blocks = max(int(cols.max()) + 1 if cols.numel() else 1, -(-x.shape[-1] // bs))
    return torch.nn.functional.pad(x, (0, n_blocks * bs - x.shape[-1]))


def _launch(who, symbol, blocks, cols, x, out_shape, sizes):
    """Check what every entry point of csrc/bell_spmv.cu takes (dtypes,
    block size, one CUDA device, contiguity; x needs unit stride along its
    last axis only), then launch `symbol`'s f32 or f64 instantiation on the
    current stream. Returns y; raises on anything the kernel does not take
    and on a failed launch."""
    dev = blocks.device
    bs = blocks.shape[-1]
    if blocks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: blocks must be float32 or float64, got {blocks.dtype}")
    if x.dtype != blocks.dtype:
        raise TypeError(f"{who}: x dtype {x.dtype} != blocks dtype {blocks.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{who}: cols must be int32, got {cols.dtype}")
    if not 1 <= bs <= 1024:
        raise ValueError(f"{who}: block size {bs} outside [1, 1024]")
    if blocks.shape[-3] < 1:
        raise ValueError(f"{who}: a pack needs at least one slot per block-row")
    for name, t in (("blocks", blocks), ("cols", cols), ("x", x)):
        if t.device != dev:
            raise ValueError(f"{who}: {name} on {t.device}, blocks on {dev}")
    if not blocks.is_contiguous() or not cols.is_contiguous():
        raise ValueError(f"{who}: blocks and cols must be contiguous")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"{who}: x must have unit stride along its last axis")

    from . import _kernels  # noqa: PLC0415

    lib = _kernels.load("bell_spmv")
    fn = getattr(lib, symbol + ("_f32" if blocks.dtype == torch.float32 else "_f64"))
    y = torch.empty(out_shape, dtype=blocks.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), *sizes, stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:  # the launch goes to the runtime's current device
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {rc}")
    return y


def bell_spmv(blocks, cols, x):
    """Block-ELL SpMV y = A @ x; blocks and cols as bell_spmv_ref. x is
    1-D of any length and counts as zero beyond its end, so the caller
    passes a vector of the matrix's true column count, unpadded.

    On a CUDA tensor this launches the CUDA kernel of csrc/bell_spmv.cu
    (built with nvcc at first use) on the current stream and counts the
    launch in `bell_spmv.launches` and, by (nbr, w, bs, len(x)), in
    `bell_spmv.shapes`; anything the kernel does not take raises. On a CPU
    tensor it pads x and calls bell_spmv_ref.
    """
    dev = blocks.device
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"bell_spmv: blocks must be (nbr, w, bs, bs), got {tuple(blocks.shape)}")
    nbr, width, bs, _ = blocks.shape
    if tuple(cols.shape) != (nbr, width):
        raise ValueError(f"bell_spmv: cols shape {tuple(cols.shape)} != {(nbr, width)}")
    if x.dim() != 1:
        raise ValueError(f"bell_spmv: x must be 1-D, got {tuple(x.shape)}")
    if dev.type == "cpu":
        return bell_spmv_ref(blocks, cols, _pad_for_ref(x, cols, bs))
    if dev.type != "cuda":
        raise ValueError(f"bell_spmv: unsupported device {dev}")
    y = _launch("bell_spmv", "bell_spmv", blocks, cols, x, (nbr * bs,),
                (nbr, width, bs, x.shape[0]))
    bell_spmv.launches += 1
    bell_spmv.shapes[(nbr, width, bs, x.shape[0])] += 1
    return y


bell_spmv.launches = 0  # kernel launches since the last reset
bell_spmv.shapes = Counter()  # the same launches by (nbr, w, bs, len(x))


def bell_spmv_batched_ref(blocks, cols, x_pad):
    """Plain batched block-ELL SpMV: y[b] = A_b @ x[b] for every problem b,
    as one batched gather and one einsum (no per-problem loop).

    blocks: (B, nbr, width, bs, bs), tiles transposed as in bell_spmv_ref;
    cols: (B, nbr, width) block-column ids of each problem; x_pad:
    (B, nbc*bs). Returns (B, nbr*bs).
    """
    B, nbr, width, bs, _ = blocks.shape
    xb = x_pad.reshape(B, -1, bs)  # (B, nbc, bs)
    idx = cols.reshape(B, nbr * width, 1).long().expand(B, nbr * width, bs)
    gathered = torch.gather(xb, 1, idx)  # (B, nbr*width, bs)
    y = torch.einsum(
        "brki,brk->bri",
        blocks.reshape(B, nbr, width * bs, bs),
        gathered.reshape(B, nbr, width * bs),
    )
    return y.reshape(B, nbr * bs)


_MAX_BATCH = 65535  # the kernel's batch is its grid's y axis


def bell_spmv_batched(blocks, cols, x):
    """Batched block-ELL SpMV y[b] = A_b @ x[b]; blocks and cols as
    bell_spmv_batched_ref. x is (B, x_len) with unit stride along its last
    axis (rows may be strided: a column slice of a wider tensor needs no
    copy) and counts as zero beyond x_len.

    On a CUDA tensor this launches the batched entry point of
    csrc/bell_spmv.cu (the problem is the grid's second axis) on the
    current stream and counts the launch in `bell_spmv_batched.launches`;
    anything the kernel does not take raises. On a CPU tensor it pads x
    and calls bell_spmv_batched_ref.
    """
    dev = blocks.device
    if blocks.dim() != 5 or blocks.shape[3] != blocks.shape[4]:
        raise ValueError(
            f"bell_spmv_batched: blocks must be (B, nbr, w, bs, bs), got {tuple(blocks.shape)}"
        )
    B, nbr, width, bs, _ = blocks.shape
    if tuple(cols.shape) != (B, nbr, width):
        raise ValueError(f"bell_spmv_batched: cols shape {tuple(cols.shape)} != {(B, nbr, width)}")
    if x.dim() != 2 or x.shape[0] != B:
        raise ValueError(f"bell_spmv_batched: x must be (B={B}, x_len), got {tuple(x.shape)}")
    if dev.type == "cpu":
        return bell_spmv_batched_ref(blocks, cols, _pad_for_ref(x, cols, bs))
    if dev.type != "cuda":
        raise ValueError(f"bell_spmv_batched: unsupported device {dev}")
    if not 1 <= B <= _MAX_BATCH:
        raise ValueError(f"bell_spmv_batched: batch {B} outside [1, {_MAX_BATCH}]")
    x_stride = x.stride(0) if B > 1 else 0
    if x_stride < 0:
        raise ValueError("bell_spmv_batched: x has a negative row stride")
    y = _launch("bell_spmv_batched", "bell_spmv_batched", blocks, cols, x,
                (B, nbr * bs), (B, nbr, width, bs, x.shape[1], x_stride))
    bell_spmv_batched.launches += 1
    return y


bell_spmv_batched.launches = 0  # kernel launches since the last reset


class BellMatrix(NamedTuple):
    """Packed block-ELL representation of A and A^T (the pre-transposed
    A^T mirrors the reference GPU backend's gpu_atrans option,
    meson.build:291-293)."""

    m: int
    n: int
    bs: int
    A_blocks: torch.Tensor  # (nbr, wA, bs, bs)
    A_cols: torch.Tensor  # (nbr, wA) int32
    At_blocks: torch.Tensor  # (nbc, wAt, bs, bs)
    At_cols: torch.Tensor  # (nbc, wAt) int32
    col_sq: torch.Tensor  # (n,) sum_i A_ij^2  (Jacobi preconditioner data)
    row_sq: torch.Tensor  # (m,) sum_j A_ij^2

    @property
    def m_pad(self):
        return self.A_blocks.shape[0] * self.bs

    @property
    def n_pad(self):
        return self.At_blocks.shape[0] * self.bs

    def mv(self, x):
        """A @ x for x of length n (returns length m)."""
        return bell_spmv(self.A_blocks, self.A_cols, x)[: self.m]

    def rmv(self, y):
        """A^T @ y for y of length m (returns length n)."""
        return bell_spmv(self.At_blocks, self.At_cols, y)[: self.n]


def pack_bell_host(A_csc, block_size=128, np_dtype=np.float32):
    """Host-side block-ELL pack of (A, A^T): numpy arrays only, no device
    upload (scs_tpu's packer, unchanged).

    Returns (A_blocks, A_cols, At_blocks, At_cols, col_sq, row_sq).
    """
    from scipy import sparse as sp  # noqa: PLC0415

    from .. import native  # noqa: PLC0415

    A_csc = sp.csc_matrix(A_csc)
    A_csc.sort_indices()
    At_csc = sp.csc_matrix(A_csc.T)
    At_csc.sort_indices()

    def pack(M):
        if native.available:
            blocks, cols = native.pack_block_ell(M, block_size)
        else:
            blocks, cols = _pack_bell_numpy(M, block_size)
        # store tiles transposed: the kernel's loads coalesce over rows i
        return (
            np.ascontiguousarray(
                blocks.transpose(0, 1, 3, 2), dtype=np_dtype
            ),
            np.asarray(cols, np.int32),
        )

    A_blocks, A_cols = pack(A_csc)
    At_blocks, At_cols = pack(At_csc)
    d = np.asarray(A_csc.multiply(A_csc).sum(axis=0), np_dtype).ravel()
    r = np.asarray(A_csc.multiply(A_csc).sum(axis=1), np_dtype).ravel()
    return A_blocks, A_cols, At_blocks, At_cols, d, r


def stack_bell_host(blocks_list, cols_list):
    """Stack B host packs of one shape class into a batched pack (numpy
    blocks (B, nbr, w, bs, bs), cols (B, nbr, w)). Each pack is padded to
    the largest width with zero tiles pointing at block-column 0, which add
    zeros, so the problems need not share a pattern (scs_tpu
    batch.py:565-584)."""
    w = max(bk.shape[1] for bk in blocks_list)
    outs_b, outs_c = [], []
    for bk, ck in zip(blocks_list, cols_list):
        pad = w - bk.shape[1]
        if pad:
            bk = np.concatenate(
                [bk, np.zeros((bk.shape[0], pad) + bk.shape[2:], bk.dtype)], axis=1
            )
            ck = np.concatenate([ck, np.zeros((ck.shape[0], pad), ck.dtype)], axis=1)
        outs_b.append(bk)
        outs_c.append(ck)
    return np.stack(outs_b), np.stack(outs_c)


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _cols_tensor(cols, n_blocks, device):
    """Block-column ids as an int32 tensor, checked on the host: the CUDA
    kernel reads x[cols*bs : +bs] unchecked."""
    cols = np.asarray(cols, np.int32)
    if cols.size and (cols.min() < 0 or cols.max() >= n_blocks):
        raise ValueError(f"block-column ids outside [0, {n_blocks})")
    return torch.as_tensor(cols, device=device)


def pack_bell(A_csc, block_size=128, dtype=torch.float32, device="cpu"):
    """Pack a scipy CSC matrix into a BellMatrix (A and A^T) on `device`.

    Uses the native C++ packer when available, else a numpy fallback.
    """
    m, n = A_csc.shape
    A_blocks, A_cols, At_blocks, At_cols, d, r = pack_bell_host(
        A_csc, block_size, _np_dtype(dtype)
    )

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BellMatrix(
        m=m,
        n=n,
        bs=block_size,
        A_blocks=t(A_blocks),
        A_cols=_cols_tensor(A_cols, At_blocks.shape[0], device),
        At_blocks=t(At_blocks),
        At_cols=_cols_tensor(At_cols, A_blocks.shape[0], device),
        col_sq=t(d),
        row_sq=t(r),
    )


def pack_bell_sym_host(P_csc, block_size=128, np_dtype=np.float32):
    """Host-side symmetric pack: numpy (blocks, cols, diag), no upload."""
    from scipy import sparse as sp  # noqa: PLC0415

    from .. import native  # noqa: PLC0415

    P_csc = sp.csc_matrix(P_csc)
    P_csc.sort_indices()
    if native.available:
        blocks, cols = native.pack_block_ell(P_csc, block_size)
    else:
        blocks, cols = _pack_bell_numpy(P_csc, block_size)
    blocks = np.ascontiguousarray(
        blocks.transpose(0, 1, 3, 2), dtype=np_dtype
    )
    return (
        blocks,
        np.asarray(cols, np.int32),
        np.asarray(P_csc.diagonal(), np_dtype),
    )


def pack_bell_sym(P_csc, block_size=128, dtype=torch.float32, device="cpu"):
    """Pack a symmetric sparse matrix (full P, not triu) into a one-sided
    block-ELL operator (solver.PBell): symmetry means a single pack serves
    P @ x in both orientations; diag(P) is extracted for the Jacobi
    preconditioner (solver._diagS)."""
    from ..solver import PBell  # noqa: PLC0415

    blocks, cols, diag = pack_bell_sym_host(P_csc, block_size, _np_dtype(dtype))
    return PBell(
        blocks=torch.as_tensor(blocks, dtype=dtype, device=device),
        cols=_cols_tensor(cols, blocks.shape[0], device),
        diag=torch.as_tensor(diag, dtype=dtype, device=device),
    )


def pack_bell_sharded(A_csc, n_dev, block_size=128, dtype=torch.float32):
    """Host block-ELL packs of (A, A^T) for a row-sharded operator
    (scs_tpu's `pack_bell_sharded`, the same numpy bits; nothing is placed
    on a device, see `place_bell_shard`).

    The m rows (a multiple of n_dev*block_size: callers pre-pad with
    zero-cone rows) are split contiguously into n_dev groups; rank d gets
    the pack of its row slice A_d and the pack of A_d^T, so that

        A @ x    = gather_d(A_d @ x)          (x replicated)
        A^T @ y  = sum_d(A_d^T @ y_d)         (y_d = rank d's rows of y)

    Every rank's widths are padded to the largest (zero tiles pointing at
    block 0) and the packs stacked along a leading n_dev axis.

    Returns numpy (A_blocks, A_cols, At_blocks, At_cols, colsq_all) of
    shapes (n_dev, nbr_loc, wA, bs, bs), (n_dev, nbr_loc, wA),
    (n_dev, nbc, wAt, bs, bs), (n_dev, nbc, wAt), (n,); colsq_all is the
    sum over the slices, in rank order, in the pack's dtype.
    """
    from scipy import sparse as sp  # noqa: PLC0415

    m, n = A_csc.shape
    if m % (n_dev * block_size) != 0:
        raise ValueError(
            f"sharded bell pack requires m ({m}) to be a multiple of "
            f"n_dev*block_size ({n_dev * block_size}); pad rows first"
        )
    m_loc = m // n_dev
    A_csc = sp.csc_matrix(A_csc)
    packs = [
        pack_bell_host(A_csc[d * m_loc : (d + 1) * m_loc], block_size, _np_dtype(dtype))
        for d in range(n_dev)
    ]
    A_blocks, A_cols = stack_bell_host([p[0] for p in packs], [p[1] for p in packs])
    At_blocks, At_cols = stack_bell_host([p[2] for p in packs], [p[3] for p in packs])
    colsq_all = np.sum(np.stack([p[4] for p in packs]), axis=0)
    return A_blocks, A_cols, At_blocks, At_cols, colsq_all


def pack_bell_sym_sharded(P_csc, n_dev, block_size=128, dtype=torch.float32):
    """Host block-ELL packs of the symmetric P for a row-sharded operator
    (scs_tpu's `pack_bell_sym_sharded`, the same numpy bits): rank d holds
    the pack of its contiguous row slice P_d of P, whose rows are padded
    with zeros to a multiple of n_dev*block_size, so that

        P @ x = gather_d(P_d @ x)[:n]        (x replicated)

    Returns a solver.PBell of numpy arrays: blocks (n_dev, nbr_loc, w, bs,
    bs), cols (n_dev, nbr_loc, w) and the (n,) diag.
    """
    from scipy import sparse as sp  # noqa: PLC0415

    from ..solver import PBell  # noqa: PLC0415

    P_csc = sp.csc_matrix(P_csc)
    n = P_csc.shape[0]
    pad = (-n) % (n_dev * block_size)
    if pad:
        P_csc = sp.vstack([P_csc.tocsr(), sp.csr_matrix((pad, n))]).tocsc()
    n_loc = (n + pad) // n_dev
    P_csr = P_csc.tocsr()
    packs = [
        pack_bell_host(P_csr[d * n_loc : (d + 1) * n_loc].tocsc(), block_size, _np_dtype(dtype))
        for d in range(n_dev)
    ]
    blocks, cols = stack_bell_host([p[0] for p in packs], [p[1] for p in packs])
    return PBell(
        blocks=blocks, cols=cols, diag=np.asarray(P_csc.diagonal()[:n], _np_dtype(dtype))
    )


def place_bell_shard(blocks, cols, rank, n_blocks, device):
    """Rank `rank`'s slice of a stacked sharded pack (numpy, leading n_dev
    axis, from pack_bell_sharded / pack_bell_sym_sharded) as tensors on
    `device`; the other ranks' slices are never uploaded. n_blocks bounds
    the block-column ids (the CUDA kernel reads x[cols*bs : +bs]
    unchecked)."""
    return torch.as_tensor(blocks[rank], device=device), _cols_tensor(
        cols[rank], n_blocks, device
    )


def _pack_bell_numpy(A_csc, bs):
    """Pure-numpy block-ELL packer (fallback when g++ is unavailable)."""
    m, n = A_csc.shape
    nbr, nbc = -(-m // bs), -(-n // bs)
    coo = A_csc.tocoo()
    bi, bj = coo.row // bs, coo.col // bs
    pair_ids = bi * nbc + bj
    uniq = np.unique(pair_ids)
    slots = {}
    counts = np.zeros(nbr, np.int64)
    for p in uniq:
        r = p // nbc
        slots[p] = counts[r]
        counts[r] += 1
    width = max(int(counts.max()) if nbr else 0, 1)
    blocks = np.zeros((nbr, width, bs, bs))
    cols = np.zeros((nbr, width), np.int64)
    for p in uniq:
        cols[p // nbc, slots[p]] = p % nbc
    slot_of = np.array([slots[p] for p in pair_ids])
    blocks[bi, slot_of, coo.row % bs, coo.col % bs] = coo.data
    return blocks, cols
