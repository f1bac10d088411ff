"""Dense matrix-vector products of the dense solver path, single or batched
— the counterpart of scs_tpu's `Core._mv`/`Core._tv` pair and of the two
launchers of tools/gemv_proto.py (`pallas_gemv`, `vpu_gemv`).

  * gemv_rows(M, v)   — M @ v:   y[..., i] = sum_j M[..., i, j] v[..., j]
  * gemv_cols(M, u)   — M.T @ u: y[..., j] = sum_i M[..., i, j] u[..., i],
                        a reduction down the columns of the stored M, so
                        A'y needs no stored transpose of A
  * gemv_rows_ref, gemv_cols_ref — the plain PyTorch versions, written as
                        scs_tpu's own multiply-and-reduce forms

M is (r, c) with a vector, or (B, r, c) with a (B, k) batch of vectors. On
a CUDA tensor a wrapper launches the hand-written kernel of csrc/gemv.cu
(built with nvcc at first use) on the current stream and counts the launch
in its `.launches`; anything the kernel does not take raises, and so does a
failed build or launch. On a CPU tensor it is the plain version.
"""

from __future__ import annotations

import torch

# gemv_cols on a small batch cuts the rows into ranges until the grid has
# about this many thread blocks (a few per SM of a 132-SM card); each range
# keeps at least _MIN_SPLIT_ROWS rows
_TARGET_BLOCKS = 528
_MIN_SPLIT_ROWS = 64
_MAX_SPLITS = 64


def gemv_rows_ref(M, v):
    """Plain M @ v by multiply and reduce along the last axis."""
    return (M * v[..., None, :]).sum(-1)


def gemv_cols_ref(M, u):
    """Plain M.T @ u by multiply and reduce down the columns."""
    return (M * u[..., :, None]).sum(-2)


def _prepare(who, M, vec, vec_axis):
    """Check what csrc/gemv.cu takes and return (M3, vec2, squeeze): the
    (B, r, c) matrix, the contiguous (B, k) vectors, and whether the caller
    passed a single (r, c) problem."""
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: M must be float32 or float64, got {M.dtype}")
    if vec.dtype != M.dtype:
        raise TypeError(f"{who}: vector dtype {vec.dtype} != M dtype {M.dtype}")
    if vec.device != M.device:
        raise ValueError(f"{who}: vector on {vec.device}, M on {M.device}")
    if M.dim() not in (2, 3) or vec.dim() != M.dim() - 1:
        raise ValueError(
            f"{who}: M must be (r, c) with a vector or (B, r, c) with (B, k) "
            f"vectors, got {tuple(M.shape)} and {tuple(vec.shape)}"
        )
    squeeze = M.dim() == 2
    if squeeze:
        M, vec = M[None], vec[None]
    if vec.shape[0] != M.shape[0] or vec.shape[1] != M.shape[vec_axis]:
        raise ValueError(
            f"{who}: vector shape {tuple(vec.shape)} does not match M "
            f"{tuple(M.shape)}"
        )
    if not M.is_contiguous():
        raise ValueError(f"{who}: M must be contiguous")
    return M, vec.contiguous(), squeeze


def _symbol(name, dtype):
    from . import _kernels  # noqa: PLC0415

    lib = _kernels.load("gemv")
    return getattr(lib, name + ("_f32" if dtype == torch.float32 else "_f64"))


def gemv_rows(M, v):
    """M @ v; shapes as the module docstring. On CUDA: the gemv_rows kernel."""
    dev = M.device
    if dev.type == "cpu":
        return gemv_rows_ref(M, v)
    if dev.type != "cuda":
        raise ValueError(f"gemv_rows: unsupported device {dev}")
    M3, v2, squeeze = _prepare("gemv_rows", M, v, 2)
    B, r, c = M3.shape
    fn = _symbol("gemv_rows", M3.dtype)
    y = torch.empty((B, r), dtype=M3.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(M3.data_ptr(), v2.data_ptr(), y.data_ptr(), B, r, c, stream)
    if rc != 0:
        raise RuntimeError(f"gemv_rows kernel launch failed: cudaError {rc}")
    gemv_rows.launches += 1
    return y[0] if squeeze else y


gemv_rows.launches = 0  # kernel launches since the last reset


def cols_splits(B, r, c, itemsize):
    """Row ranges gemv_cols cuts a (B, r, c) product into: 1 when the batch
    alone fills the card, more for a few tall matrices. A function of the
    shape and the element size only, so a product's summation order never
    changes from launch to launch."""
    vec = 16 // itemsize
    per_tile = 32 * (vec if c % vec == 0 else 1)
    blocks = max(B * -(-c // per_tile), 1)
    want = -(-_TARGET_BLOCKS // blocks)
    return max(1, min(want, r // _MIN_SPLIT_ROWS, _MAX_SPLITS))


def gemv_cols(M, u):
    """M.T @ u; shapes as the module docstring. On CUDA: the gemv_cols
    kernel (and, for a small batch, its fixed-order second pass)."""
    dev = M.device
    if dev.type == "cpu":
        return gemv_cols_ref(M, u)
    if dev.type != "cuda":
        raise ValueError(f"gemv_cols: unsupported device {dev}")
    M3, u2, squeeze = _prepare("gemv_cols", M, u, 1)
    B, r, c = M3.shape
    fn = _symbol("gemv_cols", M3.dtype)
    splits = cols_splits(B, r, c, M3.element_size())
    y = torch.empty((B, c), dtype=M3.dtype, device=dev)
    scratch = (
        torch.empty((B, splits, c), dtype=M3.dtype, device=dev) if splits > 1 else None
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            M3.data_ptr(), u2.data_ptr(), y.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, r, c, splits, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gemv_cols kernel launch failed: cudaError {rc}")
    gemv_cols.launches += 1
    return y[0] if squeeze else y


gemv_cols.launches = 0  # kernel launches since the last reset
